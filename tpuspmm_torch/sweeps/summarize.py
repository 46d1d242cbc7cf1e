"""Summarize sweep JSONL records into a markdown table.

The port's own copy of ``bench/summarize.py`` (standard library only).
Reads the newline-delimited JSON of ``sweep_formats``, ``sweep_sparsity``
or the CLI's ``--out``, groups by (testcase, format, B width, B dtype),
and reports the best kernel per group with correctness counts, the layer
the reference left to a plotting notebook.  A record's kernel time is its
``cudaKernelTimeMs`` (the port's records) or ``tpuKernelTimeMs`` (the
JAX package's), so on the JAX package's records the output is
``bench/summarize.py``'s.

Usage::

    python -m tpuspmm_torch.sweeps.summarize tpuspmm_torch/sweeps/h100/formats.jsonl [--csv]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load(paths):
    records = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{"):
                    records.append(json.loads(line))
    return records


def _kernel_ms(r) -> float:
    return r.get("cudaKernelTimeMs", r.get("tpuKernelTimeMs", 0))


def summarize(records):
    groups = defaultdict(list)
    # an --isolate parent's sweep_incomplete marker holds only (testcase,
    # format): it flags every group of that pair, whatever its operand
    incomplete_groups = set()
    for r in records:
        if r.get("sweep_incomplete") == "1":
            incomplete_groups.add((r.get("testcase", "?"),
                                   r.get("format", "?")))
            continue
        # the operand is part of the key: a width-1024 bf16 record must
        # not share a row with the width-256 f32 run of the same dir
        groups[(r.get("testcase", "?"), r.get("format", "?"),
                r.get("bCols", ""), r.get("bDtype", ""))].append(r)
    # a marker whose group shipped NO records at all still needs a row
    for tc, fmt in incomplete_groups:
        if not any(k[0] == tc and k[1] == fmt for k in groups):
            groups[(tc, fmt, "", "")] = []
    rows = []
    for (tc, fmt, bcols, bdt), recs in sorted(
            groups.items(), key=lambda kv: tuple(map(str, kv[0]))):
        # > 2 µs: the JAX package's timer floor, kept so that both give
        # the same table on its records
        timed = [r for r in recs
                 if r.get("correct") == "1"
                 and _kernel_ms(r) > 2e-3
                 and r.get("kernelType") not in ("0",)]
        # a verified-only variant's gate miss is served never, so it is
        # no failure; an error record is a third category (correctness
        # unknown)
        n_bad = sum(r.get("correct") == "0" and r.get("verifiedOnly") != "1"
                    for r in recs)
        n_vo_miss = sum(r.get("correct") == "0" and r.get("verifiedOnly") == "1"
                        for r in recs)
        n_err = sum(r.get("correct", "") == "" and bool(r.get("error"))
                    for r in recs)
        incomplete = (tc, fmt) in incomplete_groups
        best = min(timed, key=_kernel_ms) if timed else None
        vendor = next((r for r in timed if r.get("kernelType") == "-1"), None)
        rows.append({
            "testcase": tc,
            "format": fmt,
            "bCols": bcols,
            "bDtype": bdt,
            "records": len(recs),
            "incorrect": n_bad,
            "vo_miss": n_vo_miss,
            "errored": n_err,
            "incomplete": "yes" if incomplete else "",
            "best_kernel": best.get("kernelName") or best.get("kernelType") if best else "-",
            "best_ms": round(_kernel_ms(best), 3) if best else None,
            "gflops": round(best.get("gflops", 0), 2) if best else None,
            "vs_vendor": (round(_kernel_ms(vendor) / _kernel_ms(best), 2)
                          if best and vendor and _kernel_ms(best) > 2e-3
                          else None),
        })
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+")
    p.add_argument("--csv", action="store_true")
    args = p.parse_args(argv)
    rows = summarize(load(args.paths))
    if not rows:
        print("no records", file=sys.stderr)
        return 1
    cols = list(rows[0].keys())
    if args.csv:
        print(",".join(cols))
        for r in rows:
            print(",".join(str(r[c]) for c in cols))
    else:
        print("| " + " | ".join(cols) + " |")
        print("|" + "|".join("---" for _ in cols) + "|")
        for r in rows:
            print("| " + " | ".join(str(r[c]) for c in cols) + " |")
    total_bad = sum(r["incorrect"] for r in rows)
    total_vo = sum(r["vo_miss"] for r in rows)
    total_err = sum(r["errored"] for r in rows)
    total_inc = sum(1 for r in rows if r["incomplete"])
    print(f"\n{len(rows)} groups, {total_bad} incorrect records total"
          f" ({total_vo} verified-only gate misses, not served;"
          f" {total_err} errored — device fault, correctness unknown;"
          f" {total_inc} groups truncated by faults)",
          file=sys.stderr)
    return 0 if total_bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
