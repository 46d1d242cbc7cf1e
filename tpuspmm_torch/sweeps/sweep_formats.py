"""Per-format sweep over the data corpus.

Counterpart of ``bench/sweep_formats.py`` (the reference's
test/{csr,coo,bsr}.sh: the binary over every data dir, records appended to
a .json file).  One process runs every requested format's engine on every
dir (``engine/runner.run_engine``: the oracle, each variant at the gate,
cuSPARSE) and writes one JSON record a line, with a summary on stderr.

Exit status, as in the JAX package: 2 when a group still carries a
``device_fault`` record after its retries, else 1 when a record failed (an
incorrect record that is not verified-only, or an error record), else 0.
A group is retried in process (``--retries``) only on a device fault, and
every record of a retried group carries ``"retried": n``.  A CUDA error
poisons the process's context, as a device fault poisoned the JAX client:
``--isolate`` runs each (dir, format) in a process of its own, re-runs a
faulted one in a fresh process, and marks a group that never completed
with a ``sweep_incomplete`` record.

Usage::

    python -m tpuspmm_torch.sweeps.sweep_formats --formats csr,coo,bsr,ell \\
        --out records.jsonl --fresh [--data-root data] [--dirs a,b]
        [--width 256] [--synth-b] [--b-dtype f32|bf16] [--repeats 5]
        [--skip-seq] [--no-vendor] [--retries 2] [--isolate] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import numpy as np

from tpuspmm_torch.sweeps.common import Tally, group_faulted, resolve_device

DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")


def _child_command(args, dirname: str, fmt: str, part: str) -> list:
    cmd = [sys.executable, "-m", "tpuspmm_torch.sweeps.sweep_formats",
           "--data-root", args.data_root, "--dirs", dirname, "--formats", fmt,
           "--repeats", str(args.repeats), "--retries", "0", "--device",
           args.device, "--b-dtype", args.b_dtype, "--out", part, "--fresh"]
    if args.width is not None:
        cmd += ["--width", str(args.width)]
    for flag in ("synth_b", "skip_seq", "no_vendor"):
        if getattr(args, flag):
            cmd.append("--" + flag.replace("_", "-"))
    return cmd


def _isolated_main(args, dirs) -> int:
    """One child process per (dir, format), each writing a part file
    afresh on every attempt (a crashed attempt's records never reach
    ``--out``); a child that exits other than 0 or 1 is re-run in a fresh
    process up to ``--retries`` times.  The parent never touches the
    device."""
    if args.out and args.fresh:
        open(args.out, "w").close()
    status = 0
    for dirname in dirs:
        for fmt in args.formats.split(","):
            part = f"{args.out}.{dirname}.{fmt}.part" if args.out else None
            for attempt in range(args.retries + 1):
                rc = subprocess.run(_child_command(
                    args, dirname, fmt, part or os.devnull)).returncode
                # rc 1 is a deterministic failure: a re-run replays it
                if rc in (0, 1) or attempt == args.retries:
                    break
                print(f"# {dirname} {fmt}: child rc={rc}, running the "
                      f"group again ({attempt + 1}/{args.retries})",
                      file=sys.stderr)
            if part and os.path.exists(part):
                with open(args.out, "a") as out_f, open(part) as part_f:
                    for line in part_f:
                        rec = json.loads(line)
                        if attempt:
                            rec["retried"] = attempt
                        out_f.write(json.dumps(rec) + "\n")
                    if rc not in (0, 1):
                        out_f.write(json.dumps(
                            {"testcase": dirname, "format": fmt,
                             "sweep_incomplete": "1", "child_rc": rc})
                            + "\n")
                os.remove(part)
            status = max(status, rc) if rc in (0, 1, 2) else 2
    return status


def _group_records(engine, a, b, dirname: str, fmt: str, config, args,
                   device) -> list:
    """The engine's records for one group, or one fault record when the
    group fails outside its variants (its operand's transfer, the
    oracle)."""
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.engine.runner import run_engine

    try:
        return run_engine(engine, a, b, testcase=dirname, config=config,
                          skip_seq=args.skip_seq,
                          run_vendor=not args.no_vendor,
                          repeats=args.repeats, emit=False, device=device)
    except Exception as e:  # the sweep outlives the group
        return [report.make_record(
            testcase=dirname, sparsity=a.sparsity, fmt=fmt, kernel_type="",
            nnz=a.nnz, shape=a.shape, n=int(b.shape[1]),
            extra={"error": f"{type(e).__name__}: {e}",
                   "device_fault": "1"})]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", default=DEFAULT_ROOT)
    p.add_argument("--dirs", default=None,
                   help="comma-separated dir names (default: all in root)")
    p.add_argument("--formats", default="csr,coo,bsr,ell")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--synth-b", action="store_true",
                   help="ignore on-disk dense operands; synthesise B of "
                        "--width")
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="dense-operand dtype (records carry bDtype); the "
                        "gate checks against the f64 oracle of the bf16 "
                        "values")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--skip-seq", action="store_true")
    p.add_argument("--no-vendor", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--fresh", action="store_true",
                   help="truncate --out instead of appending")
    p.add_argument("--retries", type=int, default=2,
                   help="re-runs of a (dir, format) group that ends with a "
                        "device fault")
    p.add_argument("--isolate", action="store_true",
                   help="run each (dir, format) in a process of its own")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)

    dirs = (args.dirs.split(",") if args.dirs
            else sorted(d for d in os.listdir(args.data_root)
                        if os.path.isdir(os.path.join(args.data_root, d))))
    if args.isolate:
        return _isolated_main(args, dirs)
    device = resolve_device(args.device)
    if device is None:
        return 2

    import torch

    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.formats import convert

    config = default_config()
    tally = Tally()
    out_stream = (open(args.out, "w" if args.fresh else "a")
                  if args.out else sys.stdout)
    try:
        for dirname in dirs:
            data_dir = os.path.join(args.data_root, dirname)
            try:
                dense = convert.load_dense(data_dir, width=args.width,
                                           force_synthetic=args.synth_b)
            except FileNotFoundError as e:
                print(f"# skip {dirname}: {e}", file=sys.stderr)
                continue
            b = torch.from_numpy(np.ascontiguousarray(dense.data,
                                                      dtype=np.float32))
            if args.b_dtype == "bf16":
                b = b.to(torch.bfloat16)
            for fmt in args.formats.split(","):
                try:
                    a = convert.load_sparse(data_dir, fmt)
                except FileNotFoundError:
                    continue
                print(f"# {dirname} {fmt}: A {a.shape} nnz={a.nnz} "
                      f"N={b.shape[1]}", file=sys.stderr)
                for attempt in range(args.retries + 1):
                    records = _group_records(get_engine(fmt), a, b, dirname,
                                             fmt, config, args, device)
                    if not group_faulted(records) or attempt == args.retries:
                        break
                    print(f"# {dirname} {fmt}: device fault, running the "
                          f"group again ({attempt + 1}/{args.retries})",
                          file=sys.stderr)
                if group_faulted(records):
                    tally.faulted_groups += 1
                for rec in records:
                    rec["bSource"] = getattr(dense, "b_source", "ondisk")
                    if args.width is not None:
                        rec["widthArg"] = args.width
                    if attempt:
                        rec["retried"] = attempt
                    report.emit(rec, out_stream)
                    tally.add(rec)
                del a, records
            # the dir's containers hold its device plans: free them before
            # the next dir
            del b, dense
            gc.collect()
    finally:
        if args.out:
            out_stream.close()
    print(f"# sweep done, {tally.failures} failed records, "
          f"{tally.faulted_groups} groups still faulted "
          f"({tally.verified_only_misses} verified-only variants reported "
          f"inadmissible by the gate)", file=sys.stderr)
    return tally.status()


if __name__ == "__main__":
    sys.exit(main())
