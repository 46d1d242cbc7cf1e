"""Fit the panel cost-model constants from the card's ablation records.

Counterpart of ``bench/fit_panel_model.py``.  The geometry search
(``kernels/panel_spmm._geometry_search``, and the pair search beside it)
prices a candidate as

    µs = steps * step_us
       + strips * strip_bytes / (hbm_gbps * 1e3)   # plan stream
       + strips * strip_us                         # per strip
       + perm * m * n * 8 / (gather_gbps * 1e3)    # C un-permute gather

with the constants of ``kernels/dispatch.py``.  This tool turns the
records of ``python -m tpuspmm_torch.tools.ablate_panel`` into fitted
constants by non-negative least squares:

    python -m tpuspmm_torch.tools.ablate_panel --tm 8,16,32 --tk 128,256 \\
        --natural > tpuspmm_torch/tools/ablate_panel_h100.jsonl
    python -m tpuspmm_torch.tools.fit_panel_model \\
        tpuspmm_torch/tools/ablate_panel_h100.jsonl

Prints one JSON line with the fitted constants, their residual and the
record count.  Only gate-passing panel records at ``mode == "highest"``
are used (the split tier changes the products a strip runs, not the
traffic model; the pair records are for comparison).  A term none of the
records varies comes out None, as does one the fit sets to zero; a design
matrix whose varied terms are not independent is refused: a single
geometry per matrix cannot tell the constants apart.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

KEYS = ("strips", "steps", "strip_bytes", "ms", "m", "n")


def fit(records):
    """records -> (constants dict, residual_ms_rms, n_used).

    Raises ValueError when fewer than 4 records are usable or the design
    matrix is rank-deficient."""
    rows, y = [], []
    for r in records:
        if r.get("kernel", "panel") != "panel":
            continue
        if r.get("mode") != "highest" or not r.get("correct"):
            continue
        if not all(k in r for k in KEYS):
            continue
        perm = 1.0 if r.get("perm") else 0.0
        rows.append([
            float(r["steps"]),                          # * step_us
            float(r["strips"] * r["strip_bytes"]),      # * us_per_byte
            float(r["strips"]),                         # * strip_us
            perm * float(r["m"] * r["n"] * 8),          # * us_per_gather_byte
        ])
        y.append(float(r["ms"]) * 1e3)                  # µs
    if len(rows) < 4:
        raise ValueError(f"only {len(rows)} usable records — need >= 4")
    A = np.asarray(rows)
    used = A.any(axis=0)  # no permuted record: no gather column
    if np.linalg.matrix_rank(A[:, used]) < int(used.sum()):
        raise ValueError(
            "rank-deficient design matrix — run ablate_panel with a --tm "
            "and/or --strips sweep so geometries vary independently")
    from scipy.optimize import nnls

    coef = np.zeros(A.shape[1])
    coef[used], _ = nnls(A[:, used], np.asarray(y))
    resid = A @ coef - np.asarray(y)
    step_us, us_per_byte, strip_us, us_per_gb = coef
    out = {
        "panel_step_us": round(step_us, 4),
        "panel_hbm_gbps": (round(1.0 / (us_per_byte * 1e3), 1)
                           if us_per_byte > 0 else None),
        "panel_strip_us": round(strip_us, 5),
        "panel_gather_gbps": (round(1.0 / (us_per_gb * 1e3), 1)
                              if us_per_gb > 0 else None),
    }
    return out, float(np.sqrt(np.mean(resid ** 2)) / 1e3), len(rows)


def read_records(paths) -> list:
    """Every JSON object line of the given files."""
    records = []
    for path in paths:
        with open(path) as f:
            records += [json.loads(line) for line in f
                        if line.strip().startswith("{")]
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("jsonl", nargs="+",
                   help="ablate_panel output file(s) (JSONL); several "
                        "files of one card pool into one fit")
    args = p.parse_args(argv)
    try:
        constants, rms_ms, n = fit(read_records(args.jsonl))
    except ValueError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    print(json.dumps({"fitted": constants, "residual_rms_ms": round(rms_ms, 4),
                      "records_used": n,
                      "note": ("non-None values go into the card's row of "
                               "tpuspmm_torch/kernels/dispatch.py; None = "
                               "term not identifiable from these records")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
