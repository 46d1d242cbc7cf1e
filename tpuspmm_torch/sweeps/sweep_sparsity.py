"""Synthetic density sweep: the CSR and COO engines at densities 0.1-0.9.

Counterpart of ``bench/sweep_sparsity.py`` (the reference's
test/sparsity.sh:3-21, over the sp_<d>_2048x2048 dirs of gen_sparse.py).
The matrices are made in the process (``CSR.random``, the JAX package's
draws) at the reference's size: 2048 × 2048 A, B 2048 × 1024 uniform in
[lo, hi), seed 0.  Values are U(−1, 1) by default as in the JAX package:
at the reference's ±100 (``--lo -100 --hi 100``) f32 sums cannot meet
the abs-1e-3 gate on cancelling outputs.  Testcases are named
``sp_<d>_<R>x<C>``.

Exit status as ``sweep_formats``': 2 on a group with a device fault, 1 on
an incorrect record that is not verified-only or an error record, else 0.

Usage::

    python -m tpuspmm_torch.sweeps.sweep_sparsity [--rows 2048] [--cols 2048]
        [--width 1024] [--densities 0.1,...,0.9] [--formats csr,coo]
        [--b-dtype f32|bf16] [--out records.jsonl --fresh] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import sys

import numpy as np

from tpuspmm_torch.sweeps.common import Tally, group_faulted, resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=2048)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--densities",
                   default="0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8,0.9")
    p.add_argument("--formats", default="csr,coo")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--lo", type=float, default=-1.0,
                   help="value range (the reference's recipe is ±100)")
    p.add_argument("--hi", type=float, default=1.0)
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="dense-operand dtype (records carry bDtype)")
    p.add_argument("--skip-seq", action="store_true")
    p.add_argument("--no-vendor", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--fresh", action="store_true",
                   help="truncate --out instead of appending")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2

    import torch

    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.engine.runner import run_engine
    from tpuspmm_torch.formats import CSR, convert

    config = default_config()
    rng = np.random.default_rng(args.seed)
    b = torch.from_numpy(rng.uniform(args.lo, args.hi, (
        args.cols, args.width)).astype(np.float32))
    if args.b_dtype == "bf16":
        b = b.to(torch.bfloat16)
    tally = Tally()
    out_stream = (open(args.out, "w" if args.fresh else "a")
                  if args.out else sys.stdout)
    try:
        for ds in args.densities.split(","):
            density = float(ds)
            base = CSR.random(args.rows, args.cols, density, seed=args.seed,
                              lo=args.lo, hi=args.hi)
            testcase = f"sp_{density:g}_{args.rows}x{args.cols}"
            for fmt in args.formats.split(","):
                a = base if fmt == "csr" else convert.to_format(base, fmt)
                print(f"# {testcase} {fmt}: nnz={a.nnz}", file=sys.stderr)
                records = run_engine(
                    get_engine(fmt), a, b, testcase=testcase, config=config,
                    skip_seq=args.skip_seq, run_vendor=not args.no_vendor,
                    repeats=args.repeats, emit=False, device=device)
                if group_faulted(records):
                    tally.faulted_groups += 1
                for rec in records:
                    rec["bSource"] = "synth"
                    rec["widthArg"] = args.width
                    report.emit(rec, out_stream)
                    tally.add(rec)
                del a, records
            del base
            gc.collect()
    finally:
        if args.out:
            out_stream.close()
    print(f"# sparsity sweep done, {tally.failures} failed records, "
          f"{tally.faulted_groups} faulted groups", file=sys.stderr)
    return tally.status()


if __name__ == "__main__":
    sys.exit(main())
