"""Build and check the repository's data corpus.

Counterpart of ``tpuspmm/tools/make_data.py``.  The reference ships 12
SuiteSparse-derived data directories; medium_4096's operand is a missing
blob there (reference/.MISSING_LARGE_BLOBS).  This tool

1. writes medium_4096's deterministic stand-in where it is missing
   (4096 × 4096, 12,264 nonzeros, seed 4096: the same files and
   ``GENERATED.json`` as the JAX tool, byte for byte);
2. writes ``result.expect`` goldens (the f64 oracle, ``%.10f``) for the
   small directories that have none;
3. checks the tree: every stored format of every directory loads, agrees
   with the oracle at rel 1e-2 / abs 1e-3 and with its golden, and has
   the recorded shape and nonzeros.

Usage::

    python -m tpuspmm_torch.tools.make_data [--data-root data] [--verify-only]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# (rows, cols, nnz) of each directory's sparse operand
EXPECTED = {
    "small_10x10": (10, 10, 90),
    "small_32x32": (32, 32, 98),
    "small_210": (120, 210, 840),
    "medium_1484": (1484, 1484, 6110),
    "medium_2048": (2048, 2048, 10114),
    "medium_2880": (2880, 2880, 19635),
    "medium_4000": (4000, 4000, 8784),
    "medium_4096": (4096, 4096, 12264),
    "large_15120": (5040, 15120, 30240),
    "large_20000": (20000, 20000, 137736),
    "large_21074": (2798, 21074, 81671),
    "large_25605": (6300, 25605, 88200),
}

# goldens only where the whole dense operand keeps the text file small
GOLDEN_DIRS = ("small_10x10", "small_32x32", "small_210")
DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")


def regen_medium_4096(root: str) -> None:
    """medium_4096's stand-in in all four text formats, unless present."""
    from tpuspmm_torch.formats import CSR, convert

    d = os.path.join(root, "medium_4096")
    os.makedirs(d, exist_ok=True)
    if os.path.exists(os.path.join(d, "gen_HFE18_96_in_rowind.ell")):
        return
    rows, cols, nnz = EXPECTED["medium_4096"]
    a = CSR.random(rows, cols, nnz / (rows * cols), seed=4096, lo=-1.0,
                   hi=1.0)
    written = convert.write_all_formats(a, d, stem="gen_HFE18_96_in")
    with open(os.path.join(d, "GENERATED.json"), "w") as f:
        json.dump({"files": sorted(os.path.basename(p) for p in written),
                   "seed": 4096, "shape": [rows, cols], "nnz": int(a.nnz),
                   "note": "deterministic stand-in for the reference's "
                           "missing HFE18_96_in.mtx blob"}, f, indent=1)
    print(f"# generated medium_4096 stand-in ({rows}x{cols}, nnz={a.nnz}): "
          f"{len(written)} files")


def write_goldens(root: str) -> None:
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.ops import oracle

    for name in GOLDEN_DIRS:
        d = os.path.join(root, name)
        path = os.path.join(d, "result.expect")
        if not os.path.isdir(d) or os.path.exists(path):
            continue
        a = convert.load_sparse(d, "csr")
        b = np.asarray(convert.load_dense(d).data, dtype=np.float32)
        np.savetxt(path, oracle.spmm_scipy_oracle(a, b), fmt="%.10f")
        print(f"# wrote {path}")


def verify(root: str) -> int:
    """Print one status line a directory; return the failures."""
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.utils.compare import allclose

    failures = 0
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        try:
            a = convert.load_sparse(d, "csr")
        except FileNotFoundError:
            print(f"{name}: SKIP (no sparse input)")
            continue
        exp = EXPECTED.get(name)
        dims_ok = exp is None or (a.shape == exp[:2] and a.nnz == exp[2])
        # outside the golden dirs a synthetic 64-wide B: the on-disk dense
        # operands run to K x K (large_20000: 20000^2)
        width = None if name in GOLDEN_DIRS else 64
        b = np.asarray(convert.load_dense(
            d, width=width, force_synthetic=width is not None).data,
            dtype=np.float32)
        ref = oracle.spmm_scipy_oracle(a, b)
        fmt_ok = True
        for fmt in ("coo", "bsr", "ell"):
            try:
                af = convert.load_sparse(d, fmt)
            except FileNotFoundError:
                continue
            if not allclose(oracle.spmm_oracle(af, b), ref, 1e-2, 1e-3):
                fmt_ok = False
                failures += 1
                print(f"{name}: FORMAT MISMATCH ({fmt})")
        golden_ok = True
        gpath = os.path.join(d, "result.expect")
        if os.path.exists(gpath) and width is None:
            golden = np.loadtxt(gpath, dtype=np.float64).reshape(ref.shape)
            golden_ok = allclose(ref.astype(np.float32),
                                 golden.astype(np.float32), 1e-2, 1e-3)
            if not golden_ok:
                failures += 1
        if not dims_ok:
            failures += 1
        status = "ok" if (dims_ok and fmt_ok and golden_ok) else "FAIL"
        print(f"{name}: {status} shape={a.shape} nnz={a.nnz}"
              + ("" if dims_ok else f" (expected {exp})")
              + ("" if golden_ok else " GOLDEN MISMATCH"))
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", default=DEFAULT_ROOT)
    p.add_argument("--verify-only", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.data_root, exist_ok=True)
    if not args.verify_only:
        regen_medium_4096(args.data_root)
        write_goldens(args.data_root)
    failures = verify(args.data_root)
    print(f"# {'OK' if failures == 0 else 'FAILURES'} ({failures})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
