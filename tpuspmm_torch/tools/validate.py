"""External oracle and result checker.

Counterpart of ``tpuspmm/tools/validate.py`` (the reference's
utils/python_utils/validate.py): ``A @ B`` from the directory's inputs by
the port's f64 oracle (``ops/oracle.py``), ``result.expect`` written as
headerless rows of 10-decimal values (the reference's layout,
validate.py:22-29; the same bytes as the JAX tool's), and every ``*.out``
compared with it at the reference's tolerance.

Usage::

    python -m tpuspmm_torch.tools.validate DATA_DIR [--write-expect]
        [--width N] [--rel-tol 1e-2] [--abs-tol 1e-3]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def compute_expect(data_dir: str, width=None) -> np.ndarray:
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.ops import oracle

    a = convert.load_sparse(data_dir, "coo")
    b = np.asarray(convert.load_dense(data_dir, width=width).data,
                   dtype=np.float32)
    return oracle.spmm_scipy_oracle(a, b)


def write_expect(data_dir: str, expect: np.ndarray) -> str:
    path = os.path.join(data_dir, "result.expect")
    with open(path, "w") as f:
        for row in expect:
            f.write(" ".join(f"{v:.10f}" for v in row) + "\n")
    return path


def read_result(path: str) -> np.ndarray:
    """A headerless result matrix, one row a line."""
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                rows.append(np.array(toks, dtype=np.float64))
    return np.vstack(rows) if rows else np.zeros((0, 0))


def validate_dir(data_dir: str, width=None, rel_tol=1e-2, abs_tol=1e-3,
                 write=False) -> int:
    """Print PASS / FAIL for each ``*.out``; return the failures."""
    expect = compute_expect(data_dir, width=width)
    if write:
        print(write_expect(data_dir, expect))
    failures = 0
    outs = sorted(glob.glob(os.path.join(data_dir, "*.out")))
    for path in outs:
        got = read_result(path)
        if got.shape != expect.shape:
            print(f"FAIL {path}: shape {got.shape} != {expect.shape}")
            failures += 1
            continue
        ok = np.allclose(got, expect, rtol=rel_tol, atol=abs_tol)
        print(("PASS" if ok else "FAIL") + f" {path}")
        if not ok:
            diff = np.abs(got - expect)
            print(f"  max abs diff {diff.max():.6g} at "
                  f"{np.unravel_index(diff.argmax(), diff.shape)}")
            failures += 1
    if not outs:
        print(f"(no *.out files in {data_dir}; expect computed"
              + (" and written)" if write else ")"))
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_dir")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--write-expect", action="store_true")
    p.add_argument("--rel-tol", type=float, default=1e-2)
    p.add_argument("--abs-tol", type=float, default=1e-3)
    args = p.parse_args(argv)
    return 1 if validate_dir(args.data_dir, args.width, args.rel_tol,
                             args.abs_tol, args.write_expect) else 0


if __name__ == "__main__":
    sys.exit(main())
