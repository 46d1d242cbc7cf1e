"""Synthetic sparsity-sweep directories.

Counterpart of ``tpuspmm/tools/gen_sparse.py`` (the reference's
utils/python_utils/gen_sparse.py), with the same bytes: for each density
``sp_<d>_<R>x<C>/`` holding ``sparse.csr``, ``sparse.coo`` and
``dense.in``, the directories the reference's sparsity sweep reads
(reference/test/sparsity.sh:3-21).  Defaults are the reference's: 2048 ×
2048 A at densities 0.1-0.9, values U(−100, 100), dense B 2048 × 1024.

Usage::

    python -m tpuspmm_torch.tools.gen_sparse OUT_ROOT [--rows 2048]
        [--cols 2048] [--width 1024] [--densities 0.1,0.2,...] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def gen_dir(out_root: str, density: float, rows: int, cols: int, width: int,
            seed: int = 0) -> str:
    import scipy.sparse

    from tpuspmm_torch.formats import COO, CSR
    from tpuspmm_torch.formats import io as fio

    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(
        rows, cols, density=density, format="coo", random_state=rng,
        data_rvs=lambda n: rng.uniform(-100.0, 100.0, n))
    d = os.path.join(out_root, f"sp_{density:g}_{rows}x{cols}")
    os.makedirs(d, exist_ok=True)
    CSR.from_scipy(sp).save(os.path.join(d, "sparse.csr"))
    COO.from_scipy(sp).sort_by_row().save(os.path.join(d, "sparse.coo"))
    b = rng.uniform(-100.0, 100.0, (cols, width)).astype(np.float32)
    fio.write_dense_text(os.path.join(d, "dense.in"), b)
    return d


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_root")
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=2048)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--densities",
                   default="0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8,0.9")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out_root, exist_ok=True)
    for ds in args.densities.split(","):
        print(gen_dir(args.out_root, float(ds), args.rows, args.cols,
                      args.width, args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
