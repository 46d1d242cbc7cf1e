"""Convert the MatrixMarket inputs of a data directory to the text formats.

Counterpart of ``tpuspmm/tools/convert_mtx.py`` (the reference's
utils/python_utils/convert_mtx.py), with the same bytes: ``dense.mtx`` →
``dense.in``; every other ``.mtx`` → ``.csr``, row-sorted ``.coo``, both
ELL pairs (row-major ``_colind.ell`` + ``_values.ell``, and the
column-major ``_rowind.ell`` + ``_values_colmajor.ell`` the engines read)
and ``.bsr`` at the largest square block up to ``--block-size`` that
divides the shape.

Usage::

    python -m tpuspmm_torch.tools.convert_mtx DATA_DIR [--block-size 4]
        [--formats csr,coo,bsr,ell,dense]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def convert_dir(data_dir: str, block_size: int = 4, formats=None) -> list:
    """Convert every .mtx in ``data_dir``; returns the files written."""
    import scipy.sparse

    from tpuspmm_torch.formats import BSR, COO, CSR, ELL
    from tpuspmm_torch.formats import io as fio

    formats = set(formats or ("csr", "coo", "bsr", "ell", "dense"))
    written = []
    for name in sorted(os.listdir(data_dir)):
        if not name.endswith(".mtx"):
            continue
        stem = os.path.splitext(name)[0]
        m = fio.read_mtx(os.path.join(data_dir, name))
        if stem == "dense":
            if "dense" in formats:
                arr = (m.toarray() if scipy.sparse.issparse(m)
                       else np.asarray(m))
                out = os.path.join(data_dir, "dense.in")
                fio.write_dense_text(out, arr.astype(np.float32))
                written.append(out)
            continue

        sp = scipy.sparse.coo_matrix(m)
        base = os.path.join(data_dir, stem)
        if "csr" in formats:
            CSR.from_scipy(sp).save(base + ".csr")
            written.append(base + ".csr")
        if "coo" in formats:
            COO.from_scipy(sp).sort_by_row().save(base + ".coo")
            written.append(base + ".coo")
        if "ell" in formats:
            ELL.from_scipy(sp).save(base + "_rowind.ell",
                                    base + "_values_colmajor.ell")
            written += [base + "_rowind.ell", base + "_values_colmajor.ell"]
            csr = sp.tocsr()  # the row-major pair (convert_mtx.py:195-239)
            row_nnz = np.diff(csr.indptr)
            mrn = int(row_nnz.max()) if csr.shape[0] else 0
            colind = np.full((csr.shape[0], mrn), -1, dtype=np.int32)
            vals = np.zeros((csr.shape[0], mrn), dtype=np.float32)
            slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_nnz)
            row = np.repeat(np.arange(csr.shape[0]), row_nnz)
            colind[row, slot] = csr.indices
            vals[row, slot] = csr.data
            fio.write_ell_rowmajor_text(
                base + "_colind.ell", base + "_values.ell", sp.shape, sp.nnz,
                mrn, colind, vals)
            written += [base + "_colind.ell", base + "_values.ell"]
        if "bsr" in formats:
            bs = block_size
            while bs > 1 and (sp.shape[0] % bs or sp.shape[1] % bs):
                bs -= 1
            BSR.from_scipy(sp, block_size=(bs, bs)).save(base + ".bsr")
            written.append(base + ".bsr")
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_dir")
    p.add_argument("--block-size", type=int, default=4)
    p.add_argument("--formats", default="csr,coo,bsr,ell,dense")
    args = p.parse_args(argv)
    if not os.path.isdir(args.data_dir):
        print(f"{args.data_dir!r} is not a directory", file=sys.stderr)
        return 2
    for w in convert_dir(args.data_dir, args.block_size,
                         args.formats.split(",")):
        print(w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
