"""Format conversion and data-directory discovery (counterpart of
``tpuspmm/formats/convert.py``): the five formats, the reference's file
kinds, and direct ``.mtx`` loading."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from tpuspmm_torch.formats.bsr import BSR
from tpuspmm_torch.formats.coo import COO
from tpuspmm_torch.formats.csc import CSC
from tpuspmm_torch.formats.csr import CSR
from tpuspmm_torch.formats.dense import DenseMatrix
from tpuspmm_torch.formats.ell import ELL
from tpuspmm_torch.formats import io as fio

_FROM_SCIPY = {"csr": CSR.from_scipy, "csc": CSC.from_scipy,
               "coo": COO.from_scipy, "ell": ELL.from_scipy}


def to_format(matrix, fmt: str, block_size=(4, 4)):
    """Convert a container, scipy matrix or dense ndarray to `fmt` ("csr",
    "csc", "coo", "bsr" with ``block_size``, or "ell")."""
    import scipy.sparse

    if isinstance(matrix, (CSR, CSC, COO, BSR, ELL)):
        sp = matrix.to_scipy()
    elif scipy.sparse.issparse(matrix):
        sp = matrix
    else:
        sp = scipy.sparse.csr_matrix(np.asarray(matrix))
    fmt = fmt.lower()
    if fmt == "bsr":
        return BSR.from_scipy(sp, block_size=block_size)
    if fmt in _FROM_SCIPY:
        return _FROM_SCIPY[fmt](sp)
    raise ValueError(f"unknown format {fmt!r}")


def discover(data_dir: str) -> Dict[str, Optional[str]]:
    """Scan a data directory for the reference's file kinds."""
    found: Dict[str, Optional[str]] = {
        "csr": None, "csc": None, "coo": None, "bsr": None,
        "ell_rowind": None, "ell_values": None,
        "dense": None, "mtx": None, "dense_mtx": None,
    }
    for name in sorted(os.listdir(data_dir)):
        p = os.path.join(data_dir, name)
        if name.endswith("_rowind.ell"):
            found["ell_rowind"] = p
        elif name.endswith("_values_colmajor.ell"):
            found["ell_values"] = p
        elif name.endswith(".csr"):
            found["csr"] = p
        elif name.endswith(".csc"):
            found["csc"] = p
        elif name.endswith(".coo"):
            found["coo"] = p
        elif name.endswith(".bsr"):
            found["bsr"] = p
        elif name == "dense.in":
            found["dense"] = p
        elif name == "dense.mtx":
            found["dense_mtx"] = p
        elif name.endswith(".mtx"):
            found["mtx"] = p
    return found


def write_all_formats(a, data_dir: str, stem: str,
                      block_size: int = 4) -> list:
    """Write a container to `data_dir` as `.csr`, `.coo`, `.bsr` (square
    blocks of the largest side ≤ block_size dividing the shape) and the
    column-major ELL pair; returns the files written."""
    import scipy.sparse

    sp = scipy.sparse.coo_matrix(a.to_scipy())
    base = os.path.join(data_dir, stem)
    CSR.from_scipy(sp).save(base + ".csr")
    COO.from_scipy(sp).sort_by_row().save(base + ".coo")
    bs = block_size
    while bs > 1 and (sp.shape[0] % bs or sp.shape[1] % bs):
        bs -= 1
    BSR.from_scipy(sp, block_size=(bs, bs)).save(base + ".bsr")
    ELL.from_scipy(sp).save(base + "_rowind.ell",
                            base + "_values_colmajor.ell")
    return [base + ext for ext in (".csr", ".coo", ".bsr", "_rowind.ell",
                                   "_values_colmajor.ell")]


def load_sparse(data_dir: str, fmt: str, block_size=(4, 4)):
    """Load the sparse operand of `data_dir` in `fmt`, preferring the
    pre-converted text file, else converting the `.mtx` (BSR at
    ``block_size``)."""
    f = discover(data_dir)
    fmt = fmt.lower()
    if fmt == "csr" and f["csr"]:
        return CSR.from_file(f["csr"])
    if fmt == "csc" and f["csc"]:
        return CSC.from_file(f["csc"])
    if fmt == "coo" and f["coo"]:
        return COO.from_file(f["coo"])
    if fmt == "bsr" and f["bsr"]:
        return BSR.from_file(f["bsr"])
    if fmt == "ell" and f["ell_rowind"] and f["ell_values"]:
        return ELL.from_file(f["ell_rowind"], f["ell_values"])
    if f["mtx"]:
        return to_format(fio.read_mtx(f["mtx"]), fmt, block_size=block_size)
    raise FileNotFoundError(f"no {fmt} (or .mtx) input in {data_dir}")


def load_dense(data_dir: str, width: Optional[int] = None, seed: int = 0,
               force_synthetic: bool = False) -> DenseMatrix:
    """Load the dense operand: `dense.in`, then `dense.mtx`.  Without one
    (or with ``force_synthetic``) a seeded uniform(-1, 1) operand of
    ``width`` columns (default min(k, 512)) is synthesised, byte-identical
    to ``tpuspmm.formats.convert.load_dense``'s.  ``b_source`` on the
    result says which ("ondisk" or "synth")."""
    f = discover(data_dir)
    if force_synthetic:
        f = dict(f, dense=None, dense_mtx=None)

    def _tagged(d: DenseMatrix, source: str) -> DenseMatrix:
        object.__setattr__(d, "b_source", source)
        return d

    if f["dense"]:
        return _tagged(DenseMatrix.from_file(f["dense"]), "ondisk")
    if f["dense_mtx"]:
        import scipy.sparse

        m = fio.read_mtx(f["dense_mtx"])
        arr = m.toarray() if scipy.sparse.issparse(m) else np.asarray(m)
        return _tagged(DenseMatrix.from_array(arr), "ondisk")
    if f["mtx"] or f["csr"] or f["coo"]:
        a = (load_sparse(data_dir, "coo") if f["coo"] or f["mtx"]
             else load_sparse(data_dir, "csr"))
        k = a.shape[1]
        n = width or min(k, 512)
        rng = np.random.default_rng(seed)
        return _tagged(DenseMatrix.from_array(
            rng.uniform(-1.0, 1.0, (k, n)).astype(np.float32)), "synth")
    raise FileNotFoundError(f"no dense operand in {data_dir}")
