"""Format conversion and data-directory discovery for CSR and COO
(counterpart of ``tpuspmm/formats/convert.py``; the other formats are a
later slice of the port)."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from tpuspmm_torch.formats.csr import CSR
from tpuspmm_torch.formats.coo import COO
from tpuspmm_torch.formats.dense import DenseMatrix
from tpuspmm_torch.formats import io as fio


def to_format(matrix, fmt: str):
    """Convert a container, scipy matrix or dense ndarray to `fmt`
    ("csr" or "coo")."""
    import scipy.sparse

    if isinstance(matrix, (CSR, COO)):
        sp = matrix.to_scipy()
    elif scipy.sparse.issparse(matrix):
        sp = matrix
    else:
        sp = scipy.sparse.csr_matrix(np.asarray(matrix))
    fmt = fmt.lower()
    if fmt == "csr":
        return CSR.from_scipy(sp)
    if fmt == "coo":
        return COO.from_scipy(sp)
    raise ValueError(f"unknown or not yet ported format {fmt!r}")


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


def load_sparse(data_dir: str, fmt: str):
    """Load the sparse operand of `data_dir` as "csr" or "coo", preferring
    the pre-converted text file, else converting the `.mtx`."""
    f = discover(data_dir)
    fmt = fmt.lower()
    if fmt == "csr" and f["csr"]:
        return CSR.from_file(f["csr"])
    if fmt == "coo" and f["coo"]:
        return COO.from_file(f["coo"])
    if f["mtx"]:
        return to_format(fio.read_mtx(f["mtx"]), fmt)
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
