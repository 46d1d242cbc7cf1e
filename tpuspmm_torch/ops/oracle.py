"""Reference (oracle) SpMM — numpy, float64 accumulation, float32 result.

Counterpart of ``tpuspmm/ops/oracle.py``: the semantics every kernel of
the port is verified against (kernel number 0), per format: the CSR row
loop, the COO triplet accumulation, the BSR block expansion and the ELL
column-slot scatter.
"""

from __future__ import annotations

import numpy as np

from tpuspmm_torch.formats import BSR, COO, CSR, ELL


def spmm_csr_oracle(a: CSR, b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, dtype=np.float64)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.float64)
    values = np.asarray(a.values, dtype=np.float64)
    for r in range(a.shape[0]):
        s, e = a.indptr[r], a.indptr[r + 1]
        if e > s:
            out[r] = values[s:e] @ b[a.indices[s:e]]
    return out.astype(np.float32)


def _accumulate_triplets_f64(rows, cols, vals, num_rows: int,
                             b: np.ndarray) -> np.ndarray:
    """Row-sorted f64 triplet accumulation (duplicates accumulate), in
    slabs that cap the (nnz, n) product intermediate at ~64 MB."""
    out = np.zeros((num_rows, b.shape[1]), dtype=np.float64)
    if len(rows) == 0:
        return out
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    step = max(1, (64 << 20) // max(int(b.shape[1]) * 8, 1))
    for s in range(0, len(rows), step):
        r = rows[s:s + step]
        contrib = vals[s:s + step, None] * b[cols[s:s + step]]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(r)) + 1])
        sums = np.add.reduceat(contrib, starts, axis=0)
        # a row can span a slab boundary — add, don't assign
        np.add.at(out, r[starts], sums)
    return out


def spmm_coo_oracle(a: COO, b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, dtype=np.float64)
    out = _accumulate_triplets_f64(
        a.rows, a.cols, np.asarray(a.values, dtype=np.float64), a.shape[0], b)
    return out.astype(np.float32)


def spmm_bsr_oracle(a: BSR, b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, dtype=np.float64)
    bh, bw = a.block_size
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.float64)
    blocks = np.asarray(a.blocks, dtype=np.float64)
    for br in range(a.num_block_rows):
        for bi in range(a.indptr[br], a.indptr[br + 1]):
            bc = a.indices[bi]
            out[br * bh:(br + 1) * bh] += blocks[bi] @ b[bc * bw:
                                                         (bc + 1) * bw]
    return out.astype(np.float32)


def spmm_ell_oracle(a: ELL, b: np.ndarray) -> np.ndarray:
    """The slots as triplets (padding dropped), accumulated in f64."""
    b = np.asarray(b, dtype=np.float64)
    if a.rowind.size == 0:
        return np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    ncols, mcn = a.rowind.shape
    cols = np.repeat(np.arange(ncols), mcn)
    rows = a.rowind.reshape(-1)
    vals = np.asarray(a.values, dtype=np.float64).reshape(-1)
    keep = rows >= 0
    return _accumulate_triplets_f64(rows[keep], cols[keep], vals[keep],
                                    a.shape[0], b).astype(np.float32)


_ORACLES = {"csr": spmm_csr_oracle, "coo": spmm_coo_oracle,
            "bsr": spmm_bsr_oracle, "ell": spmm_ell_oracle}


def spmm_oracle(a, b: np.ndarray) -> np.ndarray:
    """Dispatch on the container's format; any other container with a CSR
    view (CSC) goes through it."""
    fn = _ORACLES.get(getattr(a, "format_name", None))
    if fn is not None:
        return fn(a, b)
    if hasattr(a, "to_csr"):
        return spmm_csr_oracle(a.to_csr(), b)
    raise TypeError(f"unsupported container {type(a)}")


def spmm_scipy_oracle(a, b: np.ndarray) -> np.ndarray:
    """Independent scipy oracle (the reference validator's computation)."""
    return (a.to_scipy().astype(np.float64)
            @ np.asarray(b, dtype=np.float64)).astype(np.float32)
