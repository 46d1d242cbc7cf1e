"""Reference (oracle) SpMM — numpy, float64 accumulation, float32 result.

Counterpart of ``tpuspmm/ops/oracle.py`` for CSR and COO: the semantics
every kernel of the port is verified against (kernel number 0).
"""

from __future__ import annotations

import numpy as np

from tpuspmm_torch.formats import CSR, COO


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


def spmm_oracle(a, b: np.ndarray) -> np.ndarray:
    """Dispatch on container type."""
    if isinstance(a, CSR):
        return spmm_csr_oracle(a, b)
    if isinstance(a, COO):
        return spmm_coo_oracle(a, b)
    raise TypeError(f"unsupported container {type(a)}")


def spmm_scipy_oracle(a, b: np.ndarray) -> np.ndarray:
    """Independent scipy oracle (the reference validator's computation)."""
    return (a.to_scipy().astype(np.float64)
            @ np.asarray(b, dtype=np.float64)).astype(np.float32)
