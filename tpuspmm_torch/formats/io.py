"""Readers for the reference's text formats and MatrixMarket.

- ``.csr``     — header "rows cols nnz"; indptr line; colidx line; values line
- ``.coo``     — header "rows cols nnz"; nnz lines "row col value"
- ``dense.in`` — header "rows cols [ignored]"; rows lines of cols values
- ``.mtx``     — MatrixMarket, through scipy

Counterpart of ``tpuspmm/formats/io.py`` without its native fast path: the
token stream is parsed by numpy.
"""

from __future__ import annotations

import numpy as np


def _numeric_body(path: str, skip_lines: int) -> np.ndarray:
    with open(path, "r") as f:
        for _ in range(skip_lines):
            f.readline()
        rest = f.read()
    # token-stream parse: the text formats have ragged line lengths
    return np.array(rest.split(), dtype=np.float64)


def _header(path: str, n: int):
    with open(path) as f:
        return tuple(int(t) for t in f.readline().split()[:n])


def read_csr_text(path: str):
    rows, cols, nnz = _header(path, 3)
    body = _numeric_body(path, 1)
    indptr = body[: rows + 1].astype(np.int32)
    indices = body[rows + 1: rows + 1 + nnz].astype(np.int32)
    values = body[rows + 1 + nnz: rows + 1 + 2 * nnz].astype(np.float32)
    return (rows, cols), indptr, indices, values


def read_coo_text(path: str):
    rows, cols, nnz = _header(path, 3)
    body = _numeric_body(path, 1).reshape(nnz, 3)
    r = body[:, 0].astype(np.int32)
    c = body[:, 1].astype(np.int32)
    v = body[:, 2].astype(np.float32)
    return (rows, cols), r, c, v


def read_dense_text(path: str) -> np.ndarray:
    rows, cols = _header(path, 2)
    body = _numeric_body(path, 1)
    return body[: rows * cols].astype(np.float32).reshape(rows, cols)


def read_mtx(path: str):
    """MatrixMarket reader: scipy sparse COO for coordinate files (pattern
    entries read as 1.0, symmetric files expanded, indices 0-based), a
    dense ndarray for array files."""
    import scipy.io

    return scipy.io.mmread(path)
