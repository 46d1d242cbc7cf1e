"""Readers and writers for the reference's text formats and MatrixMarket.

- ``.csr``     — header "rows cols nnz"; indptr line; colidx line; values line
- ``.coo``     — header "rows cols nnz"; nnz lines "row col value"
- ``.bsr``     — header "rows cols nnz brows bcols nblocks"; indptr line;
  block-column line; nblocks lines of brows·bcols row-major block values
- ELL pair     — ``*_rowind.ell``: header "rows cols nnz maxColNnz", then
  one line of maxColNnz row indices (-1 padding) per column; headerless
  ``*_values_colmajor.ell``, one line of values per column.  The row-major
  pair (``*_colind.ell`` + ``*_values.ell``) is written only.
- ``dense.in`` — header "rows cols [ignored]"; rows lines of cols values
- ``.mtx``     — MatrixMarket

Counterpart of ``tpuspmm/formats/io.py``.  The token stream and a
coordinate ``.mtx`` are parsed by the port's host library
(``native/fastio``) where it builds, else by numpy and scipy, with the
same values bit for bit.  The writers produce the JAX package's bytes.
"""

from __future__ import annotations

import numpy as np


def _numeric_body(path: str, skip_lines: int) -> np.ndarray:
    from tpuspmm_torch.native import NativeUnavailable, fastio

    try:
        return fastio.parse_tokens(path, skip_lines)
    except NativeUnavailable:
        pass
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


def read_bsr_text(path: str):
    rows, cols, nnz, brows, bcols, nblocks = _header(path, 6)
    body = _numeric_body(path, 1)
    nbr = rows // brows
    indptr = body[: nbr + 1].astype(np.int32)
    indices = body[nbr + 1: nbr + 1 + nblocks].astype(np.int32)
    start = nbr + 1 + nblocks
    blocks = (body[start: start + nblocks * brows * bcols]
              .astype(np.float32).reshape(nblocks, brows, bcols))
    return (rows, cols), nnz, (brows, bcols), indptr, indices, blocks


def read_ell_text(rowind_path: str, values_path: str):
    """The column-major ELL pair."""
    rows, cols, nnz, max_col_nnz = _header(rowind_path, 4)
    size = cols * max_col_nnz
    rowind = (_numeric_body(rowind_path, 1)[:size].astype(np.int32)
              .reshape(cols, max_col_nnz))
    values = (_numeric_body(values_path, 0)[:size].astype(np.float32)
              .reshape(cols, max_col_nnz))
    return (rows, cols), nnz, max_col_nnz, rowind, values


def read_dense_text(path: str) -> np.ndarray:
    rows, cols = _header(path, 2)
    body = _numeric_body(path, 1)
    return body[: rows * cols].astype(np.float32).reshape(rows, cols)


def read_mtx(path: str):
    """MatrixMarket reader: scipy sparse COO for coordinate files (pattern
    entries read as 1.0, symmetric files expanded, indices 0-based), a
    dense ndarray for array files.  Real and pattern coordinate files go
    through the host library; the rest, and every file where it does not
    build, through ``scipy.io.mmread``."""
    import scipy.io
    import scipy.sparse

    from tpuspmm_torch.native import NativeUnavailable, fastio

    try:
        shape, r, c, v = fastio.read_mtx_triplets(path)
    except NativeUnavailable:
        return scipy.io.mmread(path)
    return scipy.sparse.coo_matrix((v, (r, c)), shape=shape)


def _write_int_line(f, arr) -> None:
    f.write(" ".join(map(str, np.asarray(arr).tolist())) + "\n")


def write_csr_text(path: str, shape, indptr, indices, values):
    with open(path, "w") as f:
        f.write(f"{shape[0]} {shape[1]} {len(values)}\n")
        _write_int_line(f, indptr)
        _write_int_line(f, indices)
        np.savetxt(f, np.asarray(values)[None, :], fmt="%.9g")


def write_coo_text(path: str, shape, rows, cols, values):
    """Row-major sorted triplets."""
    order = np.lexsort((cols, rows))
    with open(path, "w") as f:
        f.write(f"{shape[0]} {shape[1]} {len(values)}\n")
        np.savetxt(f, np.column_stack([np.asarray(rows)[order],
                                       np.asarray(cols)[order],
                                       np.asarray(values)[order]]),
                   fmt=["%d", "%d", "%.9g"])


def write_bsr_text(path: str, shape, nnz, block_size, indptr, indices,
                   blocks):
    brows, bcols = block_size
    with open(path, "w") as f:
        f.write(f"{shape[0]} {shape[1]} {nnz} {brows} {bcols} "
                f"{len(indices)}\n")
        _write_int_line(f, indptr)
        _write_int_line(f, indices)
        flat = (np.asarray(blocks).reshape(len(indices), -1) if len(indices)
                else np.zeros((0, 1)))
        np.savetxt(f, flat, fmt="%.9g")


def _write_ell_pair(index_path, values_path, header, index, values):
    with open(index_path, "w") as f:
        f.write(" ".join(map(str, header)) + "\n")
        for line in np.asarray(index):
            _write_int_line(f, line)
    with open(values_path, "w") as f:
        np.savetxt(f, np.asarray(values), fmt="%.9g")


def write_ell_text(rowind_path: str, values_path: str, shape, nnz,
                   max_col_nnz, rowind, values):
    """The column-major ELL pair."""
    _write_ell_pair(rowind_path, values_path,
                    (shape[0], shape[1], nnz, max_col_nnz), rowind, values)


def write_ell_rowmajor_text(colind_path: str, values_path: str, shape, nnz,
                            max_row_nnz, colind, values):
    """The row-major ELL pair ``*_colind.ell`` + ``*_values.ell``."""
    _write_ell_pair(colind_path, values_path,
                    (shape[0], shape[1], nnz, max_row_nnz), colind, values)


def write_dense_text(path: str, dense: np.ndarray):
    """``dense.in``; the third header token is the count of non-zeros,
    which the reader ignores."""
    dense = np.asarray(dense)
    with open(path, "w") as f:
        f.write(f"{dense.shape[0]} {dense.shape[1]} "
                f"{int(np.count_nonzero(dense))}\n")
        np.savetxt(f, dense, fmt="%.9g")
