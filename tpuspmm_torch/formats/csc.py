"""Compressed-sparse-column container (counterpart of
``tpuspmm.formats.CSC``): the reference corpus ships ``.csc`` files beside
``.csr``; compute goes through the triplets.  Layout as ``.csr``: header
"rows cols nnz", colptr line, row-index line, values line."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm_torch.formats.base import MatrixBase
from tpuspmm_torch.formats import io as fio


@dataclasses.dataclass(frozen=True)
class CSC(MatrixBase):
    indptr: np.ndarray   # (num_cols+1,) int32
    indices: np.ndarray  # (nnz,) int32, row ids
    values: np.ndarray   # (nnz,) float32
    shape: Tuple[int, int] = (0, 0)

    format_name = "csc"

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_file(cls, path: str) -> "CSC":
        rows, cols, nnz = fio._header(path, 3)
        body = fio._numeric_body(path, 1)
        return cls(indptr=body[: cols + 1].astype(np.int32),
                   indices=body[cols + 1: cols + 1 + nnz].astype(np.int32),
                   values=body[cols + 1 + nnz: cols + 1 + 2 * nnz].astype(
                       np.float32),
                   shape=(rows, cols))

    @classmethod
    def from_scipy(cls, m) -> "CSC":
        m = m.tocsc()
        return cls(indptr=m.indptr.astype(np.int32),
                   indices=m.indices.astype(np.int32),
                   values=m.data.astype(np.float32), shape=tuple(m.shape))

    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.csc_matrix(
            (self.values, self.indices, self.indptr), shape=self.shape)

    def to_csr(self):
        from tpuspmm_torch.formats.csr import CSR

        return CSR.from_scipy(self.to_scipy())

    def to_coo(self):
        from tpuspmm_torch.formats.coo import COO

        return COO.from_scipy(self.to_scipy())

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray().astype(np.float32)

    def save(self, path: str):
        fio.write_csr_text(path, self.shape, self.indptr, self.indices,
                           self.values)
