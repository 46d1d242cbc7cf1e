"""Compressed Sparse Row container (counterpart of ``tpuspmm.formats.CSR``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm_torch.formats.base import MatrixBase
from tpuspmm_torch.formats import io as fio


@dataclasses.dataclass(frozen=True)
class CSR(MatrixBase):
    indptr: np.ndarray   # (rows+1,) int32
    indices: np.ndarray  # (nnz,)   int32
    values: np.ndarray   # (nnz,)   float32
    shape: Tuple[int, int] = (0, 0)

    format_name = "csr"

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_file(cls, path: str) -> "CSR":
        """Load the reference `.csr` text format."""
        shape, indptr, indices, values = fio.read_csr_text(path)
        return cls(indptr=indptr, indices=indices, values=values, shape=shape)

    @classmethod
    def from_scipy(cls, m) -> "CSR":
        m = m.tocsr()
        return cls(
            indptr=m.indptr.astype(np.int32),
            indices=m.indices.astype(np.int32),
            values=m.data.astype(np.float32),
            shape=tuple(m.shape),
        )

    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.csr_matrix(
            (self.values, self.indices, self.indptr), shape=self.shape)

    def to_coo(self):
        from tpuspmm_torch.formats.coo import COO

        return COO.from_scipy(self.to_scipy().tocoo())

    def save(self, path: str):
        fio.write_csr_text(path, self.shape, self.indptr, self.indices,
                           self.values)
