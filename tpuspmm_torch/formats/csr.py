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

    @classmethod
    def random(cls, rows: int, cols: int, density: float, seed: int = 0,
               lo: float = -100.0, hi: float = 100.0) -> "CSR":
        """A seeded random matrix, equal to ``tpuspmm.formats.CSR.random``'s:
        ``scipy.sparse.random`` with values uniform in [lo, hi) (the
        reference generator's ±100 by default, gen_sparse.py:63-84).  At
        that scale and a high density f32 sums cannot meet the abs-1e-3
        gate on cancelling outputs: a verification sweep passes ±1."""
        import scipy.sparse

        rng = np.random.default_rng(seed)
        return cls.from_scipy(scipy.sparse.random(
            rows, cols, density=density, format="csr", random_state=rng,
            data_rvs=lambda n: rng.uniform(lo, hi, n)))

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
