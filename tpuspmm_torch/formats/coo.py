"""Coordinate-format container (counterpart of ``tpuspmm.formats.COO``).

Duplicate coordinates accumulate, as in the reference's COO kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm_torch.formats.base import MatrixBase
from tpuspmm_torch.formats import io as fio


@dataclasses.dataclass(frozen=True)
class COO(MatrixBase):
    rows: np.ndarray    # (nnz,) int32
    cols: np.ndarray    # (nnz,) int32
    values: np.ndarray  # (nnz,) float32
    shape: Tuple[int, int] = (0, 0)
    row_sorted: bool = False

    format_name = "coo"

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_file(cls, path: str) -> "COO":
        """Load the reference `.coo` text format."""
        shape, r, c, v = fio.read_coo_text(path)
        return cls(rows=r, cols=c, values=v, shape=shape,
                   row_sorted=bool(np.all(np.diff(r) >= 0)))

    @classmethod
    def from_scipy(cls, m) -> "COO":
        m = m.tocoo()
        return cls(
            rows=m.row.astype(np.int32),
            cols=m.col.astype(np.int32),
            values=m.data.astype(np.float32),
            shape=tuple(m.shape),
            row_sorted=bool(np.all(np.diff(m.row) >= 0)),
        )

    @classmethod
    def random(cls, rows: int, cols: int, density: float,
               seed: int = 0) -> "COO":
        """``CSR.random``'s matrix as COO (``tpuspmm.formats.COO.random``)."""
        from tpuspmm_torch.formats.csr import CSR

        return CSR.random(rows, cols, density, seed).to_coo()

    def sort_by_row(self) -> "COO":
        if self.row_sorted:
            return self
        order = np.lexsort((self.cols, self.rows))
        return dataclasses.replace(
            self, rows=self.rows[order], cols=self.cols[order],
            values=self.values[order], row_sorted=True)

    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.coo_matrix(
            (self.values, (self.rows, self.cols)), shape=self.shape)

    def to_coo(self) -> "COO":
        return self

    def to_csr(self):
        from tpuspmm_torch.formats.csr import CSR

        return CSR.from_scipy(self.to_scipy())

    def save(self, path: str):
        fio.write_coo_text(path, self.shape, self.rows, self.cols,
                           self.values)
