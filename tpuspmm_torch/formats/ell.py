"""Column-major ELLPACK container (counterpart of ``tpuspmm.formats.ELL``).

For each column j of A it stores up to ``max_col_nnz`` (row index, value)
slots, padded with row -1 / value 0: C[rowind[j, s]] += values[j, s]·B[j]
for every slot that is not padding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm_torch.formats.base import MatrixBase
from tpuspmm_torch.formats import io as fio


@dataclasses.dataclass(frozen=True)
class ELL(MatrixBase):
    rowind: np.ndarray  # (num_cols, max_col_nnz) int32, -1 padded
    values: np.ndarray  # (num_cols, max_col_nnz) float32, 0 padded
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    max_col_nnz: int = 0

    format_name = "ell"

    @classmethod
    def from_file(cls, rowind_path: str, values_path: str) -> "ELL":
        """Load the reference pair `*_rowind.ell` + `*_values_colmajor.ell`."""
        shape, nnz, mcn, rowind, values = fio.read_ell_text(rowind_path,
                                                            values_path)
        return cls(rowind=rowind, values=values, shape=shape, nnz=nnz,
                   max_col_nnz=mcn)

    @classmethod
    def from_scipy(cls, m) -> "ELL":
        csc = m.tocsc()
        rows, cols = csc.shape
        col_nnz = np.diff(csc.indptr)
        mcn = int(col_nnz.max()) if cols else 0
        rowind = np.full((cols, mcn), -1, dtype=np.int32)
        values = np.zeros((cols, mcn), dtype=np.float32)
        col = np.repeat(np.arange(cols, dtype=np.int64), col_nnz)
        slot = (np.arange(csc.nnz, dtype=np.int64)
                - np.repeat(csc.indptr[:-1].astype(np.int64), col_nnz))
        rowind[col, slot] = csc.indices
        values[col, slot] = csc.data
        return cls(rowind=rowind, values=values, shape=(rows, cols),
                   nnz=int(csc.nnz), max_col_nnz=mcn)

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "ELL":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.csc_matrix(np.asarray(dense)))

    def to_coo(self):
        """The slots that are not padding, column-major."""
        from tpuspmm_torch.formats.coo import COO

        slots = self.rowind.shape[1] if self.rowind.size else 0
        cols = np.repeat(np.arange(self.shape[1], dtype=np.int32), slots)
        rows = self.rowind.ravel()
        keep = rows >= 0
        return COO(rows=rows[keep].astype(np.int32), cols=cols[keep],
                   values=self.values.ravel()[keep].astype(np.float32),
                   shape=self.shape)

    def to_scipy(self):
        return self.to_coo().to_scipy()

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_dense(self) -> np.ndarray:
        coo = self.to_coo()
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, (coo.rows, coo.cols), coo.values)
        return out.astype(np.float32)

    def save(self, rowind_path: str, values_path: str):
        fio.write_ell_text(rowind_path, values_path, self.shape, self.nnz,
                           self.max_col_nnz, self.rowind, self.values)
