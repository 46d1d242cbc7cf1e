"""Dense operand container (counterpart of ``tpuspmm.formats.DenseMatrix``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm_torch.formats import io as fio


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    data: np.ndarray  # (rows, cols) float32, row-major
    shape: Tuple[int, int] = (0, 0)

    format_name = "dense"

    @classmethod
    def from_file(cls, path: str) -> "DenseMatrix":
        """Load `dense.in`."""
        arr = fio.read_dense_text(path)
        return cls(data=arr, shape=tuple(arr.shape))

    @classmethod
    def from_array(cls, arr) -> "DenseMatrix":
        arr = np.asarray(arr, dtype=np.float32)
        return cls(data=arr, shape=tuple(arr.shape))
