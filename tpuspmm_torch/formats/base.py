"""Shared machinery for the sparse-format containers.

Containers are frozen dataclasses of host numpy arrays.  Derived objects
(COO views, plans, device tensors) are cached on the container with
``object.__setattr__`` so a static sparse operand is converted and
transferred once and served many times.
"""

from __future__ import annotations

from typing import Tuple


class MatrixBase:
    shape: Tuple[int, int]

    @property
    def sparsity(self) -> float:
        """nnz / (rows*cols) (the reference's "sparsity" record field)."""
        return float(self.nnz) / float(self.shape[0] * self.shape[1])


def container_cache(a) -> dict:
    """Per-container dict for derived objects (plans, geometries, device
    tensors), created on first use."""
    cache = getattr(a, "_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(a, "_cache", cache)
    return cache
