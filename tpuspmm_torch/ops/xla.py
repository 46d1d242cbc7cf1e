"""Counterpart of ``tpuspmm/ops/xla.py``.  This slice of the port carries
only the cached COO view that the plan builders read; the gather and
segment-sum paths are a later slice."""

from __future__ import annotations

from tpuspmm_torch.formats.base import container_cache


def coo_view(a):
    """COO triplet view of a container, cached on it."""
    if a.format_name == "coo":
        return a
    cache = container_cache(a)
    if "coo_view" not in cache:
        cache["coo_view"] = a.to_coo()
    return cache["coo_view"]
