"""Vendor-baseline SpMM (kernel number -1): ``torch.sparse`` CSR @ dense,
which is cuSPARSE on the card — the library the reference benchmarks its
kernels against (counterpart of ``tpuspmm/ops/vendor.py``)."""

from __future__ import annotations

import torch

from tpuspmm_torch.formats.base import container_cache


def to_torch_csr(a, device) -> torch.Tensor:
    """The container as a ``torch.sparse_csr_tensor`` on ``device``
    (float32 values, duplicates summed), cached per device."""
    device = torch.device(device)
    cache = container_cache(a)
    key = ("vendor_csr", str(device))
    if key not in cache:
        csr = a if a.format_name == "csr" else a.to_csr()
        sp = csr.to_scipy().copy()  # sum_duplicates sorts in place
        sp.sum_duplicates()
        cache[key] = torch.sparse_csr_tensor(
            torch.from_numpy(sp.indptr.astype("int32")),
            torch.from_numpy(sp.indices.astype("int32")),
            torch.from_numpy(sp.data.astype("float32")),
            size=tuple(a.shape), check_invariants=True).to(device)
    return cache[key]


def spmm_vendor(a, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B through torch.sparse on b's device, in float32 (a bf16 B
    is upcast, exactly)."""
    return to_torch_csr(a, b.device) @ b.float()
