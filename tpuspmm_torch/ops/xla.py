"""Gather / segment-sum and densify SpMM (no hand-written kernel).

Counterpart of ``tpuspmm/ops/xla.py`` for CSR and COO: the JAX package
computes these outside any Pallas kernel, so here they are plain PyTorch.

- ``spmm_triplets``: C[rows[e]] += values[e] · B[cols[e]] by a gather of B
  rows and ``index_add_``; sentinel rows (< 0) are dropped, duplicate
  coordinates add up, and a bf16 B accumulates in float32.
- ``spmm_csr_xla`` / ``spmm_coo_xla``: the container's triplets, moved to
  the device once and cached on the container.
- ``spmm_densify_cached``: A densified once on the host in float64
  (duplicates fold deterministically), cached as a float32 dense tensor on
  the device, then one float32 ``torch.matmul`` per call, in full f32 (the
  JAX package's Precision.HIGHEST) whatever ``allow_tf32`` says.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.kernels.common import full_f32_matmul

# bytes of gathered (nnz, n) intermediates per batch of spmm_triplets
GATHER_BATCH_BYTES = 256 * 1024 * 1024


def coo_view(a):
    """COO triplet view of a container, cached on it."""
    if a.format_name == "coo":
        return a
    cache = container_cache(a)
    if "coo_view" not in cache:
        cache["coo_view"] = a.to_coo()
    return cache["coo_view"]


def cached_device(a, key: str, device, build):
    """Tensors ``build()`` returns (a tuple of numpy arrays), moved to
    ``device`` once and cached on the container under ``key``."""
    cache = container_cache(a)
    ck = (key, str(torch.device(device)))
    if ck not in cache:
        cache[ck] = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                          for x in build())
    return cache[ck]


def spmm_triplets(rows: torch.Tensor, cols: torch.Tensor,
                  values: torch.Tensor, b: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """C = scatter-add over triplets, (num_rows, N) on b's device, in
    float32 for f32 / bf16 B (float64 for f64 B), in batches of at most
    GATHER_BATCH_BYTES of gathered rows."""
    acc = torch.float64 if b.dtype == torch.float64 else torch.float32
    keep = rows >= 0
    rows, cols, values = rows[keep].long(), cols[keep].long(), values[keep]
    n = int(b.shape[1])
    out = torch.zeros(num_rows, n, dtype=acc, device=b.device)
    step = max(1, GATHER_BATCH_BYTES // max(n * 8, 1))
    for s in range(0, int(rows.shape[0]), step):
        contrib = (values[s:s + step, None].to(acc)
                   * b[cols[s:s + step]].to(acc))
        out.index_add_(0, rows[s:s + step], contrib)
    return out


def expand_indptr(indptr: np.ndarray, nnz: int) -> np.ndarray:
    """CSR indptr → per-entry row ids (host)."""
    indptr = np.asarray(indptr)
    return np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                     np.diff(indptr).astype(np.int64))[:nnz]


def spmm_csr_xla(a, b: torch.Tensor) -> torch.Tensor:
    rows, cols, vals = cached_device(
        a, "triplets", b.device,
        lambda: (expand_indptr(a.indptr, a.nnz), a.indices, a.values))
    return spmm_triplets(rows, cols, vals, b, a.shape[0])


def spmm_coo_xla(a, b: torch.Tensor) -> torch.Tensor:
    rows, cols, vals = cached_device(
        a, "triplets", b.device, lambda: (a.rows, a.cols, a.values))
    return spmm_triplets(rows, cols, vals, b, a.shape[0])


def spmm_xla(a, b: torch.Tensor) -> torch.Tensor:
    """The gather path of a CSR or COO container."""
    if a.format_name == "csr":
        return spmm_csr_xla(a, b)
    if a.format_name == "coo":
        return spmm_coo_xla(a, b)
    raise TypeError(f"no gather path for {a.format_name!r} input")


def dense_f32(a) -> np.ndarray:
    """A as a dense float32 array, summed on the host in float64."""
    coo = coo_view(a)
    dense = np.zeros(a.shape, np.float64)
    np.add.at(dense, (np.asarray(coo.rows), np.asarray(coo.cols)),
              np.asarray(coo.values, dtype=np.float64))
    return dense.astype(np.float32)


def spmm_densify_cached(a, b: torch.Tensor) -> torch.Tensor:
    """C = dense(A) @ B with dense(A) built once and cached on the
    container per device; float32 result (B upcast from bf16)."""
    (a_dense,) = cached_device(a, "dense_f32", b.device,
                               lambda: (dense_f32(a),))
    with full_f32_matmul():
        return torch.matmul(a_dense, b.float())
