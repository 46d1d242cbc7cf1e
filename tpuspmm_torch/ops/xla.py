"""Gather / segment-sum and densify SpMM (no hand-written kernel).

Counterpart of ``tpuspmm/ops/xla.py``: the JAX package computes these
outside any Pallas kernel, so here they are plain PyTorch.

- ``spmm_triplets``: C[rows[e]] += values[e] · B[cols[e]] by a gather of B
  rows and ``index_add_``; sentinel rows (< 0) are dropped, duplicate
  coordinates add up, and a bf16 B accumulates in float32.
- ``spmm_csr_xla`` / ``spmm_coo_xla`` / ``spmm_ell_xla``: the container's
  triplets (ELL's with its -1 padding slots), moved to the device once and
  cached on the container.
- ``spmm_bsr_blocks`` / ``spmm_bsr_xla``: the B panel of every stored
  block gathered, one batched full-f32 product, ``index_add_`` over block
  rows.
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


def spmm_ell_xla(a, b: torch.Tensor) -> torch.Tensor:
    """Slot (j, s) adds values[j, s]·B[j] to row rowind[j, s]; the -1
    padding slots are dropped by ``spmm_triplets``."""
    def build():
        ncols, mcn = a.rowind.shape
        return (a.rowind.ravel(),
                np.repeat(np.arange(ncols, dtype=np.int32), mcn),
                a.values.ravel())

    rows, cols, vals = cached_device(a, "triplets", b.device, build)
    return spmm_triplets(rows, cols, vals, b, a.shape[0])


def spmm_bsr_blocks(block_rows: torch.Tensor, indices: torch.Tensor,
                    blocks: torch.Tensor, b: torch.Tensor,
                    num_block_rows: int) -> torch.Tensor:
    """C = Σ_i blocks[i] @ B[indices[i]·bw : +bw] added into block row
    block_rows[i], in stored order: one batched full-f32 product per batch
    of at most GATHER_BATCH_BYTES of gathered B panels, then
    ``index_add_``.  B's rows must be a multiple of bw; a bf16 B is upcast
    (exactly).  Returns (num_block_rows·bh, N) float32."""
    _, bh, bw = blocks.shape
    n = int(b.shape[1])
    panels = b.float().reshape(-1, bw, n)
    out = torch.zeros(num_block_rows, bh, n, dtype=torch.float32,
                      device=b.device)
    step = max(1, GATHER_BATCH_BYTES // max(bw * n * 4, 1))
    with full_f32_matmul():
        for s in range(0, int(blocks.shape[0]), step):
            prod = torch.bmm(blocks[s:s + step],
                             panels[indices[s:s + step].long()])
            out.index_add_(0, block_rows[s:s + step].long(), prod)
    return out.reshape(num_block_rows * bh, n)


def spmm_bsr_xla(a, b: torch.Tensor) -> torch.Tensor:
    block_rows, indices, blocks = cached_device(
        a, "blocks", b.device,
        lambda: (expand_indptr(a.indptr, a.nblocks), a.indices, a.blocks))
    return spmm_bsr_blocks(block_rows, indices, blocks, b,
                           a.num_block_rows)


def spmm_xla(a, b: torch.Tensor) -> torch.Tensor:
    """The gather path of a container: its format's, else (CSC) its CSR
    view's."""
    fn = {"csr": spmm_csr_xla, "coo": spmm_coo_xla, "bsr": spmm_bsr_xla,
          "ell": spmm_ell_xla}.get(a.format_name)
    if fn is not None:
        return fn(a, b)
    if hasattr(a, "to_csr"):
        cache = container_cache(a)
        if "csr_view" not in cache:
            cache["csr_view"] = a.to_csr()
        return spmm_csr_xla(cache["csr_view"], b)
    raise TypeError(f"no gather path for {a.format_name!r} input")


def dense_f32(a) -> np.ndarray:
    """A as a dense float32 array, summed on the host in float64."""
    coo = coo_view(a)
    dense = np.zeros(a.shape, np.float64)
    np.add.at(dense, (np.asarray(coo.rows), np.asarray(coo.cols)),
              np.asarray(coo.values, dtype=np.float64))
    return dense.astype(np.float32)


def dense_operand(a, device) -> torch.Tensor:
    """dense(A) as float32 on ``device``, built once (:func:`dense_f32`)
    and cached on the container per device."""
    (a_dense,) = cached_device(a, "dense_f32", device,
                               lambda: (dense_f32(a),))
    return a_dense


def dense_product(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a_dense @ B in full f32 (B upcast from bf16)."""
    with full_f32_matmul():
        return torch.matmul(a_dense, b.float())


def spmm_densify_cached(a, b: torch.Tensor) -> torch.Tensor:
    """C = dense(A) @ B with dense(A) built once and cached on the
    container per device; float32 result (B upcast from bf16)."""
    return dense_product(dense_operand(a, b.device), b)
