"""Tile-sparse SpMM over the tile plan (kernel K3).

Counterpart of ``tpuspmm/kernels/tile_spmm.py``.  The plan
(``formats/tiles.py``) holds chunks of E nonzeros, each inside one
(tile_m × tile_k) tile of A.  The TPU kernel runs a grid (n tile, chunk),
densifies each chunk with two one-hot matmuls and stores its product into
the output tile ``rt[c]`` on ``first[c]``, adding otherwise.

On the card (``csrc/chunk_spmm.cu``, ``tile_chunk_spmm``) each output tile
of tile_m rows × 64 columns has one owner block that walks its row tile's
chunks in plan order (the plan is sorted by row tile, so they are one
contiguous range) and gathers B rows directly: the one-hot matmuls exist
only because Mosaic could not lower an in-kernel gather.  On a CPU tensor
the entry runs the plain version, :func:`tile_spmm_plain`.

The plain versions of the whole tile family share :func:`walk_plain`: it
runs the TPU's tier arithmetic term for term in float32 on whatever chunk
layout its caller hands it.

Tiers: "split" (3-term bf16 splits, the default), "split2" (2-term,
verified-only) and "highest" (f32 products).  bf16 B takes one gather pass.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from tpuspmm_torch.formats.tiles import TilePlan, plan_from_container
from tpuspmm_torch.kernels.common import (full_f32_matmul, onehot_dot_split,
                                          pad_b, round_up, split_bf16)
from tpuspmm_torch.kernels.panel_spmm import PLAIN_BATCH_BYTES, check_operand

MODES = ("split", "split2", "highest")


def check_mode(mode: str) -> bool:
    """Refuse an unknown tier; True for the 2-term tier."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode == "split2"


def chunk_contribs(krow0, rows, cols, vals, b_pad, tm: int, tk: int,
                   mode: str) -> torch.Tensor:
    """(c, tm, n) products of c chunks in the TPU's tier arithmetic.
    ``krow0`` (c,) is the first B row of each chunk's k tile; ``b_pad``
    is B with its rows padded to whole k tiles.

    - split / split2: gather each nonzero's B row as the f32 sum of its 3
      or 2 bf16 terms (one term for bf16 B; the one-hot gather on the MXU
      selects each term exactly), scale by the value, split the product
      again and scatter it with the row one-hot, one f32 matmul per term.
    - highest: A tile = onehot(rows) @ (onehot(cols)·vals), then
      A tile @ B panel, both in full f32."""
    krow0 = krow0.long()
    dev = b_pad.device
    r_onehot = (rows.unsqueeze(1)
                == torch.arange(tm, device=dev).view(1, tm, 1))
    if mode == "highest":
        k_onehot = ((cols.unsqueeze(-1) == torch.arange(tk, device=dev))
                    .float() * vals.unsqueeze(-1))
        panels = b_pad[krow0.unsqueeze(-1)
                       + torch.arange(tk, device=dev)].float()
        with full_f32_matmul():
            a_tile = torch.matmul(r_onehot.float(), k_onehot)
            return torch.matmul(a_tile, panels)
    terms = 2 if mode == "split2" else 3
    b_rows = b_pad[krow0.unsqueeze(-1) + cols.long()]  # (c, E, n)
    parts = ([b_rows] if b_rows.dtype == torch.bfloat16
             else split_bf16(b_rows, terms))
    g = functools.reduce(operator.add, [p.float() for p in parts])
    v = g * vals.unsqueeze(-1)
    with full_f32_matmul():
        return onehot_dot_split(r_onehot, split_bf16(v, terms))


def walk_plain(rt, krow0, rows, cols, vals, b: torch.Tensor, m_pad: int,
               tm: int, tk: int, mode: str) -> torch.Tensor:
    """Plain version of a tile-family kernel: every chunk's product
    (:func:`chunk_contribs`) added into row tile ``rt`` of a zeroed
    (m_pad, n) output, in layout order (``index_add_``), in batches of at
    most PLAIN_BATCH_BYTES of intermediates.  Chunks with rt < 0
    (sentinels) are dropped, never indexed."""
    keep = rt >= 0
    rt, krow0 = rt[keep].long(), krow0[keep]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    n = int(b.shape[1])
    E = int(rows.shape[1]) if rows.dim() == 2 else 1
    k_pad = round_up(int(b.shape[0]), tk)
    b_pad = pad_b(b, k_pad, n)
    out = torch.zeros(m_pad, n, dtype=torch.float32, device=b.device)
    per_chunk = (10 * E + tk + 2 * tm) * max(n, 1) * 4
    batch = max(1, PLAIN_BATCH_BYTES // per_chunk)
    local = torch.arange(tm, device=b.device)
    for c0 in range(0, int(rt.shape[0]), batch):
        c1 = c0 + batch
        contrib = chunk_contribs(krow0[c0:c1], rows[c0:c1], cols[c0:c1],
                                 vals[c0:c1], b_pad, tm, tk, mode)
        dst = (rt[c0:c1].unsqueeze(-1) * tm + local).reshape(-1)
        out.index_add_(0, dst, contrib.reshape(-1, n))
    return out


def tile_spmm_plain(plan: TilePlan, b: torch.Tensor,
                    mode: str = "split") -> torch.Tensor:
    """Plain version of K3 on b's device: the plan's chunks in plan order
    (the TPU's grid order within each column tile)."""
    arrs = plan.device_arrays(b.device)
    out = walk_plain(arrs["rt"], arrs["kt"].long() * plan.tile_k,
                     arrs["rows"], arrs["cols"], arrs["vals"], b,
                     plan.padded_shape[0], plan.tile_m, plan.tile_k, mode)
    return out[:plan.shape[0]]


def owner_arrays(plan: TilePlan, device) -> dict:
    """Device tensors the owner-walk kernels (K3, K5a, K5b) read: the
    plan's row-major chunk arrays, shared with the plain version, and
    ``tile_ptr``, row tile r owning chunks [tile_ptr[r], tile_ptr[r+1])
    (the plan is sorted by row tile).  Transferred once per plan and
    device."""
    arrs = dict(plan.device_arrays(device))
    arrs.update(plan.device_arrays(device, "tile_ptr", lambda: {
        "tile_ptr": np.searchsorted(
            plan.rt, np.arange(plan.num_row_tiles + 1)).astype(np.int32)}))
    return arrs


def spmm_tiles(plan: TilePlan, b: torch.Tensor, tile_n: int | None = None,
               mode: str = "split") -> torch.Tensor:
    """SpMM from a prebuilt TilePlan: the (M, N) float32 result on b's
    device.  On a CUDA tensor it launches ``tile_chunk_spmm`` or raises;
    on a CPU tensor it runs :func:`tile_spmm_plain` in column blocks of
    ``tile_n`` (JAX's column tile: min(round_up(N, 128), 512) by
    default), which leave the result unchanged.  ``tile_n`` has no effect
    on the card: the kernel's column tile is fixed (64)."""
    split2 = check_mode(mode)
    check_operand(plan, b)
    n = int(b.shape[1])
    tile_n = tile_n or min(round_up(n, 128), 512)
    if tile_n % 128:
        raise ValueError(f"tile_n must be a multiple of 128, got {tile_n}")
    if b.device.type == "cpu":
        return torch.cat([tile_spmm_plain(plan, b[:, j:j + tile_n], mode)
                          for j in range(0, n, tile_n)], dim=1)
    from tpuspmm_torch.kernels import chunk_cuda

    out = chunk_cuda.owner_walk("tile_chunk_spmm",
                                owner_arrays(plan, b.device), b.contiguous(),
                                plan.shape[0], plan.tile_m, plan.tile_k,
                                plan.chunk, split2)
    spmm_tiles.launches += 1
    return out


spmm_tiles.launches = 0


def spmm_tile_sparse(a, b: torch.Tensor, tile_m: int = 128,
                     tile_k: int = 128, chunk: int = 128,
                     tile_n: int | None = None,
                     mode: str = "split") -> torch.Tensor:
    """Container-level entry: the plan, built and cached on the container,
    then :func:`spmm_tiles`."""
    plan = plan_from_container(a, tile_m=tile_m, tile_k=tile_k, chunk=chunk)
    return spmm_tiles(plan, b, tile_n=tile_n, mode=mode)
