"""Tile-sparse SpMM over the tile plan (kernel K3).

Counterpart of ``tpuspmm/kernels/tile_spmm.py``.  The plan
(``formats/tiles.py``) holds chunks of E nonzeros, each inside one
(tile_m × tile_k) tile of A.  The TPU kernel runs a grid (n tile, chunk),
densifies each chunk with two one-hot matmuls and stores its product into
the output tile ``rt[c]`` on ``first[c]``, adding otherwise.

On the card (``csrc/chunk_spmm.cu``, ``tile_chunk_spmm``) each output tile
of tile_m rows × 64 or 128 columns has one owner block, a warp for each
16 rows, reading the plan through a tile index built once on the host
(:func:`build_tile_index`): the dense (row tile, k-tile) tiles run on the
tensor cores from a B panel staged once, the other nonzeros gather their B
rows directly (the one-hot matmuls exist only because Mosaic could not
lower an in-kernel gather).  K4 and K5 run the same routine.  On a CPU
tensor the entry runs the plain version, :func:`tile_spmm_plain`.

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
from tpuspmm_torch.kernels import chunk_cuda
from tpuspmm_torch.kernels.common import (full_f32_matmul, onehot_dot_split,
                                          pad_b, round_up, split_bf16)
from tpuspmm_torch.kernels.panel_spmm import PLAIN_BATCH_BYTES, check_operand

MODES = ("split", "split2", "highest")
# a (row tile, k-tile) tile takes the tile-owner routine's dense path from
# DENSE_PER_TILE_K·tile_k nonzeros on.  At tile_k nonzeros a staged B
# panel moves no more bytes than the gathered rows, but a dense tile runs
# tile_m·tile_k products a column on the tensor cores (3 or 6 a term pair)
# where gathering runs one a nonzero: on the H100, tiles of 128-1023
# nonzeros ran faster gathered (strip_sweep.py --chunk, PERF.md §6)
DENSE_PER_TILE_K = 8.0


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


def dense_min(tile_k: int, split2: bool) -> float:
    """Nonzeros from which a (row tile, k-tile) tile takes the dense path:
    DENSE_PER_TILE_K·tile_k; never at "split2" (the TPU's arithmetic per
    nonzero) or when tile_k is not a multiple of the routine's k-chunk."""
    if split2 or tile_k % chunk_cuda.KC:
        return float("inf")
    return DENSE_PER_TILE_K * tile_k


def build_tile_index(rt, kt, rows, cols, vals, num_row_tiles: int,
                     tile_m: int, tile_k: int, min_dense: float) -> dict:
    """The tile-owner routine's index (numpy) of chunk arrays listed in
    walk order (``rt``, ``kt`` per chunk; ``rows``, ``cols``, ``vals``
    (C, E)), each row tile's chunks in ascending k-tile.

    Padding slots (row -1) and chunks (rt -1) are dropped.  Each non-empty
    (rt, kt) tile with at least ``min_dense`` nonzeros is dense: its A
    tile, rows padded to a multiple of WARP_ROWS, is densified in f32 with
    duplicates added in walk order (``d_a``; ``d_ptr`` per row tile,
    ``d_kt``; in ascending kt).  The other nonzeros form a CSR over the
    padded output rows (``row_ptr``, ``g_col`` = global k, ``g_val``),
    each row's in walk order, so in ascending k-tile.  ``order`` lists the
    row tiles by nonzeros, most first (stable).  For records and tests:
    per tile ``tile_rt``, ``tile_kt``, ``tile_nnz``, ``tile_dense`` and its
    chunk range [``tile_c0``, ``tile_c1``) in the walk."""
    rt = np.asarray(rt).astype(np.int64)
    kt = np.asarray(kt).astype(np.int64)
    rows = np.asarray(rows)
    keep = (rows >= 0) & (rt[:, None] >= 0)
    ci, slot = np.nonzero(keep)  # walk order
    r_loc = rows[ci, slot].astype(np.int64)
    c_loc = np.asarray(cols)[ci, slot].astype(np.int64)
    v = np.asarray(vals, dtype=np.float32)[ci, slot]
    t_rt, t_kt = rt[ci], kt[ci]
    nkt = int(kt.max()) + 1 if len(kt) else 1
    key = t_rt * nkt + t_kt
    ukey, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    dense_t = counts >= min_dense
    is_dense = dense_t[inv]
    m_pad = num_row_tiles * tile_m

    sparse = ~is_dense
    grow = t_rt[sparse] * tile_m + r_loc[sparse]
    by_row = np.argsort(grow, kind="stable")
    row_ptr = np.zeros(m_pad + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(grow, minlength=m_pad))

    dkeys = ukey[dense_t]
    d_rt = dkeys // nkt
    tm16 = round_up(tile_m, chunk_cuda.WARP_ROWS)
    d_a = np.zeros((len(dkeys), tm16, tile_k), np.float32)
    np.add.at(d_a, (np.searchsorted(dkeys, key[is_dense]), r_loc[is_dense],
                    c_loc[is_dense]), v[is_dense])

    nnz_rt = np.bincount(t_rt, minlength=num_row_tiles)
    c0 = np.full(len(ukey), len(rt), np.int64)
    c1 = np.zeros(len(ukey), np.int64)
    np.minimum.at(c0, inv, ci)
    np.maximum.at(c1, inv, ci + 1)
    return {
        "row_ptr": row_ptr.astype(np.int32),
        "g_col": (t_kt[sparse] * tile_k + c_loc[sparse])[by_row].astype(
            np.int32),
        "g_val": v[sparse][by_row],
        "d_ptr": np.searchsorted(d_rt, np.arange(num_row_tiles + 1)).astype(
            np.int32),
        "d_kt": (dkeys % nkt).astype(np.int32),
        "d_a": d_a,
        "order": np.argsort(-nnz_rt, kind="stable").astype(np.int32),
        "tile_rt": ukey // nkt, "tile_kt": ukey % nkt, "tile_nnz": counts,
        "tile_dense": dense_t, "tile_c0": c0, "tile_c1": c1,
    }


def host_index(plan: TilePlan, min_dense: float) -> dict:
    """The tile index of ``plan`` in its row-major walk, built once and
    cached on the plan."""
    return plan.derived(("tile_index", min_dense), lambda: build_tile_index(
        plan.rt, plan.kt, plan.rows, plan.cols, plan.vals,
        plan.num_row_tiles, plan.tile_m, plan.tile_k, min_dense))


def index_arrays(plan: TilePlan, device, min_dense: float) -> dict:
    """The tile index's device arrays (``chunk_cuda.INDEX``), transferred
    once per plan, threshold and device: K3, K4, K5a and K5b share them."""
    return plan.device_arrays(
        device, ("tile_index", min_dense),
        lambda: {k: host_index(plan, min_dense)[k] for k in chunk_cuda.INDEX})


def owner_launch(plan: TilePlan, b: torch.Tensor, entry: str, split2: bool,
                 counter):
    """The owner routine's launch as ``entry`` (K3 or K4), bound to
    ``plan``'s tile index for B of b's shape, dtype and device
    (``chunk_cuda.bind``), once, and cached on the plan; ``counter`` is
    the entry whose ``launches`` it counts."""
    key = ("launch", entry, int(b.shape[1]), b.dtype, b.device, split2)
    return plan.derived(key, lambda: chunk_cuda.bind(
        entry, index_arrays(plan, b.device, dense_min(plan.tile_k, split2)),
        b, plan.shape[0], plan.tile_m, plan.tile_k, split2,
        counter=counter))


def tiles_launch(plan: TilePlan, b: torch.Tensor, mode: str = "split"):
    """:func:`spmm_tiles`' launch on the card for B of b's shape, dtype
    and device (contiguous): ``launch(b)`` is C."""
    split2 = check_mode(mode)
    check_operand(plan, b)
    return owner_launch(plan, b, "tile_chunk_spmm", split2, spmm_tiles)


def spmm_tiles(plan: TilePlan, b: torch.Tensor, tile_n: int | None = None,
               mode: str = "split") -> torch.Tensor:
    """SpMM from a prebuilt TilePlan: the (M, N) float32 result on b's
    device.  On a CUDA tensor it launches ``tile_chunk_spmm`` (its
    launch bound once per plan, B width, B dtype and device:
    :func:`tiles_launch`) or raises; on a CPU tensor it runs
    :func:`tile_spmm_plain` in column blocks of ``tile_n`` (JAX's column
    tile: min(round_up(N, 128), 512) by default), which leave the result
    unchanged.  ``tile_n`` has no effect on the card: the routine picks
    its own column tile (64 or 128)."""
    check_mode(mode)
    check_operand(plan, b)
    n = int(b.shape[1])
    tile_n = tile_n or min(round_up(n, 128), 512)
    if tile_n % 128:
        raise ValueError(f"tile_n must be a multiple of 128, got {tile_n}")
    if b.device.type == "cpu":
        return torch.cat([tile_spmm_plain(plan, b[:, j:j + tile_n], mode)
                          for j in range(0, n, tile_n)], dim=1)
    b = b.contiguous()
    return tiles_launch(plan, b, mode)(b)


spmm_tiles.launches = 0


def spmm_tile_sparse(a, b: torch.Tensor, tile_m: int = 128,
                     tile_k: int = 128, chunk: int = 128,
                     tile_n: int | None = None,
                     mode: str = "split") -> torch.Tensor:
    """Container-level entry: the plan, built and cached on the container,
    then :func:`spmm_tiles`."""
    plan = plan_from_container(a, tile_m=tile_m, tile_k=tile_k, chunk=chunk)
    return spmm_tiles(plan, b, tile_n=tile_n, mode=mode)
