"""Block-streaming BSR SpMM (kernel K6).

Counterpart of ``tpuspmm/kernels/bsr_spmm.py``.  The TPU kernel walks the
stored blocks in block-row order on a grid (n tile, stored block); each
step is one block @ B-panel product at HIGHEST precision, stored into its
block row's output tile on the row's first block and added after; an
empty block row gets one zero block (``_prep_bsr``).

On the card (``csrc/bsr_spmm.cu``, ``bsr_block_spmm``) nothing carries
over between blocks, so each (block row, row sub-tile, 64 columns) output
tile has one owner block that walks the block row's stored blocks in
stored order on the tensor cores (wgmma), accumulates in registers and
stores once; an empty block row is written as zeros.  The kernel reads the
container's own indptr / indices, the blocks' bf16 term planes
(:func:`term_planes`, built once per matrix in the kernel's shared-memory
layout) and the block rows most stored blocks first
(:func:`block_row_order`); :func:`prep_bsr`'s arrays (equal to JAX's)
serve the plain version.

Admission is the JAX package's, so that both packages route alike:
:func:`mxu_friendly` (bh % 8 == 0 and bw % 128 == 0) takes the kernel;
:func:`pack_blocks` re-tiles any other block size into 128 × 128
super-blocks when storage grows at most 4× and the shape allows it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.formats.bsr import BSR
from tpuspmm_torch.kernels import bsr_cuda
from tpuspmm_torch.kernels.common import pad_b, round_up, split_bf16
from tpuspmm_torch.ops import xla
from tpuspmm_torch.utils import profiling


def prep_bsr(a: BSR) -> dict:
    """Per stored block: its block row rt, block column kt, ``first`` flag
    and block, with one zero block (kt 0) added per empty block row and the
    whole stable-sorted by rt (the arrays of JAX's ``_prep_bsr``); cached
    on the container."""
    cache = container_cache(a)
    if "bsr_prep" not in cache:
        counts = np.diff(a.indptr).astype(np.int64)
        rt = np.repeat(np.arange(a.num_block_rows, dtype=np.int32), counts)
        kt = np.asarray(a.indices, dtype=np.int32)
        blocks = np.asarray(a.blocks, dtype=np.float32)
        empty = np.flatnonzero(counts == 0).astype(np.int32)
        if len(empty):
            rt = np.concatenate([rt, empty])
            kt = np.concatenate([kt, np.zeros(len(empty), np.int32)])
            zeros = np.zeros((len(empty),) + blocks.shape[1:], np.float32)
            blocks = np.concatenate([blocks, zeros]) if blocks.size else zeros
            order = np.argsort(rt, kind="stable")
            rt, kt, blocks = rt[order], kt[order], blocks[order]
        first = np.zeros(len(rt), dtype=np.int32)
        first[0] = 1
        first[1:] = (rt[1:] != rt[:-1]).astype(np.int32)
        cache["bsr_prep"] = {"rt": rt, "kt": kt, "first": first,
                             "blocks": blocks}
    return cache["bsr_prep"]


def swizzle128(tiles: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle of K-major bf16 tiles (last two axes: rows of
    64 values, 128 bytes): row r's 16-byte chunk c goes to chunk c ^ (r % 8),
    as the kernel's wgmma descriptor reads it.  Its own inverse."""
    rows = tiles.shape[-2]
    chunks = tiles.reshape(tiles.shape[:-1] + (8, 8))
    dest = np.arange(8)[None, :] ^ (np.arange(rows) % 8)[:, None]
    dest = dest.reshape((1,) * (tiles.ndim - 2) + (rows, 8, 1))
    return np.take_along_axis(chunks, dest, axis=-2).reshape(tiles.shape)


def term_planes(a: BSR) -> np.ndarray:
    """The stored blocks' three bf16 terms (``split_bf16``'s, in order) as
    K6 reads them, bf16 bits as int16, shape ``bsr_cuda.planes_shape``:
    per (block, row sub-tile, 64-column k-step) the three sub-tile x 64
    term planes, each swizzled (:func:`swizzle128`), so one bulk copy
    stages a step.  ``spmm_bsr_stream`` builds them once per matrix and
    device; a build is the span ``tpuspmm_torch.bsr.term_planes``."""
    with profiling.span("tpuspmm_torch.bsr.term_planes"):
        nb, bh, bw = a.blocks.shape
        _, subs, kq, terms, rt, kc = bsr_cuda.planes_shape(nb, bh, bw)
        parts = split_bf16(torch.from_numpy(
            np.ascontiguousarray(a.blocks, dtype=np.float32)), terms)
        bits = np.stack([p.view(torch.int16).numpy() for p in parts])
        # (term, block, sub, row, k-step, col) -> (block, sub, k-step, term,
        # row, col)
        bits = bits.reshape(terms, nb, subs, rt, kq, kc).transpose(
            1, 2, 4, 0, 3, 5)
        return np.ascontiguousarray(swizzle128(bits))


def block_row_order(a: BSR) -> np.ndarray:
    """The block rows, most stored blocks first (stable), empty rows last:
    K6's launch order, so the owners of the heaviest rows start first."""
    counts = np.diff(np.asarray(a.indptr, dtype=np.int64))
    return np.argsort(-counts, kind="stable").astype(np.int32)


def mxu_friendly(block_size) -> bool:
    """The JAX package's admission: bh % 8 == 0 and bw % 128 == 0."""
    bh, bw = block_size
    return bh % 8 == 0 and bw % 128 == 0


def pack_blocks(a: BSR, super_block=(128, 128)) -> Optional[BSR]:
    """``a`` re-tiled into ``super_block`` blocks, or None where the shape
    is not a multiple of it or the stored values would grow more than 4×
    (the JAX package's rule); cached on the container."""
    cache = container_cache(a)
    key = ("packed", tuple(super_block))
    if key not in cache:
        sp = a.to_scipy().tocsr()
        try:
            m = sp.tobsr(blocksize=super_block)
        except ValueError:
            packed = None
        else:
            grows = a.blocks.size and m.data.size > 4 * a.blocks.size
            packed = None if grows else BSR.from_scipy(m, super_block)
        cache[key] = packed
    return cache[key]


def stream_operand(a: BSR) -> Optional[BSR]:
    """What K6 serves ``a`` from: ``a`` itself where its blocks are
    admitted, else its 128 × 128 packed copy, else None (the JAX package's
    fall-back order; the caller serves None another way)."""
    return a if mxu_friendly(a.block_size) else pack_blocks(a)


def _check(a: BSR, b: torch.Tensor) -> None:
    if not mxu_friendly(a.block_size):
        raise ValueError(f"block size {a.block_size} is not admitted by K6 "
                         "(bh % 8, bw % 128); use pack_blocks or the tile "
                         "kernel")
    if b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"b must be ({a.shape[1]}, N), got "
                         f"{tuple(b.shape)}")
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"b must be f32 or bf16, got {b.dtype}")


def bsr_spmm_plain(a: BSR, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 on b's device: the prepared blocks' products
    (full f32) added into their block rows in stored order, B zero-padded
    to a multiple of bw rows as JAX's ``pad_b`` does."""
    _check(a, b)
    p = prep_bsr(a)
    rt, kt, blocks = xla.cached_device(
        a, "bsr_prep_tensors", b.device,
        lambda: (p["rt"], p["kt"], p["blocks"]))
    bw = a.block_size[1]
    b_pad = pad_b(b, round_up(a.shape[1], bw), int(b.shape[1]))
    out = xla.spmm_bsr_blocks(rt, kt, blocks, b_pad, a.num_block_rows)
    return out[:a.shape[0]]


def stream_launch(a: BSR, b: torch.Tensor):
    """:func:`spmm_bsr_stream`'s launch on the card for B of b's shape,
    dtype and device (contiguous): K6 bound to the container's indptr,
    indices, block-row order and term planes (``bsr_cuda.bind``), once,
    and cached on the container; ``launch(b)`` is C."""
    _check(a, b)
    cache = container_cache(a)
    key = ("bsr_launch", int(b.shape[1]), b.dtype, b.device)
    if key not in cache:
        indptr, indices, order, planes = xla.cached_device(
            a, "bsr_arrays", b.device,
            lambda: (a.indptr, a.indices, block_row_order(a),
                     term_planes(a)))
        cache[key] = bsr_cuda.bind(indptr, indices, order, planes, b,
                                   a.shape[0], a.block_size,
                                   counter=spmm_bsr_stream)
    return cache[key]


def spmm_bsr_stream(a: BSR, b: torch.Tensor) -> torch.Tensor:
    """Container-level entry of K6: the (M, N) float32 result on b's
    device.  On a CUDA tensor it launches ``bsr_block_spmm``
    (:func:`stream_launch`) or raises; on a CPU tensor it runs
    :func:`bsr_spmm_plain`."""
    if b.device.type == "cpu":
        return bsr_spmm_plain(a, b)
    b = b.contiguous()
    return stream_launch(a, b)(b)


spmm_bsr_stream.launches = 0
