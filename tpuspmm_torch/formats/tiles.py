"""Tile plan: unstructured sparsity grouped into fixed-size chunks.

Counterpart of ``tpuspmm/formats/tiles.py``, numpy path (the arrays are
equal to the JAX package's).  ``build_tile_plan`` groups the nonzeros of a
matrix by (row tile, k tile), orders the groups row-tile-major and
ascending in k tile, and splits each group into chunks of E nonzeros,
padded with sentinel row -1.  Every row tile gets at least one (possibly
all-sentinel) chunk, and the chunk count is padded to a multiple of 8 with
all-sentinel chunks attached to the last row tile with k tile 0.

The tile-plan kernels (K3 tile, K4 staged, K5 C-resident) all read this
plan.  As in the JAX package, a plan of ``NATIVE_MIN_NNZ`` nonzeros or
more is built by the host library (``native/tileplan.cpp``, the same
arrays); where it does not build, by numpy, and ``native.plan_builds``
counts which.  No corpus matrix reaches the cut-off; the sparsity sweep's
operands (419,430 nonzeros at density 0.1 of 2048 x 2048) and the pruned
weights do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static-shape chunked tiling of a sparse matrix (host-built)."""

    rt: np.ndarray     # (C,) int32 — row-tile id, non-decreasing
    kt: np.ndarray     # (C,) int32 — k-tile id
    first: np.ndarray  # (C,) int32 — 1 iff first chunk of its row tile
    rows: np.ndarray   # (C, E) int32 — row offset within tile, -1 = padding
    cols: np.ndarray   # (C, E) int32 — col offset within tile
    vals: np.ndarray   # (C, E) float32

    shape: Tuple[int, int]
    tile_m: int
    tile_k: int
    chunk: int

    @property
    def num_chunks(self) -> int:
        return int(self.rt.shape[0])

    @property
    def num_row_tiles(self) -> int:
        return _cdiv(self.shape[0], self.tile_m)

    @property
    def num_k_tiles(self) -> int:
        return _cdiv(self.shape[1], self.tile_k)

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (self.num_row_tiles * self.tile_m,
                self.num_k_tiles * self.tile_k)

    def derived(self, key, build):
        """A host object derived from the plan (layouts, owner indices),
        built once and cached on it."""
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def device_arrays(self, device, key="plan", build=None) -> dict:
        """Named int32 / float32 tensors on ``device``, transferred once and
        cached: the plan's own arrays, or those ``build()`` returns (a
        dict of numpy arrays) under ``key``."""
        cache = self.__dict__.setdefault("_device", {})
        ck = (key, str(torch.device(device)))
        if ck not in cache:
            arrs = (build() if build is not None else
                    {"rt": self.rt, "kt": self.kt, "first": self.first,
                     "rows": self.rows, "cols": self.cols,
                     "vals": self.vals})
            cache[ck] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device) for k, v in arrs.items()}
        return cache[ck]

    def chunk_ranges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(start, end) chunk index per row tile."""
        nrt = self.num_row_tiles
        start = np.zeros(nrt, dtype=np.int32)
        end = np.zeros(nrt, dtype=np.int32)
        # rt is sorted non-decreasing and covers every row tile
        boundaries = np.searchsorted(self.rt, np.arange(nrt + 1))
        start[:] = boundaries[:-1]
        end[:] = boundaries[1:]
        return start, end


# past this many nonzeros the C++ builder (one sort and a linear walk) beats
# numpy's argsort and gathers; below it the ctypes round trip is not worth
# it (the JAX package's cut-off, tpuspmm/formats/tiles.py)
NATIVE_MIN_NNZ = 200_000


def build_tile_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    tile_m: int = 128,
    tile_k: int = 128,
    chunk: int = 128,
) -> TilePlan:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if len(rows) >= NATIVE_MIN_NNZ:
        from tpuspmm_torch import native
        from tpuspmm_torch.native import tileplan

        try:
            arrays = tileplan.build_tile_plan_arrays(
                rows, cols, vals, shape, tile_m, tile_k, chunk)
        except native.NativeUnavailable:
            native.plan_builds["numpy"] += 1
        else:
            native.plan_builds["native"] += 1
            return TilePlan(*arrays, shape=tuple(shape), tile_m=tile_m,
                            tile_k=tile_k, chunk=chunk)
    nrt = _cdiv(shape[0], tile_m)
    nkt = _cdiv(shape[1], tile_k)

    tile_r = rows // tile_m
    tile_k_ids = cols // tile_k
    # stable sort on the combined (tile_r, tile_k) key
    order = np.argsort(tile_r * nkt + tile_k_ids, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    tile_r, tile_k_ids = tile_r[order], tile_k_ids[order]

    group_key = tile_r * nkt + tile_k_ids
    if len(group_key):
        gb = np.flatnonzero(np.diff(group_key)) + 1
        starts = np.concatenate([[0], gb]).astype(np.int64)
        ends = np.concatenate([gb, [len(group_key)]]).astype(np.int64)
    else:
        starts = np.zeros(0, dtype=np.int64)
        ends = np.zeros(0, dtype=np.int64)

    # split each (row-tile, k-tile) group into fixed-size chunks
    g_sizes = ends - starts
    g_nchunks = -(-g_sizes // chunk) if len(g_sizes) else g_sizes
    n_data_chunks = int(g_nchunks.sum())
    chunk_group = np.repeat(np.arange(len(starts), dtype=np.int64), g_nchunks)
    within = (np.arange(n_data_chunks, dtype=np.int64)
              - np.repeat(np.cumsum(g_nchunks) - g_nchunks, g_nchunks))
    c_start = starts[chunk_group] + within * chunk
    c_end = np.minimum(c_start + chunk, ends[chunk_group])
    c_rt = (tile_r[starts[chunk_group]] if n_data_chunks
            else np.zeros(0, np.int64))
    c_kt = (tile_k_ids[starts[chunk_group]] if n_data_chunks
            else np.zeros(0, np.int64))

    # every row tile gets at least one chunk (zero-fill semantics)
    present = np.zeros(nrt, dtype=bool)
    present[c_rt] = True
    missing = np.flatnonzero(~present).astype(np.int64)
    if len(missing):
        c_rt = np.concatenate([c_rt, missing])
        c_kt = np.concatenate([c_kt, np.zeros(len(missing), np.int64)])
        c_start = np.concatenate([c_start, np.zeros(len(missing), np.int64)])
        c_end = np.concatenate([c_end, np.zeros(len(missing), np.int64)])

    # order chunks by row tile (stable: keeps k-tile order within)
    corder = np.argsort(c_rt, kind="stable")
    c_rt, c_kt = c_rt[corder], c_kt[corder]
    c_start, c_end = c_start[corder], c_end[corder]
    C = len(c_rt)
    E = chunk
    # chunk count padded to a multiple of 8 (the TPU's sublane tiling);
    # padding chunks are all-sentinel and attach to the last row tile
    C_pad = _cdiv(max(C, 1), 8) * 8

    out_rt = np.zeros(C_pad, dtype=np.int32)
    out_kt = np.zeros(C_pad, dtype=np.int32)
    out_first = np.zeros(C_pad, dtype=np.int32)
    out_rows = np.full((C_pad, E), -1, dtype=np.int32)
    out_cols = np.zeros((C_pad, E), dtype=np.int32)
    out_vals = np.zeros((C_pad, E), dtype=np.float32)

    out_rt[:C] = c_rt
    out_kt[:C] = c_kt
    if C:
        out_first[0] = 1
        out_first[1:C] = (c_rt[1:] != c_rt[:-1]).astype(np.int32)
    # scatter the payload: chunk ci takes triplets [c_start[ci], c_end[ci])
    lengths = c_end - c_start
    total = int(lengths.sum())
    if total:
        cum = np.cumsum(lengths)
        in_chunk = (np.arange(total, dtype=np.int64)
                    - np.repeat(cum - lengths, lengths))
        src = np.repeat(c_start, lengths) + in_chunk
        dst = np.repeat(np.arange(C_pad, dtype=np.int64)[: len(lengths)] * E,
                        lengths) + in_chunk
        rt_rep = np.repeat(c_rt, lengths)
        kt_rep = np.repeat(c_kt, lengths)
        out_rows.ravel()[dst] = (rows[src] - rt_rep * tile_m).astype(np.int32)
        out_cols.ravel()[dst] = (cols[src] - kt_rep * tile_k).astype(np.int32)
        out_vals.ravel()[dst] = vals[src]

    # padding chunks (C..C_pad) attach to the last row tile with kt 0 and
    # first 0; their sentinel rows contribute nothing
    if C_pad > C:
        out_rt[C:] = out_rt[C - 1] if C else 0

    return TilePlan(
        rt=out_rt, kt=out_kt, first=out_first,
        rows=out_rows, cols=out_cols, vals=out_vals,
        shape=tuple(shape), tile_m=tile_m, tile_k=tile_k, chunk=chunk,
    )


def plan_from_container(a, tile_m: int = 128, tile_k: int = 128,
                        chunk: int = 128) -> TilePlan:
    """The TilePlan of a container, from its COO triplets; built once and
    cached on the container."""
    from tpuspmm_torch.ops.xla import coo_view

    key = ("tile_plan", tile_m, tile_k, chunk)
    cache = container_cache(a)
    if key not in cache:
        coo = coo_view(a)
        cache[key] = build_tile_plan(
            np.asarray(coo.rows), np.asarray(coo.cols),
            np.asarray(coo.values), coo.shape, tile_m=tile_m,
            tile_k=tile_k, chunk=chunk)
    return cache[key]

