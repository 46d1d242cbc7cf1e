"""Host-side partitioning of the sparse operand: one rank's shard.

Counterpart of ``tpuspmm/parallel/shard.py``.  The JAX package builds every
shard's plan in one process and stacks them, padded to uniform counts, for
``shard_map``; here every rank holds the whole container A and builds only
its own shard, so nothing is stacked or padded.  The geometry rules are
JAX's, so each shard's arrays equal the unpadded part of JAX's stacked
slice for that shard:

- a row shard holds rows [s·m_local, (s + 1)·m_local) with
  ``m_local = round_up(cdiv(m, n_shards), tile_m or tm)``;
- a k bucket holds columns [b·k_local, (b + 1)·k_local) with
  ``k_local = round_up(cdiv(k, n_k_shards), tile_k or tk)``;
- a panel or pair plan stores bf16 values only when every shard's plan
  would (the stacked array is one dtype in JAX).  Row and column shards
  split A's entries by coordinate, so that holds exactly when the whole
  matrix's deduplicated values round-trip bf16, which every rank can
  decide alone, with no collective.

``RowShardedPlan`` wraps one rank's plan of a row shard (a ``TilePlan``,
``PanelPlan`` or ``PairPlan`` over the local (m_local, k) problem);
``KBucketedPlans`` one rank's plans of its row shard's k buckets (each
over (m_local, k_local)); ``KBucketedTriplets`` the same buckets as
triplets.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpuspmm_torch.formats.tiles import build_tile_plan
from tpuspmm_torch.kernels.common import cdiv, round_up


def coo_arrays(a):
    """(rows int64, cols int64, values float32, (m, k)) of a container."""
    from tpuspmm_torch.ops.xla import coo_view

    coo = coo_view(a)
    return (np.asarray(coo.rows, np.int64), np.asarray(coo.cols, np.int64),
            np.asarray(coo.values, np.float32), tuple(coo.shape))


def _plan_bf16(a) -> bool:
    """Whether the panel / pair plans of every shard of ``a`` store bf16
    (see the module docstring)."""
    from tpuspmm_torch.kernels.pair_spmm import plan_values_bf16_exact_cached

    rows, cols, vals, (_, k) = coo_arrays(a)
    return plan_values_bf16_exact_cached(a, rows, cols, vals, k)


def _as_f32_plan(plan):
    """A panel or pair plan with its bf16 bit patterns widened to float32
    (exact), as JAX's stacked plans are when any shard stores f32."""
    if plan.a_dense.dtype != np.uint16:
        return plan
    wide = (plan.a_dense.astype(np.uint32) << 16).view(np.float32)
    return dataclasses.replace(plan, a_dense=wide)


def _rows_of(rows, lo: int, hi: int):
    return (rows >= lo) & (rows < hi)


@dataclasses.dataclass(frozen=True)
class RowShardedPlan:
    """One rank's plan of row shard ``shard`` of ``n_shards``."""

    local: object           # TilePlan / PanelPlan / PairPlan, (m_local, k)
    shape: Tuple[int, int]  # global (M, K)
    n_shards: int
    shard: int
    m_local: int            # rows per shard (multiple of the strip height)


def shard_rows_tileplan(a, n_shards: int, shard: int, tile_m: int = 128,
                        tile_k: int = 128,
                        chunk: int = 128) -> RowShardedPlan:
    """The TilePlan of row shard ``shard``: rows shard-relative, over the
    (m_local, K) problem."""
    rows, cols, vals, (m, k) = coo_arrays(a)
    m_local = round_up(cdiv(m, n_shards), tile_m)
    lo = shard * m_local
    sel = _rows_of(rows, lo, lo + m_local)
    plan = build_tile_plan(rows[sel] - lo, cols[sel], vals[sel], (m_local, k),
                           tile_m=tile_m, tile_k=tile_k, chunk=chunk)
    return RowShardedPlan(plan, (m, k), n_shards, shard, m_local)


def shard_rows_tileplan_transposed(a, n_shards: int, shard: int,
                                   tile_m: int = 128, tile_k: int = 128,
                                   chunk: int = 128) -> RowShardedPlan:
    """The TilePlan of row shard ``shard``'s transpose: it computes
    ``A[lo:hi, :]ᵀ @ X`` for an (m_local, n) X, the backward of the
    row-sharded forward (dB = Σ_s A_sᵀ res_s).  Its plan is (K, m_local);
    ``m_local`` is a multiple of both tile sizes."""
    rows, cols, vals, (m, k) = coo_arrays(a)
    m_local = round_up(cdiv(m, n_shards), max(tile_m, tile_k))
    lo = shard * m_local
    sel = _rows_of(rows, lo, lo + m_local)
    plan = build_tile_plan(cols[sel], rows[sel] - lo, vals[sel], (k, m_local),
                           tile_m=tile_m, tile_k=tile_k, chunk=chunk)
    return RowShardedPlan(plan, (m, k), n_shards, shard, m_local)


def shard_rows_panelplan(a, n_shards: int, shard: int, tm: int = 8,
                         tk: int = 128, panel_strips: int = 16,
                         sm: int | None = None) -> RowShardedPlan:
    """The PanelPlan of row shard ``shard`` (``sm`` splits it into
    supertiles of sm rows, at most m_local)."""
    from tpuspmm_torch.kernels.panel_spmm import build_panel_plan

    rows, cols, vals, (m, k) = coo_arrays(a)
    m_local = round_up(cdiv(m, n_shards), tm)
    lo = shard * m_local
    sel = _rows_of(rows, lo, lo + m_local)
    plan = build_panel_plan(rows[sel] - lo, cols[sel], vals[sel],
                            (m_local, k), tm=tm, tk=tk,
                            panel_strips=panel_strips,
                            sm=None if sm is None else min(sm, m_local))
    if not _plan_bf16(a):
        plan = _as_f32_plan(plan)
    return RowShardedPlan(plan, (m, k), n_shards, shard, m_local)


def shard_rows_pairplan(a, n_shards: int, shard: int, tm: int = 8,
                        tk: int = 128, chunk_strips: int = 32,
                        sm: int | None = None) -> RowShardedPlan:
    """The PairPlan of row shard ``shard``."""
    from tpuspmm_torch.kernels.pair_spmm import build_pair_plan

    rows, cols, vals, (m, k) = coo_arrays(a)
    m_local = round_up(cdiv(m, n_shards), tm)
    lo = shard * m_local
    sel = _rows_of(rows, lo, lo + m_local)
    plan = build_pair_plan(rows[sel] - lo, cols[sel], vals[sel],
                           (m_local, k), tm=tm, tk=tk,
                           chunk_strips=chunk_strips,
                           sm=None if sm is None else min(sm, m_local))
    if not _plan_bf16(a):
        plan = _as_f32_plan(plan)
    return RowShardedPlan(plan, (m, k), n_shards, shard, m_local)


@dataclasses.dataclass(frozen=True)
class KBucketedTriplets:
    """Row shard ``row_shard``'s nonzeros bucketed by the k shard of B they
    touch: bucket b holds (rows, cols, vals) with rows shard-relative and
    cols bucket-relative, in A's COO order."""

    rows: tuple             # n_k_shards int32 arrays
    cols: tuple
    vals: tuple             # float32
    shape: Tuple[int, int]  # global (M, K)
    n_row_shards: int
    n_k_shards: int
    row_shard: int
    m_local: int
    k_local: int


def _bucket_bounds(m: int, k: int, n_row_shards: int, n_k_shards: int,
                   m_align: int, k_align: int) -> Tuple[int, int]:
    return (round_up(cdiv(m, n_row_shards), m_align),
            round_up(cdiv(k, n_k_shards), k_align))


def bucket_triplets(a, n_row_shards: int, n_k_shards: int, row_shard: int,
                    m_align: int = 8, k_align: int = 128) -> KBucketedTriplets:
    """Row shard ``row_shard``'s nonzeros by k bucket."""
    rows, cols, vals, (m, k) = coo_arrays(a)
    m_local, k_local = _bucket_bounds(m, k, n_row_shards, n_k_shards,
                                      m_align, k_align)
    lo = row_shard * m_local
    out = ([], [], [])
    sel_rows = _rows_of(rows, lo, lo + m_local)
    for b in range(n_k_shards):
        sel = sel_rows & (cols // k_local == b)
        out[0].append((rows[sel] - lo).astype(np.int32))
        out[1].append((cols[sel] - b * k_local).astype(np.int32))
        out[2].append(vals[sel])
    return KBucketedTriplets(*map(tuple, out), shape=(m, k),
                             n_row_shards=n_row_shards,
                             n_k_shards=n_k_shards, row_shard=row_shard,
                             m_local=m_local, k_local=k_local)


@dataclasses.dataclass(frozen=True)
class KBucketedPlans:
    """Row shard ``row_shard``'s plans, one per k bucket, each over the
    local (m_local, k_local) problem (rows shard-relative, cols
    bucket-relative): TilePlans, PanelPlans or PairPlans."""

    buckets: tuple
    shape: Tuple[int, int]  # global (M, K)
    n_row_shards: int
    n_k_shards: int
    row_shard: int
    m_local: int
    k_local: int


def _bucket_plans(a, n_row_shards, n_k_shards, row_shard, strip_rows: int,
                  k_tile: int, m_align: int, build) -> KBucketedPlans:
    rows, cols, vals, (m, k) = coo_arrays(a)
    m_local, k_local = _bucket_bounds(
        m, k, n_row_shards, n_k_shards,
        int(np.lcm(strip_rows, max(int(m_align), 1))), k_tile)
    lo = row_shard * m_local
    sel_rows = _rows_of(rows, lo, lo + m_local)
    plans = []
    for b in range(n_k_shards):
        sel = sel_rows & (cols // k_local == b)
        plans.append(build(rows[sel] - lo, cols[sel] - b * k_local,
                           vals[sel], (m_local, k_local)))
    return KBucketedPlans(tuple(plans), (m, k), n_row_shards, n_k_shards,
                          row_shard, m_local, k_local)


def bucket_tileplans(a, n_row_shards: int, n_k_shards: int, row_shard: int,
                     tile_m: int = 128, tile_k: int = 128, chunk: int = 128,
                     m_align: int = 1) -> KBucketedPlans:
    """A TilePlan per k bucket of row shard ``row_shard``.  ``m_align``
    also makes m_local a multiple of it (the reduce-scatter schedule needs
    m_local % n_dev == 0)."""
    return _bucket_plans(
        a, n_row_shards, n_k_shards, row_shard, tile_m, tile_k, m_align,
        lambda r, c, v, shape: build_tile_plan(r, c, v, shape, tile_m=tile_m,
                                               tile_k=tile_k, chunk=chunk))


def bucket_panelplans(a, n_row_shards: int, n_k_shards: int, row_shard: int,
                      tm: int = 8, tk: int = 128, panel_strips: int = 16,
                      sm: int | None = None,
                      m_align: int = 1) -> KBucketedPlans:
    """A PanelPlan per k bucket of row shard ``row_shard``."""
    from tpuspmm_torch.kernels.panel_spmm import build_panel_plan

    f32 = not _plan_bf16(a)

    def build(r, c, v, shape):
        plan = build_panel_plan(r, c, v, shape, tm=tm, tk=tk,
                                panel_strips=panel_strips,
                                sm=None if sm is None else min(sm, shape[0]))
        return _as_f32_plan(plan) if f32 else plan

    return _bucket_plans(a, n_row_shards, n_k_shards, row_shard, tm, tk,
                         m_align, build)


def bucket_pairplans(a, n_row_shards: int, n_k_shards: int, row_shard: int,
                     tm: int = 8, tk: int = 128, chunk_strips: int = 32,
                     sm: int | None = None,
                     m_align: int = 1) -> KBucketedPlans:
    """A PairPlan per k bucket of row shard ``row_shard``."""
    from tpuspmm_torch.kernels.pair_spmm import build_pair_plan

    f32 = not _plan_bf16(a)

    def build(r, c, v, shape):
        plan = build_pair_plan(r, c, v, shape, tm=tm, tk=tk,
                               chunk_strips=chunk_strips,
                               sm=None if sm is None else min(sm, shape[0]))
        return _as_f32_plan(plan) if f32 else plan

    return _bucket_plans(a, n_row_shards, n_k_shards, row_shard, tm, tk,
                         m_align, build)


def pad_dense_rows(b: torch.Tensor, k_pad: int) -> torch.Tensor:
    """B with its row (K) dimension zero-padded to ``k_pad``, on its own
    device; a bf16 B stays bf16 (the kernels take it), any other dtype
    becomes float32."""
    if b.dtype != torch.bfloat16:
        b = b.float()
    if b.shape[0] == k_pad:
        return b
    return torch.nn.functional.pad(b, (0, 0, 0, k_pad - b.shape[0]))
