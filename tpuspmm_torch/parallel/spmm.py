"""Distributed SpMM schedules over a ``DeviceMesh``.

Counterpart of ``tpuspmm/parallel/spmm.py``.  JAX runs each schedule as
one ``shard_map`` body from one process; here every rank runs the same
call with the whole container A and the whole B, builds only its own
shard's plan (cached on the container per mesh size, rank and geometry),
takes its own slice of B, and returns its own block of C: its rows, and
for ``spmm_2d`` (and the ring with ``cols_axis``) its column block.
:func:`gather_output` assembles the whole C.

The locals are the single-card entry points, which launch the hand
kernels on a CUDA tensor and run their plain versions on a CPU one:

- ``"xla"``: ``ops/xla.spmm_triplets``, gather and ``index_add_``;
- ``"tile"``: ``kernels/tile_spmm.spmm_tiles`` (K3), at "split";
- ``"panel"``: ``kernels/panel_spmm.spmm_panel`` (K1), at "highest";
- ``"pair"``: ``kernels/pair_spmm.spmm_pair`` (K2), at "highest".

Schedules:

- ``spmm_row_sharded``: A row-sharded over ``axis``, B whole; no
  collective.
- ``spmm_2d``: A row-sharded over "rows", B column-sharded over "cols";
  no collective.
- ``spmm_kshard``: A column-sharded, B's matching rows; each rank computes
  a full-height partial and ``reduce_scatter_tensor`` over ``axis`` sums
  the partials and leaves C row-sharded (JAX's ``psum_scatter``).
- ``spmm_ring``: A row-sharded and k-bucketed, B k-sharded.  At step i a
  rank holds panel ``(r - i) mod n`` and multiplies its bucket against
  it; the next panel's send to rank + 1 and receive from rank - 1 are
  posted (``batch_isend_irecv``) before that launch and waited for after
  it (JAX's ``ppermute`` overlapped with the compute).  At one rank
  nothing is sent.  Bucket outputs add up in float32 in JAX's order.

The VMEM admission of JAX's panel and pair locals has no counterpart: the
card's strip kernel keeps no output slab on chip, so a shard's plan is
one supertile unless the caller's plan says otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.kernels.common import cdiv, round_up
from tpuspmm_torch.parallel.mesh import axis_size, mesh_device
from tpuspmm_torch.parallel.shard import (
    KBucketedPlans,
    KBucketedTriplets,
    RowShardedPlan,
    bucket_pairplans,
    bucket_panelplans,
    bucket_tileplans,
    bucket_triplets,
    pad_dense_rows,
    shard_rows_pairplan,
    shard_rows_panelplan,
    shard_rows_tileplan,
)

LOCALS = ("xla", "tile", "panel", "pair")


def _check_local(local: str, schedule: str) -> None:
    if local not in LOCALS:
        raise ValueError(f"{schedule} local must be 'xla', 'tile', 'panel' "
                         f"or 'pair', got {local!r}")


def _cached_plan(a, key: tuple, build):
    """A rank's shard plan, built once and cached on the container."""
    cache = container_cache(a)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _operand(b, mesh) -> torch.Tensor:
    """B as a tensor on this rank's device: float32, or bfloat16 kept."""
    b = torch.as_tensor(b).to(mesh_device(mesh))
    return b if b.dtype == torch.bfloat16 else b.float()


def _tile_triplets(plan, device):
    """A tile plan's chunks as global triplets (rows -1 for padding), on
    ``device``: the gather path JAX's "xla" local runs over its plan."""
    def build():
        rows = np.where(plan.rows < 0, -1,
                        plan.rows + plan.rt[:, None] * plan.tile_m)
        cols = plan.cols + plan.kt[:, None] * plan.tile_k
        return {"rows": rows.reshape(-1).astype(np.int32),
                "cols": cols.reshape(-1).astype(np.int32),
                "vals": plan.vals.reshape(-1)}

    return plan.device_arrays(device, "triplets", build)


def run_local(local: str, plan, b: torch.Tensor) -> torch.Tensor:
    """One shard's product: (plan rows, B's width), float32."""
    if local == "xla":
        from tpuspmm_torch.ops.xla import spmm_triplets

        t = _tile_triplets(plan, b.device)
        return spmm_triplets(t["rows"], t["cols"], t["vals"], b,
                             plan.shape[0])
    if local == "tile":
        from tpuspmm_torch.kernels.tile_spmm import spmm_tiles

        return spmm_tiles(plan, b)
    if local == "panel":
        from tpuspmm_torch.kernels.panel_spmm import spmm_panel

        return spmm_panel(plan, b)
    from tpuspmm_torch.kernels.pair_spmm import spmm_pair

    return spmm_pair(plan, b)


def _bucket_triplets_on(buckets: KBucketedTriplets, s: int, device):
    cache = buckets.__dict__.setdefault("_device", {})
    key = (s, str(device))
    if key not in cache:
        cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            device) for x in (buckets.rows[s], buckets.cols[s],
                              buckets.vals[s]))
    return cache[key]


def run_bucket(local: str, src, s: int, b: torch.Tensor) -> torch.Tensor:
    """Bucket ``s``'s product against its B panel: (m_local, width)."""
    if local == "xla":
        from tpuspmm_torch.ops.xla import spmm_triplets

        rows, cols, vals = _bucket_triplets_on(src, s, b.device)
        return spmm_triplets(rows, cols, vals, b, src.m_local)
    return run_local(local, src.buckets[s], b)


def _row_plan(a, local: str, n_shards: int, shard: int) -> RowShardedPlan:
    """This rank's row-shard plan for ``local`` at JAX's default
    geometry (xla reads the tile plan, as JAX's does)."""
    if local == "panel":
        return _cached_plan(a, ("panel_shard", n_shards, shard),
                            lambda: shard_rows_panelplan(a, n_shards, shard))
    if local == "pair":
        return _cached_plan(a, ("pair_shard", n_shards, shard),
                            lambda: shard_rows_pairplan(a, n_shards, shard))
    return _cached_plan(a, ("tile_shard", n_shards, shard),
                        lambda: shard_rows_tileplan(a, n_shards, shard))


def _check_shard(plan: RowShardedPlan, n_shards: int, shard: int) -> None:
    if plan.n_shards != n_shards or plan.shard != shard:
        raise ValueError(
            f"plan is shard {plan.shard} of {plan.n_shards}; this rank "
            f"computes shard {shard} of {n_shards}")


def _col_block(n: int, n_cols: int, j: int, align: int):
    """Columns [c0, c1) of column block j of ``n_cols``: JAX's padded
    width per device (a multiple of ``align``), cut at n."""
    n_local = round_up(cdiv(n, n_cols), align)
    c0 = min(j * n_local, n)
    return c0, min(c0 + n_local, n)


def _block_rows(m: int, shard: int, rows: int) -> int:
    """Rows of C in block ``shard`` of ``rows`` rows each."""
    lo = min(shard * rows, m)
    return min(lo + rows, m) - lo


# ---------------------------------------------------------------------------
# row-sharded and 2-D: no collective
# ---------------------------------------------------------------------------

def spmm_row_sharded(a, b, mesh, axis: str = "rows", local: str = "tile",
                     plan: Optional[RowShardedPlan] = None) -> torch.Tensor:
    """This rank's rows of C = A @ B, A row-sharded over ``axis``, B whole.

    ``plan`` is this rank's :class:`RowShardedPlan` (``shard_rows_*`` with
    this rank's index); by default the plan of ``local`` at JAX's
    geometry."""
    _check_local(local, "spmm_row_sharded")
    n_dev, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    plan = plan or _row_plan(a, local, n_dev, r)
    _check_shard(plan, n_dev, r)
    out = run_local(local, plan.local, _operand(b, mesh))
    return out[:_block_rows(plan.shape[0], r, plan.m_local)]


def spmm_2d(a, b, mesh, plan: Optional[RowShardedPlan] = None,
            local: str = "tile") -> torch.Tensor:
    """This rank's block of C = A @ B on a ("rows", "cols") mesh: A
    row-sharded over "rows", B column-sharded over "cols" (blocks of
    round_up(cdiv(N, n_cols), 128) columns; a block past N is empty)."""
    _check_local(local, "spmm_2d")
    n_rows, r = axis_size(mesh, "rows"), mesh.get_local_rank("rows")
    n_cols, j = axis_size(mesh, "cols"), mesh.get_local_rank("cols")
    plan = plan or _row_plan(a, local, n_rows, r)
    _check_shard(plan, n_rows, r)
    b = _operand(b, mesh)
    c0, c1 = _col_block(int(b.shape[1]), n_cols, j, 128)
    rows = _block_rows(plan.shape[0], r, plan.m_local)
    if c0 == c1:
        return torch.zeros(rows, 0, dtype=torch.float32, device=b.device)
    return run_local(local, plan.local, b[:, c0:c1].contiguous())[:rows]


# ---------------------------------------------------------------------------
# k-sharded: full-height partials, reduce-scattered
# ---------------------------------------------------------------------------

def _refuse_buckets(schedule: str, local: str, builder: str, buckets):
    if local != "xla" and buckets is not None:
        raise ValueError(
            f"{schedule}(local={local!r}) takes prebuilt "
            f"{local.upper()} plans via plans= ({builder}), not triplet "
            "buckets=; the buckets would be silently rebuilt otherwise")


_BUCKET_BUILDERS = {"tile": bucket_tileplans, "panel": bucket_panelplans,
                    "pair": bucket_pairplans}


def _k_slab(b: torch.Tensor, s: int, k_local: int) -> torch.Tensor:
    """Rows [s·k_local, (s + 1)·k_local) of B, zero-padded to k_local."""
    k = int(b.shape[0])
    slab = b[min(s * k_local, k):min((s + 1) * k_local, k)]
    return pad_dense_rows(slab, k_local).contiguous()


def spmm_kshard(a, b, mesh, axis: str = "rows",
                buckets: Optional[KBucketedTriplets] = None,
                local: str = "xla",
                plans: Optional[KBucketedPlans] = None) -> torch.Tensor:
    """This rank's rows of C = A @ B with the contraction sharded: rank r
    owns A's k bucket r and B's matching rows, computes a full-height
    partial, and ``reduce_scatter_tensor`` over ``axis`` sums the
    partials and leaves C row-sharded (m_pad / n rows a rank).

    ``local="xla"`` takes prebuilt triplet ``buckets``
    (``bucket_triplets(a, 1, n, 0, m_align=8·n)``); the others take
    ``plans`` (``bucket_{tile,panel,pair}plans(a, 1, n, 0,
    m_align=n)``)."""
    _check_local(local, "spmm_kshard")
    n_dev, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if local == "xla":
        src = buckets or _cached_plan(
            a, ("kshard_triplets", n_dev),
            lambda: bucket_triplets(a, 1, n_dev, 0, m_align=8 * n_dev))
        builder, align = "bucket_triplets", 8 * n_dev
    else:
        builder = _BUCKET_BUILDERS[local].__name__
        _refuse_buckets("spmm_kshard", local, builder, buckets)
        src = plans or _cached_plan(
            a, ("kshard", local, n_dev),
            lambda: _BUCKET_BUILDERS[local](a, 1, n_dev, 0, m_align=n_dev))
        align = n_dev
    if src.n_row_shards != 1 or src.n_k_shards != n_dev:
        raise ValueError(
            f"spmm_kshard needs K-bucketed {'triplets' if local == 'xla' else 'plans'} "
            f"(n_row_shards == 1, n_k_shards == {n_dev}), got "
            f"({src.n_row_shards}, {src.n_k_shards}); rebuild with "
            f"{builder}(a, 1, {n_dev}, 0)")
    if src.m_local % n_dev != 0:
        raise ValueError(
            f"m_local={src.m_local} not divisible by mesh axis size "
            f"{n_dev}; rebuild with {builder}(..., m_align={align})")
    b = _operand(b, mesh)
    partial = run_bucket(local, src, r, _k_slab(b, r, src.k_local))
    out = torch.empty(src.m_local // n_dev, partial.shape[1],
                      dtype=partial.dtype, device=partial.device)
    dist.reduce_scatter_tensor(out, partial, group=mesh.get_group(axis))
    return out[:_block_rows(src.shape[0], r, src.m_local // n_dev)]


# ---------------------------------------------------------------------------
# ring: B k-sharded, panels passed around the mesh axis
# ---------------------------------------------------------------------------

def spmm_ring(a, b, mesh, axis: str = "rows",
              cols_axis: Optional[str] = None,
              buckets: Optional[KBucketedTriplets] = None,
              local: str = "xla",
              plans: Optional[KBucketedPlans] = None) -> torch.Tensor:
    """This rank's block of C = A @ B with B sharded along K; the panels
    pass around the ``axis`` ring.

    Rank r starts with panel r.  At step i it holds panel
    ``s = (r - i) mod n`` and multiplies its row shard's bucket s against
    it, while the panel goes on to rank r + 1 and the next comes from
    r - 1.  After n steps every bucket has met its panel.  With
    ``cols_axis``, B and C are also column-sharded over it and the ring
    runs inside each column group (blocks of cdiv(N, n_cols) columns for
    "xla", rounded up to 128 for the kernels, as in JAX).

    ``local="xla"`` takes prebuilt ``buckets`` (``bucket_triplets(a, n,
    n, r)``), the others ``plans`` (``bucket_*plans(a, n, n, r)``)."""
    _check_local(local, "spmm_ring")
    n_dev, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if local == "xla":
        src = buckets or _cached_plan(
            a, ("ring_triplets", n_dev, r),
            lambda: bucket_triplets(a, n_dev, n_dev, r))
    else:
        _refuse_buckets("spmm_ring", local,
                        _BUCKET_BUILDERS[local].__name__, buckets)
        src = plans or _cached_plan(
            a, ("ring", local, n_dev, r),
            lambda: _BUCKET_BUILDERS[local](a, n_dev, n_dev, r))
    if (src.n_row_shards, src.n_k_shards, src.row_shard) != (n_dev, n_dev,
                                                               r):
        raise ValueError(
            f"spmm_ring needs row shard {r}'s buckets of a ({n_dev}, "
            f"{n_dev}) bucketing, got row shard {src.row_shard} of "
            f"({src.n_row_shards}, {src.n_k_shards})")
    b = _operand(b, mesh)
    n = int(b.shape[1])
    c0, c1 = 0, n
    if cols_axis is not None:
        c0, c1 = _col_block(n, axis_size(mesh, cols_axis),
                            mesh.get_local_rank(cols_axis),
                            1 if local == "xla" else 128)
    rows = _block_rows(src.shape[0], r, src.m_local)
    if c0 == c1:
        return torch.zeros(rows, 0, dtype=torch.float32, device=b.device)
    # buffers of the ring's own (a panel can be a view of B, and received
    # panels are written into both in turn)
    panel = _k_slab(b, r, src.k_local)[:, c0:c1].clone()
    spare = torch.empty_like(panel)
    acc = torch.zeros(src.m_local, c1 - c0, dtype=torch.float32,
                      device=b.device)
    group = mesh.get_group(axis)
    nxt = dist.get_global_rank(group, (r + 1) % n_dev)
    prv = dist.get_global_rank(group, (r - 1) % n_dev)
    for i in range(n_dev):
        pending = []
        if i + 1 < n_dev:  # the last panel goes nowhere
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, panel, nxt, group),
                dist.P2POp(dist.irecv, spare, prv, group)])
        acc += run_bucket(local, src, (r - i) % n_dev, panel)
        for req in pending:
            req.wait()
        if pending:
            panel, spare = spare, panel
    return acc[:rows]


# ---------------------------------------------------------------------------
# the whole C
# ---------------------------------------------------------------------------

def gather_output(c_local: torch.Tensor, mesh, rows_axis: str = "rows",
                  cols_axis: Optional[str] = None) -> torch.Tensor:
    """The whole C on every rank, from each rank's block: row blocks in
    ``rows_axis`` order, column blocks (with ``cols_axis``, as
    ``spmm_2d`` and the ring with ``cols_axis`` return them) in its
    order; ranks that differ only along another mesh axis hold the same
    block, and the one at coordinate 0 there is taken."""
    world = dist.get_world_size()
    c_local = c_local.float().contiguous()
    shape = torch.tensor(c_local.shape, dtype=torch.int64,
                         device=c_local.device)
    shapes = [torch.empty_like(shape) for _ in range(world)]
    dist.all_gather(shapes, shape)
    shapes = [tuple(int(v) for v in s.tolist()) for s in shapes]
    height = max(s[0] for s in shapes)
    width = max(s[1] for s in shapes)
    padded = torch.nn.functional.pad(
        c_local, (0, width - c_local.shape[1], 0, height - c_local.shape[0]))
    blocks = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(blocks, padded)

    names = mesh.mesh_dim_names
    grid = mesh.mesh
    rows_dim = names.index(rows_axis)
    cols_dim = None if cols_axis is None else names.index(cols_axis)
    out = []
    for i in range(grid.shape[rows_dim]):
        row = []
        for j in range(1 if cols_dim is None else grid.shape[cols_dim]):
            at = [0] * grid.dim()
            at[rows_dim] = i
            if cols_dim is not None:
                at[cols_dim] = j
            rank = int(grid[tuple(at)])
            h, w = shapes[rank]
            row.append(blocks[rank][:h, :w])
        out.append(torch.cat(row, dim=1))
    return torch.cat(out, dim=0)
