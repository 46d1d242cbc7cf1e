"""C-resident SpMM over the k-major tile plan (kernels K5a and K5b).

Counterpart of ``tpuspmm/kernels/cres_spmm.py``.  The TPU kernels keep the
whole output in VMEM and stream the chunks k-major, so each B panel is
fetched once:

- block8 (K5a): chunks padded per k tile to multiples of 8 with rt -1
  sentinel chunks; one grid step per 8-chunk block shares one B panel;
- kloop (K5b): one grid step per k tile, looping over exactly that tile's
  chunks (no sentinels); the split tiers only.

On the card (``csrc/chunk_spmm.cu``, C entry ``cres_cluster_spmm``,
entered as ``cres_chunk_spmm`` and ``cres_kloop_chunk_spmm``) nothing
carries over between blocks, so each output tile has one owner block that
keeps its sums in registers and stores once; C lives in device memory,
written once.  Both k-major layouts list each row tile's chunks in
ascending k tile, the row-major plan's order, so the owners read K3's tile
index (:func:`tile_spmm.index_arrays`).  K5's own mechanism, one read of a
k tile's B panel serving the chunks of many row tiles, is the launch: the
owners of CLUSTER consecutive row tiles (``chunk_cuda.CLUSTER``) of one
column tile form a thread-block cluster, walk the ascending union of their
dense k tiles (:func:`cluster_schedule`, built once per plan) and take
each KC-row chunk of a panel from one multicast bulk copy, issued once for
the cluster; a chunk a bulk copy cannot move (B rows not 16-byte aligned,
rows past K or columns past N) each member with a tile there stages
itself.  Each member still runs its own dense tiles in ascending k tile
and then the gather, K3's sum order, so K5a, K5b and K3 give the same
bits; at "split2" the index has no dense tile and the launch gathers
only.  The k-major layouts serve the plain versions, which walk them in
the TPU's grid order.

**Admission on the card** (a planning rule, kept from the first port so
that every route stays as it was).  It reads what must be resident as one
owner's accumulator, tile_m × COLUMN_TILE × 4 bytes of shared memory (32
KiB at tile_m = 128, COLUMN_TILE = 64), not the whole C: every output size
is admitted while that fits the
card's opt-in shared memory per block.  The JAX package's ``fits_vmem_out``
/ ``fits_vmem_loop`` (C plus panels, or C plus the whole payload, within
8 / 13 MiB of the TPU's VMEM) admit far fewer matrices; the engine's records
carry the card's rule.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuspmm_torch.formats.tiles import TilePlan, plan_from_container
from tpuspmm_torch.kernels import chunk_cuda
from tpuspmm_torch.kernels.csr_vmem import COLUMN_TILE, smem_optin
from tpuspmm_torch.kernels.tile_spmm import (check_mode, check_operand,
                                             dense_min, host_index,
                                             index_arrays, walk_plain)

SCHEDULES = ("auto", "block8", "kloop")


def fits_card_out(tile_m: int, device) -> bool:
    """The card's C-resident rule: one owner's (tile_m × TN) f32
    accumulator fits the opt-in shared memory of a block on ``device``."""
    return tile_m * COLUMN_TILE * 4 <= smem_optin(device)


def _kmajor_order(plan: TilePlan):
    order = np.lexsort((plan.rt, plan.kt))
    return (plan.rt[order], plan.kt[order], plan.rows[order],
            plan.cols[order], plan.vals[order])


def _kmajor_loop(plan: TilePlan) -> dict:
    """Chunk payloads sorted k-major with per-k-tile [start, end) chunk
    ranges, no sentinel padding (numpy; cached on the plan)."""
    def build():
        rt, kt, rows, cols, vals = _kmajor_order(plan)
        bounds = np.searchsorted(kt, np.arange(plan.num_k_tiles + 1)).astype(
            np.int32)
        return {"start": bounds[:-1], "end": bounds[1:],
                "rt": rt.astype(np.int32), "rows": rows, "cols": cols,
                "vals": vals}

    return plan.derived("kmajor_loop", build)


def _kmajor_blocks(plan: TilePlan) -> dict:
    """Chunk payloads sorted k-major and padded per k-tile group to
    multiples of 8 with rt -1 sentinel chunks; kt8 per 8-chunk block
    (numpy; cached on the plan).  An empty plan is one all-sentinel
    block."""
    def build():
        C, E = plan.num_chunks, plan.chunk
        rt, kt, rows, cols, vals = _kmajor_order(plan)
        gb = np.flatnonzero(np.diff(kt)) + 1
        starts = np.concatenate([[0], gb]) if C else np.zeros(0, np.int64)
        ends = np.concatenate([gb, [C]]) if C else np.zeros(0, np.int64)
        o_rt, o_rows, o_cols, o_vals, kt8 = [], [], [], [], []
        for s, e in zip(starts, ends):
            n = int(e - s)
            pad = (-n) % 8
            o_rt.append(rt[s:e])
            o_rows.append(rows[s:e])
            o_cols.append(cols[s:e])
            o_vals.append(vals[s:e])
            if pad:
                o_rt.append(np.full(pad, -1, np.int32))
                o_rows.append(np.full((pad, E), -1, np.int32))
                o_cols.append(np.zeros((pad, E), np.int32))
                o_vals.append(np.zeros((pad, E), np.float32))
            kt8.extend([int(kt[s])] * ((n + pad) // 8))
        if not kt8:
            o_rt = [np.full(8, -1, np.int32)]
            o_rows = [np.full((8, E), -1, np.int32)]
            o_cols = [np.zeros((8, E), np.int32)]
            o_vals = [np.zeros((8, E), np.float32)]
            kt8 = [0]
        return {"rt8": np.concatenate(o_rt),
                "kt8": np.asarray(kt8, np.int32),
                "rows": np.concatenate(o_rows),
                "cols": np.concatenate(o_cols),
                "vals": np.concatenate(o_vals)}

    return plan.derived("kmajor_blocks", build)


def _block8_layout(plan: TilePlan) -> dict:
    """The block8 layout with kt per chunk (each block's kt8)."""
    blk = _kmajor_blocks(plan)
    return {"rt": blk["rt8"], "kt": np.repeat(blk["kt8"], 8),
            "rows": blk["rows"], "cols": blk["cols"], "vals": blk["vals"]}


def _kloop_layout(plan: TilePlan) -> dict:
    """The kloop layout with kt per chunk (from its k-tile ranges)."""
    lp = _kmajor_loop(plan)
    kt = np.repeat(np.arange(plan.num_k_tiles, dtype=np.int32),
                   lp["end"] - lp["start"])
    return {"rt": lp["rt"], "kt": kt, "rows": lp["rows"],
            "cols": lp["cols"], "vals": lp["vals"]}


_LAYOUTS = {"block8": _block8_layout, "kloop": _kloop_layout}


def cres_spmm_plain(plan: TilePlan, b: torch.Tensor, mode: str = "split",
                    schedule: str = "block8") -> torch.Tensor:
    """Plain version of K5a ("block8") or K5b ("kloop") on b's device: the
    k-major layout walked in its order (the TPU's grid order) into a zeroed
    C, sentinel chunks dropped."""
    arrs = plan.device_arrays(b.device, ("cres_plain", schedule),
                              lambda: _LAYOUTS[schedule](plan))
    out = walk_plain(arrs["rt"], arrs["kt"].long() * plan.tile_k,
                     arrs["rows"], arrs["cols"], arrs["vals"], b,
                     plan.padded_shape[0], plan.tile_m, plan.tile_k, mode)
    return out[:plan.shape[0]]


def build_cluster_schedule(index: dict, num_row_tiles: int,
                           cluster: int) -> dict:
    """The cluster launch's schedule (numpy) of a tile index
    (:func:`tile_spmm.build_tile_index`): row tiles grouped ``cluster`` at
    a time, consecutively, the last group padded with members of row tile
    -1 (``c_rt``, (clusters, cluster)); per cluster the ascending union of
    its members' dense k tiles, its steps (``s_kt``, ranges ``c_ptr``);
    per (step, member) that member's dense tile, or -1 (``s_tile``,
    (steps, cluster)); the clusters by nonzeros, most first (``c_order``,
    stable).  For records: ``shared_steps``, the steps two or more members
    share."""
    nrt = num_row_tiles
    clusters = max(1, -(-nrt // cluster))
    c_rt = np.full(clusters * cluster, -1, np.int32)
    c_rt[:nrt] = np.arange(nrt)
    d_ptr, d_kt = index["d_ptr"], index["d_kt"].astype(np.int64)
    t_rt = np.repeat(np.arange(nrt), np.diff(d_ptr))  # row tile of a tile
    kts = int(d_kt.max(initial=0)) + 1
    # the steps: distinct (cluster, k-tile) pairs, in ascending order
    keys, t_step = np.unique(t_rt // cluster * kts + d_kt,
                             return_inverse=True)
    s_tile = np.full((len(keys), cluster), -1, np.int32)
    s_tile[t_step, t_rt % cluster] = np.arange(len(d_kt))
    work = np.bincount(index["tile_rt"], weights=index["tile_nnz"],
                       minlength=nrt)
    c_work = np.bincount(np.arange(nrt) // cluster, weights=work,
                         minlength=clusters)
    return {
        "c_rt": c_rt.reshape(clusters, cluster),
        "c_ptr": np.searchsorted(keys // kts, np.arange(clusters + 1)).astype(
            np.int32),
        "s_kt": (keys % kts).astype(np.int32), "s_tile": s_tile,
        "c_order": np.argsort(-c_work, kind="stable").astype(np.int32),
        "cluster": cluster, "clusters": clusters,
        "shared_steps": int(((s_tile >= 0).sum(axis=1) >= 2).sum()),
    }


def cluster_schedule(plan: TilePlan, min_dense: float,
                     cluster: int | None = None) -> dict:
    """The cluster schedule of ``plan``'s tile index at ``min_dense``, for
    clusters of ``cluster`` row tiles (``chunk_cuda.CLUSTER`` by default),
    built once and cached on the plan."""
    cluster = cluster or chunk_cuda.CLUSTER
    return plan.derived(("cluster_schedule", min_dense, cluster),
                        lambda: build_cluster_schedule(
                            host_index(plan, min_dense), plan.num_row_tiles,
                            cluster))


def schedule_arrays(plan: TilePlan, device, min_dense: float,
                    cluster: int | None = None) -> dict:
    """The cluster schedule's device arrays (``chunk_cuda.CLUSTER_INDEX``),
    transferred once per plan, threshold, cluster size and device."""
    cluster = cluster or chunk_cuda.CLUSTER
    return plan.device_arrays(
        device, ("cluster_schedule", min_dense, cluster),
        lambda: {k: cluster_schedule(plan, min_dense, cluster)[k]
                 for k in chunk_cuda.CLUSTER_INDEX})


def b_traffic(plan: TilePlan, b: torch.Tensor, min_dense: float, sms: int,
              cluster: int | None = None) -> dict:
    """What the dense path moves of B in one launch on ``b``, reckoned from
    the tile index and the cluster schedule: the KC-row chunks of B panels
    staged by the owner routine (each dense tile's, for each column tile)
    and by the cluster launch (a chunk that lies inside B once for the
    cluster, by multicast, where B's rows are 16-byte aligned; else once
    for each member with a tile at the step), the multicast issues among
    them, the bytes of B each reads (rows < K, columns < N), and which copy
    stages B (``b_copy``)."""
    index = host_index(plan, min_dense)
    sched = cluster_schedule(plan, min_dense, cluster)
    k, n = int(b.shape[0]), int(b.shape[1])
    esize = b.element_size()
    tn = chunk_cuda.column_tile(plan.num_row_tiles, n, sms)
    bulk = b.data_ptr() % 16 == 0 and n * esize % 16 == 0
    kc = np.arange(0, plan.tile_k, chunk_cuda.KC)
    c0 = np.arange(0, n, tn)
    cols = np.minimum(tn, n - c0)  # each column tile's columns in B

    def rows(kts):
        """(k-tiles, chunks): each chunk's rows inside B."""
        r0 = np.asarray(kts, np.int64)[:, None] * plan.tile_k + kc
        return np.clip(k - r0, 0, chunk_cuda.KC)

    own, st = rows(index["d_kt"]), rows(sched["s_kt"])
    multicast = bulk & (st == chunk_cuda.KC)[..., None] & (c0 + tn <= n)
    members = (sched["s_tile"] >= 0).sum(axis=1)
    times = np.where(multicast, 1, members[:, None, None])
    issues = int(multicast.sum())
    copy = ("none (no dense tile)" if not own.size
            else "member plain loads (B rows not 16-byte aligned)"
            if not bulk else "multicast" if issues == times.sum()
            else "multicast, edge chunks by member cp.async")
    return {"cluster": sched["cluster"], "clusters": sched["clusters"],
            "shared_steps": sched["shared_steps"], "column_tile": tn,
            "b_copy": copy, "multicast_issues": issues,
            "owner_stagings": int(own.size * len(c0)),
            "cluster_stagings": int(times.sum()),
            "b_panel_bytes": {
                "owner": int(own.sum()) * int(cols.sum()) * esize,
                "cluster": int((st[..., None] * cols * times).sum())
                * esize}}


def _validated(plan: TilePlan, b: torch.Tensor, mode: str,
               schedule: str) -> tuple:
    """The entry's checks of a call: the tier, the schedule ("auto" is
    block8), kloop's tiers, B against the plan and the card's C-resident
    rule; (split2, schedule)."""
    split2 = check_mode(mode)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    if schedule == "auto":
        schedule = "block8"
    if schedule == "kloop" and mode not in ("split", "split2"):
        # the TPU's kloop kernel implements the bf16 split tiers only
        raise ValueError(
            f"schedule='kloop' supports mode 'split'/'split2', not "
            f"{mode!r}; use schedule='block8'")
    check_operand(plan, b)
    if not fits_card_out(plan.tile_m, b.device):
        raise ValueError(
            f"a ({plan.tile_m} x {COLUMN_TILE}) f32 accumulator exceeds the "
            "shared memory of a block; use spmm_tiles")
    return split2, schedule


def cres_launch(plan: TilePlan, b: torch.Tensor, mode: str = "split",
                schedule: str = "auto", *,
                issues: torch.Tensor | None = None):
    """:func:`spmm_cres`' launch on the card for B of b's shape, dtype and
    device (contiguous): the cluster kernel bound to the plan's tile index
    and cluster schedule as ``cres_chunk_spmm`` (block8) or
    ``cres_kloop_chunk_spmm`` (kloop) (``chunk_cuda.bind``), once, and
    cached on the plan; ``launch(b)`` is C.  With ``issues`` (one int32
    on b's device, counting its multicast B chunks) the binding is built
    for that counter and not cached."""
    split2, schedule = _validated(plan, b, mode, schedule)
    entry, counter = (("cres_chunk_spmm", spmm_cres) if schedule == "block8"
                      else ("cres_kloop_chunk_spmm", spmm_cres_kloop))

    def build():
        min_dense = dense_min(plan.tile_k, split2)
        return chunk_cuda.bind(
            entry, index_arrays(plan, b.device, min_dense), b,
            plan.shape[0], plan.tile_m, plan.tile_k, split2,
            sched=schedule_arrays(plan, b.device, min_dense), issues=issues,
            counter=counter)

    if issues is not None:
        return build()
    return plan.derived(("launch", entry, int(b.shape[1]), b.dtype,
                         b.device, split2), build)


def spmm_cres(a_or_plan, b: torch.Tensor, mode: str = "split",
              schedule: str = "auto", *,
              issues: torch.Tensor | None = None) -> torch.Tensor:
    """Container- or plan-level entry of the C-resident kernels.

    ``schedule``: "block8" (K5a, all tiers), "kloop" (K5b, "split" and
    "split2" only, as in the JAX package), or "auto" (block8, as there).
    On a CUDA tensor it launches the cluster kernel as ``cres_chunk_spmm``
    / ``cres_kloop_chunk_spmm`` (:func:`cres_launch`) or raises;
    ``issues`` (one int32 on b's device, or None) counts its multicast B
    chunks.  On a CPU tensor it runs :func:`cres_spmm_plain`."""
    plan = (a_or_plan if isinstance(a_or_plan, TilePlan)
            else plan_from_container(a_or_plan))
    _, schedule = _validated(plan, b, mode, schedule)
    if b.device.type == "cpu":
        return cres_spmm_plain(plan, b, mode, schedule)
    b = b.contiguous()
    return cres_launch(plan, b, mode, schedule, issues=issues)(b)


def spmm_cres_kloop(a_or_plan, b: torch.Tensor, mode: str = "split", *,
                    issues: torch.Tensor | None = None) -> torch.Tensor:
    """K5b's own entry: :func:`spmm_cres` with ``schedule="kloop"``.  Its
    ``launches`` counts the kloop kernel's launches through either."""
    return spmm_cres(a_or_plan, b, mode=mode, schedule="kloop",
                     issues=issues)


spmm_cres.launches = 0
spmm_cres_kloop.launches = 0


def residency(plan: TilePlan, device) -> dict:
    """The C-resident rule's outcome for a record."""
    return {"rule": "one owner's accumulator in opt-in shared memory",
            "smem_optin_bytes": smem_optin(device),
            "accumulator_bytes": plan.tile_m * COLUMN_TILE * 4}
