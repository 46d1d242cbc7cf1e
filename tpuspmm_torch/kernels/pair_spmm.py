"""Run-length panel SpMM: zero stored-plan padding (kernel K2).

Counterpart of ``tpuspmm/kernels/pair_spmm.py``.  Strips are grouped per
(supertile, k-tile) pair as in the panel plan, but each pair's exact strip
run is stored with no padding; the TPU kernel chops the runs into CH-strip
chunks at arbitrary strip offsets and masks the strips a chunk reads past
its pair:

    for each chunk q (CH strips from cstart[q]):
        for each strip i < ccount[q]:
            C[st·sm + offs[cstart+i] : +tm, :] += A_strip @ B[ckt[q]·tk : +tk]

On the card the pair layout is served by the strip-owner kernel
(``csrc/strip_spmm.cu``, entry ``pair_strip_spmm``) through a CSR index
over the output strips derived from kt, start, count and offs
(:meth:`PairPlan.strip_index`) and the group index over it
(:meth:`PairPlan.group_index`), as the panel layout is.  On a CPU tensor
the wrapper runs the plain version, :func:`pair_spmm_plain`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.kernels.common import pad_b, round_up
from tpuspmm_torch.kernels.panel_spmm import (
    ORDER_KINDS,
    PLAIN_BATCH_BYTES,
    GROUP_ROWS,
    PLAN_BYTES_CAP,
    _bf16_bits,
    _dedupe_triplets,
    _device_cache,
    _occupied_strip_groups,
    _order_candidates,
    _order_perm,
    _st_strip_counts_from_groups,
    b_value_bytes,
    cached_group_index,
    check_operand,
    finish_panel_output,
    geom_disk_load,
    geom_disk_store,
    group_arrays,
    normalize_panel_mode,
    search_constants,
    panel_matmul,
    plan_tensor,
    plan_values_bf16_exact,
    slab_rows,
    strip_launch,
    strip_owner_index,
    values_bf16_exact,
)

# default strips per chunk when the caller pins none in a direct plan build
CHUNK_STRIPS = 32


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """Run-length panel plan: strips grouped per (supertile, k-tile) pair
    with no padding."""

    kt: np.ndarray      # (n_pairs,) int32 — k-tile id
    st: np.ndarray      # (n_pairs,) int32 — supertile id (ascending;
    #                     every supertile appears, possibly count=0)
    start: np.ndarray   # (n_pairs,) int32 — first strip index
    count: np.ndarray   # (n_pairs,) int32 — strips in this pair
    offs: np.ndarray    # (n_strips + CH,) int32 — supertile-local C row
    #                     offset per strip; the CH-strip tail holds sm
    a_dense: np.ndarray  # ((n_strips + CH)·tm, tk) — stacked strips, f32 or
    #                     uint16 bf16 bits (lossless store; CH zero tail)

    shape: Tuple[int, int]
    tm: int
    tk: int
    chunk_strips: int   # CH
    sm: int             # supertile rows; m_pad for one supertile
    row_perm: np.ndarray | None = None

    @property
    def n_pairs(self) -> int:
        return int(self.kt.shape[0])

    @property
    def n_strips(self) -> int:
        return int(self.offs.shape[0]) - self.chunk_strips

    @property
    def m_pad(self) -> int:
        return round_up(self.shape[0], self.tm)

    @property
    def n_supertiles(self) -> int:
        return -(-self.m_pad // self.sm)

    @property
    def n_out_strips(self) -> int:
        return self.n_supertiles * (self.sm // self.tm)

    @property
    def num_k_tiles(self) -> int:
        return -(-self.shape[1] // self.tk)

    @property
    def plan_bytes(self) -> int:
        return int(self.a_dense.nbytes)

    def chunk_arrays(self):
        """Per-chunk arrays (c_kt, c_st, c_start, c_count) of the TPU
        kernel's grid, cached."""
        cached = self.__dict__.get("_chunk_arrays")
        if cached is None:
            cached = build_chunk_arrays(self.kt, self.st, self.start,
                                        self.count, self.chunk_strips,
                                        self.n_strips)
            object.__setattr__(self, "_chunk_arrays", cached)
        return cached

    def strip_index(self):
        """(strip_ptr, src_slot, src_kt) over the output strips of the
        permuted C: every strip of every pair's run, in plan order; the
        zero tail is left out.  Cached."""
        cached = self.__dict__.get("_strip_index")
        if cached is None:
            count = self.count.astype(np.int64)
            pair = np.repeat(np.arange(self.n_pairs), count)
            first = np.repeat(np.cumsum(count) - count, count)
            slot = self.start.astype(np.int64)[pair] + (
                np.arange(len(pair)) - first)
            out_strip = (self.st.astype(np.int64)[pair] * (self.sm // self.tm)
                         + self.offs.astype(np.int64)[slot] // self.tm)
            cached = strip_owner_index(out_strip, slot, self.kt[pair],
                                       self.n_out_strips)
            object.__setattr__(self, "_strip_index", cached)
        return cached

    def group_index(self, G: int):
        """(group_ptr, group_kt, group_slot) over groups of G output
        strips (:func:`~tpuspmm_torch.kernels.panel_spmm.strip_group_index`);
        cached."""
        return cached_group_index(self, G)

    def device_arrays(self, device):
        """Chunk arrays, offs, stacked plan, group index (GROUP_ROWS // tm
        strips a group) and un-permute index on ``device``, transferred
        once and cached."""
        def build():
            c_kt, c_st, c_start, c_count = self.chunk_arrays()
            arrs = {"c_kt": c_kt, "c_st": c_st, "c_start": c_start,
                    "c_count": c_count, "offs": self.offs}
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in arrs.items()}
            out.update(group_arrays(self, GROUP_ROWS // self.tm))
            out["a_dense"] = plan_tensor(self.a_dense)
            if self.row_perm is not None:
                out["inv"] = torch.from_numpy(
                    np.argsort(np.asarray(self.row_perm)).astype(np.int64))
            return out

        return _device_cache(self, device, build)


def build_chunk_arrays(kt, st, start, count, chunk_strips: int,
                       n_strips: int):
    """Chop each pair's strip run into CH-strip chunks.  Empty pairs
    (missing-supertile fillers) keep one chunk with count 0 pointing at
    the zero tail."""
    CH = chunk_strips
    kt = np.asarray(kt, np.int32)
    st = np.asarray(st, np.int32)
    start = np.asarray(start, np.int64)
    count = np.asarray(count, np.int64)
    nch = np.maximum(1, -(-count // CH))
    c_pair = np.repeat(np.arange(len(kt)), nch)
    within = np.arange(len(c_pair)) - np.repeat(
        np.concatenate([[0], np.cumsum(nch)[:-1]]), nch)
    c_start = np.where(count[c_pair] > 0,
                       start[c_pair] + within * CH,
                       n_strips).astype(np.int32)
    c_count = np.clip(count[c_pair] - within * CH, 0, CH).astype(np.int32)
    return (kt[c_pair], st[c_pair], c_start, c_count)


def build_pair_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    tm: int = 8,
    tk: int = 128,
    chunk_strips: int = CHUNK_STRIPS,
    sm: int | None = None,
    row_perm: np.ndarray | None = None,
) -> PairPlan:
    """Group triplets by (supertile, k-tile, row-strip), densify each group
    into one (tm × tk) strip, and record per-(supertile, k-tile) strip
    runs — no padding beyond the CH-strip zero tail.  The arrays equal
    ``tpuspmm``'s (a bf16 plan as its uint16 bits)."""
    if tm % 8:
        raise ValueError("tm must be a multiple of 8")
    CH = chunk_strips
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    m, k = shape
    if row_perm is not None:
        inv = np.empty(m, np.int64)
        inv[np.asarray(row_perm, np.int64)] = np.arange(m)
        rows = inv[rows]
    rows, cols, vals = _dedupe_triplets(rows, cols, vals, k)
    store_bf16 = values_bf16_exact(vals)
    m_pad = round_up(m, tm)
    if sm is None:
        sm = m_pad
    if sm % tm or sm <= 0:
        raise ValueError("sm must be a positive multiple of tm")
    n_st = max(1, -(-m_pad // sm))
    strips_per_st = sm // tm

    rt = rows // tm
    ktile = cols // tk
    stile = rt // strips_per_st
    nrt = max(1, -(-m // tm))
    nkt = max(1, -(-k // tk))
    order = np.lexsort((rt, ktile, stile))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rt, ktile, stile = rt[order], ktile[order], stile[order]

    group_key = (stile * nkt + ktile) * nrt + rt
    if len(group_key):
        gb = np.flatnonzero(np.diff(group_key)) + 1
        starts = np.concatenate([[0], gb]).astype(np.int64)
    else:
        starts = np.zeros(0, dtype=np.int64)
    g_rt = rt[starts] if len(starts) else np.zeros(0, np.int64)
    g_kt = ktile[starts] if len(starts) else np.zeros(0, np.int64)
    g_st = stile[starts] if len(starts) else np.zeros(0, np.int64)
    n_strips = len(starts)

    # pair runs: groups are (st, kt)-major sorted → consecutive
    pair_key = g_st * nkt + g_kt
    pairs_unique, pair_counts = (np.unique(pair_key, return_counts=True)
                                 if n_strips else
                                 (np.zeros(0, np.int64),
                                  np.zeros(0, np.int64)))
    pair_start = (np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
                  if len(pair_counts) else np.zeros(0, np.int64))
    kt_arr = (pairs_unique % nkt).astype(np.int32)
    st_arr = (pairs_unique // nkt).astype(np.int32)
    start_arr = pair_start.astype(np.int32)
    count_arr = pair_counts.astype(np.int32)

    # every supertile appears (an empty pair for an empty supertile)
    missing = np.setdiff1d(np.arange(n_st), st_arr)
    if len(missing):
        kt_arr = np.concatenate([kt_arr, np.zeros(len(missing), np.int32)])
        st_arr = np.concatenate([st_arr, missing.astype(np.int32)])
        start_arr = np.concatenate(
            [start_arr, np.full(len(missing), n_strips, np.int32)])
        count_arr = np.concatenate(
            [count_arr, np.zeros(len(missing), np.int32)])
        perm = np.lexsort((kt_arr, st_arr))
        kt_arr, st_arr = kt_arr[perm], st_arr[perm]
        start_arr, count_arr = start_arr[perm], count_arr[perm]

    offs = np.full(n_strips + CH, sm, np.int32)
    offs[:n_strips] = (g_rt * tm - g_st * sm).astype(np.int32)

    # densify: slots are unique after dedupe — pure placement
    g_sizes = np.diff(np.concatenate([starts, [len(rows)]]))
    trip_group = np.repeat(np.arange(n_strips), g_sizes)
    r_local = rows - g_rt[trip_group] * tm
    c_local = cols - g_kt[trip_group] * tk
    flat = (trip_group * tm + r_local) * tk + c_local
    a_dense = np.zeros((n_strips + CH) * tm * tk,
                       np.uint16 if store_bf16 else np.float32)
    a_dense[flat] = _bf16_bits(vals) if store_bf16 else vals
    a_dense = a_dense.reshape((n_strips + CH) * tm, tk)

    return PairPlan(kt=kt_arr, st=st_arr, start=start_arr, count=count_arr,
                    offs=offs, a_dense=a_dense, shape=tuple(shape), tm=tm,
                    tk=tk, chunk_strips=CH, sm=sm, row_perm=row_perm)


def _pair_search(m_pad, tm, nkt, strip_bytes, bw, step_us, strip_us,
                 perm_us, orders, order_kinds, groups, plan_bytes_cap,
                 chunk_strips):
    """The (CH, order) sweep of the pair cost model for a single
    supertile.  Returns (best, entries): every admissible candidate as
    (cost, perm, plan_bytes, sm, ch, order_kind), and the winner among
    them with a 3%-win hysteresis in iteration order (CH 64→8, so ties
    keep the larger chunk), None when nothing is admissible."""
    ch_candidates = ((chunk_strips,) if chunk_strips is not None
                     else (64, 32, 16, 8))
    counts = [_st_strip_counts_from_groups(g, nkt, max(1, m_pad // tm))
              for g in groups]
    best = None
    entries = []
    for ch in ch_candidates:
        for oi, (perm, _) in enumerate(orders):
            cnt, occ_st = counts[oi]
            strips = int(cnt.sum())
            steps = int(np.sum(-(-cnt // ch))) + (1 - occ_st)
            plan_bytes = strips * strip_bytes
            if plan_bytes_cap is not None and plan_bytes > plan_bytes_cap:
                continue
            cost = (steps * (step_us + ch * (strip_bytes / bw + strip_us))
                    + (perm_us if perm is not None else 0.0))
            entries.append((cost, perm, plan_bytes, m_pad, ch,
                            order_kinds[oi]))
            if best is None or cost < best[0] * 0.97:
                best = entries[-1]
    return best, entries


PairGeometry = dataclasses.make_dataclass(
    "PairGeometry", ["row_perm", "sm", "chunk_strips", "plan_bytes",
                     ("order_kind", str, dataclasses.field(
                         default="natural")),
                     ("cost_us", object, dataclasses.field(default=None))])
# cost_us: the search's modelled serve time, same constants and units as
# PanelGeometry.cost_us.


def _pair_model_inputs(a, coo, rows, cols, m, k, n_pad, tm, tk,
                       reorder_rows, th):
    """Positional `_pair_search` model inputs (everything before the
    plan-bytes cap)."""
    ktile = cols // tk
    val_bytes = (2 if plan_values_bf16_exact_cached(a, rows, cols,
                                                    coo.values, k) else 4)
    strip_bytes = tm * tk * val_bytes
    bw = th["panel_hbm_gbps"] * 1e3
    perm_us = m * n_pad * 4 * 2 / (th["panel_gather_gbps"] * 1e3)
    m_pad = round_up(max(m, tm), tm)
    nkt = max(1, -(-k // tk))

    orders = [(None, rows)]
    order_kinds = ["natural"]
    if reorder_rows and len(rows) and m > tm:
        for kind, perm in zip(ORDER_KINDS,
                              _order_candidates(rows, cols, m, ktile)):
            inv = np.empty(m, np.int64)
            inv[perm] = np.arange(m)
            orders.append((perm, inv[rows]))
            order_kinds.append(kind)
    groups = [_occupied_strip_groups(prows, ktile, nkt, tm)
              for _, prows in orders]
    return (m_pad, tm, nkt, strip_bytes, bw, th["panel_step_us"],
            th["panel_strip_us"], perm_us, orders, order_kinds, groups)


def _pair_key(n_pad, tm, tk, reorder_rows, plan_bytes_cap, chunk_strips,
              th: dict, b_dtype=torch.float32) -> tuple:
    """The container-cache key of a pair geometry: the resolver's
    arguments, the device's cost constants and B's value bytes (see
    ``panel_spmm._panel_key``)."""
    return ("pair_geom", tm, tk, reorder_rows, n_pad, plan_bytes_cap,
            chunk_strips, search_constants(th), b_value_bytes(b_dtype))


def _pair_geometry(e) -> PairGeometry:
    """A `_pair_search` entry as a PairGeometry."""
    return PairGeometry(e[1], e[3], e[4], e[2], e[5], float(e[0]))


def _pair_entry(geom) -> dict | None:
    """A pair geometry as the disk cache stores it (the row order by its
    kind), None for "inadmissible"."""
    if geom is None:
        return None
    return {"sm": int(geom.sm), "ch": int(geom.chunk_strips),
            "plan_bytes": int(geom.plan_bytes), "order": geom.order_kind,
            "cost": None if geom.cost_us is None else float(geom.cost_us)}


def resolve_pair_geometry(a, n_pad: int = 256, tm: int = 8, tk: int = 128,
                          reorder_rows: bool = True,
                          plan_bytes_cap: int | None = None,
                          chunk_strips: int | None = None,
                          device="cpu", b_dtype=torch.float32):
    """Pick (row order, chunk strips) for a single-supertile pair plan.

    The serve-time model per (CH, ordering):

        steps·(step_us + CH·(strip_bytes/bw + strip_us)) [+ perm_us]

    where steps = Σ_pairs ceil(run/CH).  Pass ``chunk_strips`` to pin CH.
    The cost constants are ``dispatch.thresholds(device)``.  Returns a
    PairGeometry, or None when the plan exceeds ``plan_bytes_cap``.
    Cached on the container and in the geometry disk cache per B dtype,
    as the panel resolver is (:func:`pin_pair_geometry` records the
    measured winner)."""
    from tpuspmm_torch.kernels.dispatch import thresholds
    from tpuspmm_torch.ops.xla import coo_view

    th = thresholds(device)
    key = _pair_key(n_pad, tm, tk, reorder_rows, plan_bytes_cap,
                    chunk_strips, th, b_dtype)
    cache = container_cache(a)
    if key in cache:
        return cache[key]
    coo = coo_view(a)
    m, k = coo.shape
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    hit, entry = geom_disk_load(a, key, device)
    if hit:
        geom = None
        if entry is not None:
            perm = (None if entry["order"] == "natural"
                    else _order_perm(rows, cols, m, cols // tk,
                                     entry["order"]))
            geom = PairGeometry(perm, int(entry["sm"]), int(entry["ch"]),
                                int(entry["plan_bytes"]), entry["order"],
                                entry.get("cost"))
        cache[key] = geom
        return geom
    best, _ = _pair_search(
        *_pair_model_inputs(a, coo, rows, cols, m, k, n_pad, tm, tk,
                            reorder_rows, th),
        plan_bytes_cap, chunk_strips)
    geom = None if best is None else _pair_geometry(best)
    geom_disk_store(a, key, _pair_entry(geom), device)
    cache[key] = geom
    return geom


def resolve_pair_geometry_candidates(a, n_pad: int = 256, k: int = 3,
                                     tm: int = 8, tk: int = 128,
                                     reorder_rows: bool = True,
                                     plan_bytes_cap: int | None = None,
                                     device="cpu"):
    """The model's top-``k`` distinct pair geometries (by sm, CH, order),
    cheapest modelled first with the resolver's hysteresis winner leading:
    the pair counterpart of
    ``panel_spmm.resolve_panel_geometry_candidates``."""
    from tpuspmm_torch.kernels.dispatch import thresholds
    from tpuspmm_torch.ops.xla import coo_view

    coo = coo_view(a)
    m, kk = coo.shape
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    best, entries = _pair_search(
        *_pair_model_inputs(a, coo, rows, cols, m, kk, n_pad, tm, tk,
                            reorder_rows, thresholds(device)),
        plan_bytes_cap, None)
    if best is None:
        return []
    seen, out = set(), []
    for e in [best] + sorted(entries, key=lambda e: e[0]):
        ident = (e[3], e[4], e[5])  # sm, CH, order
        if ident not in seen:
            seen.add(ident)
            out.append(_pair_geometry(e))
        if len(out) >= k:
            break
    return out


def pin_pair_geometry(a, geom, n_pad: int = 256, tm: int = 8,
                      tk: int = 128, reorder_rows: bool = True,
                      plan_bytes_cap: int | None = None,
                      chunk_strips: int | None = None,
                      device="cpu", b_dtype=torch.float32,
                      disk: bool = True) -> None:
    """Record ``geom`` as the geometry :func:`resolve_pair_geometry`
    returns for these arguments and B dtype (see
    ``panel_spmm.pin_panel_geometry``)."""
    from tpuspmm_torch.kernels.dispatch import thresholds

    key = _pair_key(n_pad, tm, tk, reorder_rows, plan_bytes_cap,
                    chunk_strips, thresholds(device), b_dtype)
    container_cache(a)[key] = geom
    if disk:
        geom_disk_store(a, key, _pair_entry(geom), device)


def plan_values_bf16_exact_cached(a, rows, cols, vals, k: int) -> bool:
    """Container-cached :func:`plan_values_bf16_exact`."""
    cache = container_cache(a)
    if "plan_vals_bf16" not in cache:
        cache["plan_vals_bf16"] = plan_values_bf16_exact(rows, cols, vals, k)
    return cache["plan_vals_bf16"]


def pair_plan_from_container(a, tm: int = 8, tk: int = 128,
                             chunk_strips: int = CHUNK_STRIPS,
                             sm: int | None = None,
                             reorder_rows: bool = True,
                             n_pad: int = 256,
                             geom=None, device="cpu") -> PairPlan:
    """Build (or fetch the cached) PairPlan.  ``geom`` (a PairGeometry)
    pins the row order the caller already resolved; without it the
    resolver picks.  An explicit ``sm`` splits the output into supertiles
    of sm rows."""
    if geom is None:
        geom = resolve_pair_geometry(a, n_pad=n_pad, tm=tm, tk=tk,
                                     reorder_rows=reorder_rows,
                                     device=device)
    if sm is None:
        m_pad = round_up(int(a.shape[0]), tm)
        sm = None if geom.sm == m_pad else geom.sm
    perm = geom.row_perm
    fp = None if perm is None else hash(np.asarray(perm).tobytes())
    key = ("pair", tm, tk, chunk_strips, sm, fp)
    cache = container_cache(a)
    if key not in cache:
        from tpuspmm_torch.ops.xla import coo_view

        coo = coo_view(a)
        cache[key] = build_pair_plan(
            coo.rows, coo.cols, coo.values, coo.shape, tm=tm, tk=tk,
            chunk_strips=chunk_strips, sm=sm, row_perm=perm)
    return cache[key]


def pair_spmm_plain(plan: PairPlan, b: torch.Tensor,
                    mode: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of the pair kernel on b's device: per chunk,
    a batched product of its CH strips with the chunk's B tile through
    :func:`panel_matmul`; strips past the chunk's count go to the trash
    strip; added into the slab by ``offs`` (``index_add_``), then
    :func:`finish_panel_output`."""
    mode = normalize_panel_mode(mode)
    arrs = plan.device_arrays(b.device)
    n = int(b.shape[1])
    n_pad = round_up(n, 128)
    CH, tm, tk, sm = plan.chunk_strips, plan.tm, plan.tk, plan.sm
    b_tiles = pad_b(b, plan.num_k_tiles * tk, n_pad).reshape(
        plan.num_k_tiles, tk, n_pad)
    a3 = arrs["a_dense"].reshape(-1, tm, tk)  # one strip per row block
    c_start = arrs["c_start"].long()
    strip = c_start.unsqueeze(-1) + torch.arange(CH, device=b.device)
    live = torch.arange(CH, device=b.device) < arrs["c_count"].unsqueeze(-1)
    offs = torch.where(live, arrs["offs"][strip], torch.full_like(strip, sm))
    rows = slab_rows(arrs["c_st"], offs, sm, tm)
    out = torch.zeros(plan.n_supertiles * (sm + tm), n_pad,
                      dtype=torch.float32, device=b.device)
    n_chunks = strip.shape[0]
    batch = max(1, PLAIN_BATCH_BYTES // ((tk + CH * tm) * n_pad * 4))
    for q0 in range(0, n_chunks, batch):
        q1 = min(q0 + batch, n_chunks)
        chunk = a3[strip[q0:q1]].reshape(q1 - q0, CH * tm, tk)
        acc = panel_matmul(chunk, b_tiles[arrs["c_kt"][q0:q1].long()], mode)
        out.index_add_(0, rows[q0 * CH * tm:q1 * CH * tm],
                       acc.reshape(-1, n_pad))
    return finish_panel_output(out, plan, arrs, n)


def pair_launch(plan: PairPlan, b: torch.Tensor, mode: str = "highest"):
    """:func:`spmm_pair`'s launch on the card for B of b's shape, dtype
    and device (contiguous): ``launch(b)`` is C
    (``panel_spmm.strip_launch``)."""
    split2 = normalize_panel_mode(mode) == "split"
    check_operand(plan, b)
    return strip_launch(plan, b, "pair_strip_spmm", split2, spmm_pair)


def spmm_pair(a_or_plan, b: torch.Tensor, mode: str = "highest",
              tm: int = 8, tk: int = 128,
              chunk_strips: int | None = None) -> torch.Tensor:
    """Container- or plan-level entry of the pair kernel.

    On a CUDA tensor it launches the strip-owner kernel (``csrc/
    strip_spmm.cu``, ``pair_strip_spmm``; its launch bound once per plan,
    B width, B dtype and device: :func:`pair_launch`) or raises; on a CPU
    tensor it runs :func:`pair_spmm_plain`.  Same precision tiers as
    spmm_panel.  A container resolves its geometry for b's device (single
    supertile); ``chunk_strips`` pins CH."""
    normalize_panel_mode(mode)  # before planning
    n = int(b.shape[1])
    if isinstance(a_or_plan, PairPlan):
        plan = a_or_plan
    else:
        n_pad = round_up(n, 128)
        geom = resolve_pair_geometry(a_or_plan, n_pad, tm=tm, tk=tk,
                                     plan_bytes_cap=PLAN_BYTES_CAP,
                                     chunk_strips=chunk_strips,
                                     device=b.device, b_dtype=b.dtype)
        if geom is None:
            raise ValueError(
                f"no pair geometry admissible at width {n}: the plan "
                "exceeds PLAN_BYTES_CAP")
        plan = pair_plan_from_container(
            a_or_plan, tm=tm, tk=tk, chunk_strips=geom.chunk_strips,
            n_pad=n_pad, geom=geom, device=b.device)
    check_operand(plan, b)
    if b.device.type == "cpu":
        return pair_spmm_plain(plan, b, mode)
    return pair_launch(plan, b, mode)(b)


spmm_pair.launches = 0
