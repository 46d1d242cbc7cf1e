"""Pre-densified panel SpMM: plan-time block densification (kernel K1).

Counterpart of ``tpuspmm/kernels/panel_spmm.py``.  The sparse operand is
static across serving calls, so its nonzeros are grouped once at plan time
by (row supertile, k-tile, row strip of tm rows), and each group is
densified into a (tm × tk) strip.  Each (supertile, k-tile) pair's strip
list is padded to a multiple of P, so the stacked plan is a sequence of
panels of P strips that share one k-tile:

    for each panel p, strip i:  C[st[p]·sm + offs[p, i] : +tm, :]
                                    += A_strip[p, i] @ B[kt[p]·tk : +tk, :]

Padding strips carry offset ``sm`` (the TPU kernel's trash strip).

On the card the panel layout is served by the strip-owner kernel
(``csrc/strip_spmm.cu``, entry ``panel_strip_spmm``): the plan arrays stay
exactly as above.  A CSR index over the output strips
(:meth:`PanelPlan.strip_index`) lists each output strip's plan strips in
plan order, and a group index over it (:meth:`PanelPlan.group_index`)
gives each group of GROUP_ROWS output rows one owner block that walks its
(group, k-tile) entries in ascending k-tile, loading each B tile once for
the group's strips.  On a CPU tensor the wrapper runs the plain version,
:func:`panel_spmm_plain`.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import operator
from typing import Tuple

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.kernels.common import pad_b, round_up, split_bf16
from tpuspmm_torch.kernels.strip_cuda import GROUP_ROWS
from tpuspmm_torch.utils import disk_cache

# admission cap on the stacked dense plan (re-read from device memory
# every call)
PLAN_BYTES_CAP = 512 * 1024 * 1024


def plan_tensor(a_dense: np.ndarray) -> torch.Tensor:
    """Host tensor of a stacked plan: float32, or bfloat16 for a plan stored
    as its uint16 bit pattern."""
    a_dense = np.ascontiguousarray(a_dense)
    if a_dense.dtype == np.uint16:
        return torch.from_numpy(a_dense.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a_dense)


def strip_owner_index(out_strip: np.ndarray, slot: np.ndarray,
                      kt: np.ndarray, n_out: int):
    """CSR index over output strips from per-entry (output strip, plan
    slot, k-tile) listed in plan order: (strip_ptr, src_slot, src_kt),
    int32.  The stable sort keeps plan order inside each output strip."""
    out_strip = np.asarray(out_strip, np.int64)
    order = np.argsort(out_strip, kind="stable")
    strip_ptr = np.zeros(n_out + 1, np.int64)
    strip_ptr[1:] = np.cumsum(np.bincount(out_strip, minlength=n_out))
    return (strip_ptr.astype(np.int32),
            np.asarray(slot, np.int32)[order],
            np.asarray(kt, np.int32)[order])


def strip_group_index(strip_ptr, src_slot, src_kt, n_out: int, G: int):
    """Group index over a strip-owner index: output strips [g·G, +G) form
    group g, and each (group, k-tile) entry lists the G source slots at
    that k-tile, -1 for a strip absent there.  Returns (group_ptr (n_groups
    + 1,), group_kt (n_entries,), group_slot (n_entries, G)), int32, each
    group's entries in ascending k-tile.  Raises if an output strip holds
    two plan strips at one k-tile (no plan builds that)."""
    counts = np.diff(np.asarray(strip_ptr, np.int64))
    strip = np.repeat(np.arange(n_out, dtype=np.int64), counts)
    kt = np.asarray(src_kt, np.int64)
    nkt = int(kt.max()) + 1 if len(kt) else 1
    keys, entry = np.unique((strip // G) * nkt + kt, return_inverse=True)
    cell = entry.reshape(-1) * G + strip % G
    if len(np.unique(cell)) != len(cell):
        raise ValueError("an output strip holds two strips at one k-tile")
    group_slot = np.full((len(keys), G), -1, np.int32)
    group_slot.reshape(-1)[cell] = np.asarray(src_slot, np.int32)
    n_groups = -(-n_out // G)
    group_ptr = np.zeros(n_groups + 1, np.int64)
    group_ptr[1:] = np.cumsum(np.bincount(keys // nkt, minlength=n_groups))
    return (group_ptr.astype(np.int32), (keys % nkt).astype(np.int32),
            group_slot)


def cached_group_index(plan, G: int):
    """:func:`strip_group_index` of a plan's strip index, cached on the
    plan per G."""
    cache = plan.__dict__.setdefault("_group_index", {})
    if G not in cache:
        cache[G] = strip_group_index(*plan.strip_index(), plan.n_out_strips,
                                     G)
    return cache[G]


def group_arrays(plan, G: int) -> dict:
    """The group index over G output strips as host tensors, under the
    names the strip kernel's wrapper reads, and group_order: the groups by
    entries, most first (the kernel's launch order)."""
    index = cached_group_index(plan, G)
    order = np.argsort(-np.diff(index[0]), kind="stable").astype(np.int32)
    return {name: torch.from_numpy(np.ascontiguousarray(v))
            for name, v in zip(("group_ptr", "group_kt", "group_slot",
                                "group_order"), (*index, order))}


def _device_cache(plan, device, build):
    """Per-device tensors of a plan, transferred once and cached on it."""
    cache = plan.__dict__.setdefault("_device", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = {name: t.to(device) for name, t in build().items()}
    return cache[key]


@dataclasses.dataclass(frozen=True)
class PanelPlan:
    """Plan-time densification of a sparse matrix into panels."""

    kt: np.ndarray       # (n_panels,) int32 — k-tile per panel (sorted
    #                      within each supertile)
    st: np.ndarray       # (n_panels,) int32 — supertile per panel
    #                      (ascending; every supertile appears)
    offs: np.ndarray     # (n_panels, P) int32 — supertile-local C row
    #                      offset per strip; padding strips hold sm
    a_dense: np.ndarray  # (n_panels · P · tm, tk) — stacked strips; float32,
    #                      or uint16 bf16 bit patterns when every (deduped)
    #                      value round-trips bf16 losslessly

    shape: Tuple[int, int]
    tm: int
    tk: int
    panel_strips: int  # P
    sm: int            # supertile rows (multiple of tm); m_pad for one
    row_perm: np.ndarray | None = None  # original row placed at permuted
    #                    position j is row_perm[j]

    @property
    def n_panels(self) -> int:
        return int(self.kt.shape[0])

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

    def strip_index(self):
        """(strip_ptr, src_slot, src_kt) over the output strips of the
        permuted C, trash-free; cached."""
        cached = self.__dict__.get("_strip_index")
        if cached is None:
            P = self.panel_strips
            offs = self.offs.reshape(-1).astype(np.int64)
            used = offs != self.sm
            st = np.repeat(self.st.astype(np.int64), P)
            out_strip = st * (self.sm // self.tm) + offs // self.tm
            slot = np.arange(self.n_panels * P)
            cached = strip_owner_index(out_strip[used], slot[used],
                                       np.repeat(self.kt, P)[used],
                                       self.n_out_strips)
            object.__setattr__(self, "_strip_index", cached)
        return cached

    def group_index(self, G: int):
        """(group_ptr, group_kt, group_slot) over groups of G output
        strips (:func:`strip_group_index`); cached."""
        return cached_group_index(self, G)

    def device_arrays(self, device):
        """Plan arrays, group index (GROUP_ROWS // tm strips a group) and
        un-permute index on ``device``, transferred once and cached."""
        def build():
            arrs = {"kt": self.kt, "st": self.st, "offs": self.offs}
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in arrs.items()}
            out.update(group_arrays(self, GROUP_ROWS // self.tm))
            out["a_dense"] = plan_tensor(self.a_dense)
            if self.row_perm is not None:
                out["inv"] = torch.from_numpy(
                    np.argsort(np.asarray(self.row_perm)).astype(np.int64))
            return out

        return _device_cache(self, device, build)


def _occupied_strip_groups(rows, ktile, nkt: int, tm: int):
    """Sorted unique (row-strip, k-tile) group ids."""
    return np.unique((rows // tm) * nkt + ktile)


def _st_strip_counts_from_groups(g, nkt: int, st_div: int):
    """Occupied strips per (supertile, k-tile) pair, and the number of
    occupied supertiles."""
    st_g = (g // nkt) // st_div
    pair = st_g * nkt + (g % nkt)
    _, cnt = np.unique(pair, return_counts=True)
    return cnt, len(np.unique(st_g))


def _padded_strips(cnt: np.ndarray, P: int) -> int:
    """Total strips after padding each k-tile's list to a multiple of P."""
    return int(((-(-cnt // P)) * P).sum())


# Named row-ordering kinds, index-aligned with _order_candidates' return.
ORDER_KINDS = ("centroid", "first_centroid", "signature")


def _row_centroids(rows, cols, m: int):
    cent = np.zeros(m)
    num = np.zeros(m)
    np.add.at(cent, rows, cols)
    np.add.at(num, rows, 1)
    return np.where(num > 0, cent / np.maximum(num, 1), np.inf)


def _order_perm(rows, cols, m: int, ktile, kind: str, sig_depth: int = 4,
                cent=None):
    """One named candidate row permutation (see _order_candidates)."""
    if cent is None:
        cent = _row_centroids(rows, cols, m)
    if kind == "centroid":
        return np.argsort(cent, kind="stable")
    if kind == "first_centroid":
        first = np.full(m, np.inf)
        np.minimum.at(first, rows, ktile)
        return np.lexsort((cent, first))
    if kind != "signature":
        raise ValueError(f"unknown row-order kind {kind!r}")
    # signature keys: the d-th distinct k-tile of each row (BIG when the
    # row has fewer than d+1 distinct tiles, pushing short rows together)
    nk = int(ktile.max()) + 1 if len(ktile) else 1
    dd = np.unique(rows * np.int64(nk) + ktile)
    rr, kk = dd // nk, dd % nk
    starts = np.concatenate([[0], np.flatnonzero(np.diff(rr)) + 1])
    counts = np.diff(np.concatenate([starts, [len(rr)]]))
    BIG = np.int64(1) << 40
    keys = np.full((m, sig_depth), BIG, np.int64)
    urows = rr[starts]
    for d in range(sig_depth):
        sel = counts > d
        keys[urows[sel], d] = kk[starts[sel] + d]
    return np.lexsort((cent, *(keys[:, d] for d in
                               range(sig_depth - 1, -1, -1))))


def _order_candidates(rows, cols, m: int, ktile, sig_depth: int = 4):
    """Candidate row permutations that cluster rows sharing k-tiles into
    the same strip: column-centroid sort, (first k-tile, centroid)
    lexsort, and a k-tile-signature lexsort."""
    cent = _row_centroids(rows, cols, m)
    return tuple(_order_perm(rows, cols, m, ktile, kind, sig_depth,
                             cent=cent)
                 for kind in ORDER_KINDS)


# P, strip-height and k-tile-width candidates of the joint search
STRIP_CANDIDATES = (8, 16, 32, 64)
TM_CANDIDATES = (8, 16, 32)
TK_CANDIDATES = (128, 256, 512)


def _geometry_search(rows, cols, m: int, k: int, tm, tk: int,
                     candidates, *,
                     plan_bytes_cap: int | None = None,
                     step_us: float = 0.0,
                     strip_us: float = 0.0,
                     hbm_gbps: float = 3350.0,
                     perm_us: float = 0.0,
                     reorder: bool = True,
                     prefer: int = 16,
                     val_bytes: int = 4,
                     topk: int | None = None):
    """Joint (tm, tk, P, row order) search for a single-supertile plan,
    minimising the modelled serve time

        n_strips·(strip_bytes/bandwidth + strip_us) + n_panels·step_us
        [+ perm_us if row-reordered]

    with exact plan bytes per candidate (``plan_bytes_cap`` filters).  A
    ≥3% modelled win is required to leave the natural order at (first tm,
    first tk, P=prefer), falling back to the smallest admissible P.
    ``tm`` and ``tk`` may each be an int (pinned) or a tuple of
    candidates.  Returns (P, row_perm, sm, plan_bytes, tm, order_kind, tk,
    cost_us) or None when no candidate passes admission.  With ``topk``
    set, returns a list of up to topk such tuples: the distinct geometries
    (by P, sm, tm, order, tk), cheapest modelled first, with the winner
    above leading, for callers that measure them."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    tms = (tm,) if isinstance(tm, int) else tuple(tm)
    tks = (tk,) if isinstance(tk, int) else tuple(tk)
    bw = hbm_gbps * 1e3          # bytes per µs

    # (cost, P, perm, sm, plan_bytes, tm, order_kind, tk)
    entries = []
    for tk_c in tks:
        nkt = max(1, -(-k // tk_c))
        ktile = cols // tk_c
        orders = [(None, rows)]
        order_kinds = ["natural"]
        if reorder and len(rows) and m > tms[0]:
            for kind, perm in zip(ORDER_KINDS,
                                  _order_candidates(rows, cols, m, ktile)):
                inv = np.empty(m, np.int64)
                inv[perm] = np.arange(m)
                orders.append((perm, inv[rows]))
                order_kinds.append(kind)

        for tm_c in tms:
            m_pad = round_up(max(m, tm_c), tm_c)
            strip_bytes = tm_c * tk_c * val_bytes
            groups = [_occupied_strip_groups(prows, ktile, nkt, tm_c)
                      for _, prows in orders]
            # one supertile: (per-k-tile strip counts, occupied supertiles)
            counts = [_st_strip_counts_from_groups(g, nkt, m_pad // tm_c)
                      for g in groups]
            for P in candidates:
                for oi, (perm, _) in enumerate(orders):
                    cnt, occ_st = counts[oi]
                    # an empty matrix still serves one all-padding panel
                    s = _padded_strips(cnt, P) + (1 - occ_st) * P
                    plan_bytes = s * strip_bytes
                    if (plan_bytes_cap is not None
                            and plan_bytes > plan_bytes_cap):
                        continue
                    cost = (s * (strip_bytes / bw + strip_us)
                            + (s // P) * step_us
                            + (perm_us if perm is not None else 0.0))
                    entries.append((cost, P, perm, m_pad, plan_bytes, tm_c,
                                    order_kinds[oi], tk_c))
    if not entries:
        return [] if topk is not None else None
    naturals = [e for e in entries
                if e[2] is None and e[5] == tms[0] and e[7] == tks[0]]
    base = next((e for e in naturals if e[1] == prefer), None)
    if base is None and naturals:
        base = naturals[0]  # smallest admissible P, natural order
    best = min(entries, key=lambda e: e[0])
    if base is not None and best[0] >= base[0] * 0.97:
        best = base

    def _tup(e):
        return (e[1], e[2], e[3], e[4], e[5], e[6], e[7], e[0])

    if topk is None:
        return _tup(best)
    seen, out = set(), []
    for e in [best] + sorted(entries, key=lambda e: e[0]):
        ident = (e[1], e[3], e[5], e[6], e[7])
        if ident not in seen:
            seen.add(ident)
            out.append(_tup(e))
        if len(out) >= topk:
            break
    return out


def choose_panel_geometry(rows, cols, m: int, k: int, tm: int = 8,
                          tk: int = 128,
                          strip_candidates=STRIP_CANDIDATES,
                          step_us: float = 0.0,
                          strip_us: float = 0.0,
                          hbm_gbps: float = 3350.0,
                          perm_us: float = 0.0):
    """(P, row_perm) for a single-supertile plan at pinned (tm, tk) — the
    raw cost-model entry of _geometry_search."""
    rows = np.asarray(rows, np.int64)
    if len(rows) == 0 or m <= tm:
        return 16, None
    g = _geometry_search(rows, cols, m, k, tm, tk, strip_candidates,
                         step_us=step_us, strip_us=strip_us,
                         hbm_gbps=hbm_gbps, perm_us=perm_us)
    return (16, None) if g is None else (g[0], g[1])


def values_bf16_exact(vals) -> bool:
    """Do these f32 values round-trip bf16 losslessly?"""
    v = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    return bool(torch.equal(v.to(torch.bfloat16).float(), v))


def _bf16_bits(vals: np.ndarray) -> np.ndarray:
    """uint16 bit patterns of bf16-representable f32 values."""
    v = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    return v.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _dedupe_triplets(rows, cols, vals, k: int):
    """Collapse duplicate coordinates once at plan time, summing in f64
    then rounding to f32, so every plan slot holds exactly one value."""
    if not len(rows):
        return rows, cols, vals
    key = rows * np.int64(k) + cols
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) == len(rows):
        return rows, cols, vals
    acc = np.zeros(len(uniq), np.float64)
    np.add.at(acc, inv, vals.astype(np.float64))
    return ((uniq // k).astype(np.int64), (uniq % k).astype(np.int64),
            acc.astype(np.float32))


def plan_values_bf16_exact(rows, cols, vals, k: int) -> bool:
    """Exact predictor of whether a plan built from these triplets stores
    bf16 (the plan's nonzeros are precisely the deduped values)."""
    _, _, v = _dedupe_triplets(np.asarray(rows, np.int64),
                               np.asarray(cols, np.int64),
                               np.asarray(vals, np.float32), k)
    return values_bf16_exact(v)


def build_panel_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    tm: int = 8,
    tk: int = 128,
    panel_strips: int = 16,
    sm: int | None = None,
    row_perm: np.ndarray | None = None,
) -> PanelPlan:
    """Group triplets by (supertile, k-tile, row-strip), supertile-major
    then kt-major; densify each group into a (tm × tk) strip; pad each
    (supertile, k-tile)'s strip list to a multiple of P.  ``sm``
    (supertile rows, multiple of tm) defaults to one supertile.  The
    arrays equal ``tpuspmm``'s (a bf16 plan as its uint16 bits)."""
    if tm % 8:
        raise ValueError("tm must be a multiple of 8")
    P = panel_strips
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    m, k = shape
    if row_perm is not None:
        inv = np.empty(m, np.int64)
        inv[np.asarray(row_perm, np.int64)] = np.arange(m)
        rows = inv[rows]  # the plan computes the permuted C
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
    nrt = -(-m // tm)
    nkt = -(-k // tk)
    order = np.lexsort((rt, ktile, stile))  # supertile-, then kt-major
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
    n_groups = len(starts)

    if n_groups == 0:  # empty matrix: one all-padding panel per supertile
        return PanelPlan(kt=np.zeros(n_st, np.int32),
                         st=np.arange(n_st, dtype=np.int32),
                         offs=np.full((n_st, P), sm, np.int32),
                         a_dense=np.zeros((n_st * P * tm, tk), np.uint16),
                         shape=tuple(shape), tm=tm, tk=tk, panel_strips=P,
                         sm=sm, row_perm=row_perm)

    # per-(supertile, k-tile) group counts, padded to multiples of P
    pair_key = g_st * nkt + g_kt
    pairs_unique, pair_counts = np.unique(pair_key, return_counts=True)
    padded = (-(-pair_counts // P)) * P
    pair_start = np.concatenate([[0], np.cumsum(padded)[:-1]])
    n_strips = int(padded.sum())
    n_panels = n_strips // P

    # strip slot per group: groups within a (supertile, k-tile) pair take
    # consecutive ranks
    pair_index = np.searchsorted(pairs_unique, pair_key)
    first_of_pair = np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
    rank_in_pair = np.arange(n_groups) - first_of_pair[pair_index]
    slot = (pair_start[pair_index] + rank_in_pair).astype(np.int64)

    kt_arr = np.repeat(pairs_unique % nkt, padded // P).astype(np.int32)
    st_arr = np.repeat(pairs_unique // nkt, padded // P).astype(np.int32)
    offs = np.full(n_strips, sm, np.int32)  # default: padding strip
    offs[slot] = (g_rt * tm - g_st * sm).astype(np.int32)
    offs = offs.reshape(n_panels, P)

    # densify: flat slots are unique after dedupe — a pure placement
    g_sizes = np.diff(np.concatenate([starts, [len(rows)]]))
    trip_group = np.repeat(np.arange(n_groups), g_sizes)
    r_local = rows - g_rt[trip_group] * tm
    c_local = cols - g_kt[trip_group] * tk
    flat = (slot[trip_group] * tm + r_local) * tk + c_local
    a_dense = np.zeros(n_strips * tm * tk,
                       np.uint16 if store_bf16 else np.float32)
    a_dense[flat] = _bf16_bits(vals) if store_bf16 else vals
    a_dense = a_dense.reshape(n_strips * tm, tk)

    # every supertile appears: an all-padding panel for an empty one
    missing = np.setdiff1d(np.arange(n_st), st_arr)
    if len(missing):
        kt_arr = np.concatenate([kt_arr, np.zeros(len(missing), np.int32)])
        st_arr = np.concatenate([st_arr, missing.astype(np.int32)])
        offs = np.concatenate([offs, np.full((len(missing), P), sm,
                                             np.int32)])
        a_dense = np.concatenate(
            [a_dense, np.zeros((len(missing) * P * tm, tk), a_dense.dtype)])
        perm = np.lexsort((kt_arr, st_arr))
        kt_arr, st_arr, offs = kt_arr[perm], st_arr[perm], offs[perm]
        a_dense = a_dense.reshape(-1, P * tm, tk)[perm].reshape(-1, tk)

    return PanelPlan(kt=kt_arr, st=st_arr, offs=offs, a_dense=a_dense,
                     shape=tuple(shape), tm=tm, tk=tk, panel_strips=P,
                     sm=sm, row_perm=row_perm)


PanelGeometry = collections.namedtuple(
    "PanelGeometry",
    "panel_strips row_perm sm plan_bytes tm order_kind tk cost_us",
    defaults=(8, "natural", 128, None))
# cost_us: the search's modelled serve time, comparable with a
# PairGeometry's — how the dispatcher picks between the two kernels.


def _panel_model_kwargs(th: dict, m: int, k: int, n_pad: int,
                        plan_bytes_cap, reorder_rows: bool,
                        rows, cols, values) -> dict:
    """`_geometry_search` kwargs from the device's cost constants.
    perm_us charges the un-permute of a row-reordered C: the m×n_pad output
    read and written once at the row-gather bandwidth."""
    perm_us = m * n_pad * 4 * 2 / (th["panel_gather_gbps"] * 1e3)
    return dict(
        plan_bytes_cap=plan_bytes_cap,
        step_us=th["panel_step_us"],
        strip_us=th["panel_strip_us"],
        hbm_gbps=th["panel_hbm_gbps"],
        perm_us=perm_us, reorder=reorder_rows,
        val_bytes=2 if plan_values_bf16_exact(rows, cols, values, k)
        else 4)


def b_value_bytes(b_dtype) -> int:
    """Bytes of one B value as the strip kernels read it: 2 for bf16, 4
    for anything else (served as f32)."""
    return 2 if b_dtype == torch.bfloat16 else 4


def _panel_key(n_pad, tm, tk, panel_strips, reorder_rows, plan_bytes_cap,
               th: dict, b_dtype=torch.float32) -> tuple:
    """The container-cache key of a panel geometry: the resolver's
    arguments (a searched tm / tk as its candidate tuple), the device's
    cost constants and B's value bytes (the autotuner pins the geometry it
    measured per B dtype; the JAX package's key has no dtype)."""
    return ("panel_geom", TM_CANDIDATES if tm is None else tm,
            TK_CANDIDATES if tk is None else tk, panel_strips, reorder_rows,
            n_pad, plan_bytes_cap, tuple(sorted(th.items())),
            b_value_bytes(b_dtype))


def _panel_entry(geom) -> dict | None:
    """A panel geometry as the disk cache stores it: the row order by its
    kind (one sort rebuilds the permutation), None for "inadmissible"."""
    if geom is None:
        return None
    return {"p": int(geom.panel_strips), "sm": int(geom.sm),
            "plan_bytes": int(geom.plan_bytes), "tm": int(geom.tm),
            "order": geom.order_kind, "tk": int(geom.tk),
            "cost": None if geom.cost_us is None else float(geom.cost_us)}


def _panel_from_entry(entry: dict, rows, cols, m: int) -> PanelGeometry:
    tk = int(entry["tk"])  # the order's keys are at the stored tk's tiling
    perm = (None if entry["order"] == "natural"
            else _order_perm(rows, cols, m, cols // tk, entry["order"]))
    return PanelGeometry(int(entry["p"]), perm, int(entry["sm"]),
                         int(entry["plan_bytes"]), int(entry["tm"]),
                         entry["order"], tk, entry.get("cost"))


def resolve_panel_geometry(a, n_pad: int = 256, tm: int | None = None,
                           tk: int | None = None,
                           panel_strips: int | None = None,
                           reorder_rows: bool = True,
                           plan_bytes_cap: int | None = None,
                           device="cpu", b_dtype=torch.float32):
    """The panel geometry for a container (single supertile): a
    PanelGeometry, or None when no candidate passes ``plan_bytes_cap``.

    ``panel_strips=None`` searches P; an int pins it (degrading to smaller
    candidates only when it is inadmissible).  ``tm=None`` / ``tk=None``
    search the strip heights / k-tile widths; ints pin them.  The cost
    constants are ``dispatch.thresholds(device)``.  Cached on the
    container and in the geometry disk cache (:func:`geom_disk_path`) per
    B dtype (``b_dtype``, the serving operand's), so a geometry
    :func:`pin_panel_geometry` recorded for that dtype is what every later
    resolve returns, in this process and the next."""
    from tpuspmm_torch.kernels.dispatch import thresholds
    from tpuspmm_torch.ops.xla import coo_view

    th = thresholds(device)
    key = _panel_key(n_pad, tm, tk, panel_strips, reorder_rows,
                     plan_bytes_cap, th, b_dtype)
    cache = container_cache(a)
    if key in cache:
        return cache[key]

    coo = coo_view(a)
    m, k = coo.shape
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    hit, entry = geom_disk_load(a, key, device)
    if hit:
        geom = None if entry is None else _panel_from_entry(entry, rows,
                                                            cols, m)
        cache[key] = geom
        return geom
    kwargs = _panel_model_kwargs(th, m, k, n_pad, plan_bytes_cap,
                                 reorder_rows, rows, cols, coo.values)
    tm_arg, tk_arg = key[1], key[2]
    if panel_strips is not None:
        g = _geometry_search(rows, cols, m, k, tm_arg, tk_arg,
                             (panel_strips,), prefer=panel_strips, **kwargs)
        if g is None:  # pinned P inadmissible — degrade, don't refuse
            smaller = tuple(c for c in STRIP_CANDIDATES if c < panel_strips)
            if smaller:
                g = _geometry_search(rows, cols, m, k, tm_arg, tk_arg,
                                     smaller, prefer=smaller[0], **kwargs)
    else:
        g = _geometry_search(rows, cols, m, k, tm_arg, tk_arg,
                             STRIP_CANDIDATES, prefer=16, **kwargs)
    geom = None if g is None else PanelGeometry(*g)
    geom_disk_store(a, key, _panel_entry(geom), device)
    cache[key] = geom
    return geom


def resolve_panel_geometry_candidates(a, n_pad: int = 256, k: int = 3,
                                      panel_strips: int | None = None,
                                      reorder_rows: bool = True,
                                      plan_bytes_cap: int | None = None,
                                      device="cpu"):
    """The model's top-``k`` distinct panel geometries, cheapest modelled
    first with the plain search's pick leading, for the autotuner to
    measure and pin the winner (:func:`pin_panel_geometry`).  Not cached:
    a host search, cheap next to measuring one candidate."""
    from tpuspmm_torch.kernels.dispatch import thresholds
    from tpuspmm_torch.ops.xla import coo_view

    th = thresholds(device)
    coo = coo_view(a)
    m, kk = coo.shape
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    kwargs = _panel_model_kwargs(th, m, kk, n_pad, plan_bytes_cap,
                                 reorder_rows, rows, cols, coo.values)
    strips = (STRIP_CANDIDATES if panel_strips is None
              else (panel_strips,))
    out = _geometry_search(rows, cols, m, kk, TM_CANDIDATES, TK_CANDIDATES,
                           strips, prefer=16 if panel_strips is None
                           else panel_strips, topk=k, **kwargs)
    return [PanelGeometry(*g) for g in out]


def pin_panel_geometry(a, geom, n_pad: int = 256, tm: int | None = None,
                       tk: int | None = None,
                       panel_strips: int | None = None,
                       reorder_rows: bool = True,
                       plan_bytes_cap: int | None = None,
                       device="cpu", b_dtype=torch.float32,
                       disk: bool = True) -> None:
    """Record ``geom`` as the geometry :func:`resolve_panel_geometry`
    returns for these arguments and B dtype: on the container, and with
    ``disk`` in the geometry disk cache too, so a serving process that
    starts later dispatches what the autotuner measured fastest.
    ``disk=False`` pins the container only (a candidate while it is
    measured)."""
    from tpuspmm_torch.kernels.dispatch import thresholds

    key = _panel_key(n_pad, tm, tk, panel_strips, reorder_rows,
                     plan_bytes_cap, thresholds(device), b_dtype)
    container_cache(a)[key] = geom
    if disk:
        geom_disk_store(a, key, _panel_entry(geom), device)


# ---------------------------------------------------------------------------
# geometry disk cache: the panel and pair searches are determined by the
# matrix, the resolver's arguments and the device's constants, and a pinned
# geometry was measured on one card, so both are stored per (matrix digest,
# key, card) and a serving process that restarts skips the search.  On a
# CPU device the default path is neither read nor written (a geometry timed
# on the CPU means nothing on the card); TPUSPMM_TORCH_GEOM_CACHE names a
# file that is, on any device.
# ---------------------------------------------------------------------------

def geom_disk_path(device="cpu") -> str | None:
    """The geometry cache file for ``device``, or None when there is none
    (a CPU device with TPUSPMM_TORCH_GEOM_CACHE unset)."""
    return disk_cache.cache_path("TPUSPMM_TORCH_GEOM_CACHE", "geom.json",
                                 device)


def geom_disk_key(a, key: tuple, device) -> str:
    """Disk key of a resolver key: the matrix digest, the key (the cost
    constants included) and the card's name."""
    from tpuspmm_torch.engine.report import detect_card

    return (f"v1:{disk_cache.matrix_digest(a)}:{detect_card(device)}:"
            + ":".join(map(str, key)))


def geom_disk_load(a, key: tuple, device) -> tuple:
    """(True, entry) when the cache holds the geometry of ``key`` for
    ``a`` (entry None: none is admissible), else (False, None)."""
    path = geom_disk_path(device)
    if path is None:
        return False, None
    data = disk_cache.read(path)
    dkey = geom_disk_key(a, key, device)
    return (True, data[dkey]) if dkey in data else (False, None)


def geom_disk_store(a, key: tuple, entry, device) -> None:
    path = geom_disk_path(device)
    if path is not None:
        disk_cache.write(path, geom_disk_key(a, key, device), entry)


def panel_plan_from_geometry(a, geom: PanelGeometry) -> PanelPlan:
    """Build (or fetch the cached) PanelPlan for a geometry; the cache key
    is the geometry's content (tm, tk, P, sm, permutation bytes)."""
    perm = geom.row_perm
    m_pad = round_up(int(a.shape[0]), geom.tm)
    sm = geom.sm if geom.sm != m_pad else None
    fp = None if perm is None else hash(np.asarray(perm).tobytes())
    key = ("panel", geom.tm, geom.tk, geom.panel_strips, sm, fp)
    cache = container_cache(a)
    if key not in cache:
        from tpuspmm_torch.ops.xla import coo_view

        coo = coo_view(a)
        cache[key] = build_panel_plan(
            coo.rows, coo.cols, coo.values, coo.shape, tm=geom.tm,
            tk=geom.tk, panel_strips=geom.panel_strips, sm=sm,
            row_perm=perm)
    return cache[key]


def panel_plan_from_container(a, tm: int | None = None,
                              tk: int | None = None,
                              panel_strips: int | None = None,
                              sm: int | None = None,
                              reorder_rows: bool = True,
                              n_pad: int = 256,
                              device="cpu") -> PanelPlan:
    """Resolve the geometry and build (or fetch) the PanelPlan.  An explicit
    ``sm`` splits the output into supertiles of sm rows."""
    geom = resolve_panel_geometry(a, n_pad=n_pad, tm=tm, tk=tk,
                                  panel_strips=panel_strips,
                                  reorder_rows=reorder_rows, device=device)
    if sm is not None:
        if sm % geom.tm:
            # a supertile the searched strip height cannot divide:
            # re-resolve at tm=8, which divides every valid sm
            geom = resolve_panel_geometry(a, n_pad=n_pad, tm=8, tk=tk,
                                          panel_strips=panel_strips,
                                          reorder_rows=reorder_rows,
                                          device=device)
        geom = geom._replace(sm=sm)
    return panel_plan_from_geometry(a, geom)


def normalize_panel_mode(mode: str) -> str:
    """Public tier names of the panel family to the internal ones:
    "highest" (gate-exact) stays, "split2" (2-term bf16 splits,
    verified-only) becomes "split".  "split", the robust 3-term tier of
    the one-hot kernels, is refused here."""
    if mode == "split2":
        return "split"
    if mode == "highest":
        return mode
    raise ValueError(
        f"panel-family mode must be 'highest' or 'split2', got {mode!r}")


def panel_matmul(a_panel: torch.Tensor, b_tile: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """The precision ladder of the panel-family kernels (the TPU's
    ``panel_matmul``) in float32 matmuls: each bf16 term is exact in f32,
    so the terms and their order are the TPU kernel's.

    - a bf16 & b bf16: one exact product.
    - a bf16, b f32: 3 bf16 terms of B ("highest"), 2 for "split".
    - a f32, "split": hi·hi + lo·hi + hi·lo (2 terms of A with bf16 B).
    - a f32, b bf16: 3 bf16 terms of A.
    - a f32, b f32, "highest": one f32 product."""
    def _dot(x, y):
        return torch.matmul(x.float(), y.float())

    a_exact = a_panel.dtype == torch.bfloat16
    b_exact = b_tile.dtype == torch.bfloat16
    if a_exact and b_exact:
        return _dot(a_panel, b_tile)
    if a_exact:
        parts = split_bf16(b_tile, 2 if mode == "split" else 3)
        return functools.reduce(operator.add,
                                [_dot(a_panel, p) for p in parts])
    if mode == "split":
        a_hi, a_lo = split_bf16(a_panel, 2)
        if b_exact:
            return _dot(a_hi, b_tile) + _dot(a_lo, b_tile)
        b_hi, b_lo = split_bf16(b_tile, 2)
        return _dot(a_hi, b_hi) + _dot(a_lo, b_hi) + _dot(a_hi, b_lo)
    if b_exact:
        parts = split_bf16(a_panel, 3)
        return functools.reduce(operator.add,
                                [_dot(p, b_tile) for p in parts])
    return _dot(a_panel, b_tile)


# bytes of gathered B tiles and products per batch of the plain versions
PLAIN_BATCH_BYTES = 256 * 1024 * 1024


def slab_rows(st, offs, sm: int, tm: int) -> torch.Tensor:
    """Row of the slab layout (per-supertile trash strip included,
    n_st·(sm+tm) rows) for every plan row: st·(sm+tm) + offs + r, with st
    (n,) and offs (n, strips)."""
    base = st.long().unsqueeze(-1) * (sm + tm) + offs.long()
    return (base.unsqueeze(-1)
            + torch.arange(tm, device=base.device)).reshape(-1)


def panel_spmm_plain(plan: PanelPlan, b: torch.Tensor,
                     mode: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of the panel kernel on b's device:
    :func:`panel_slab_plain` over the plan's arrays, then
    :func:`finish_panel_output`."""
    arrs = plan.device_arrays(b.device)
    return finish_panel_output(panel_slab_plain(plan, arrs, b, mode), plan,
                               arrs, int(b.shape[1]))


def panel_slab_plain(plan: PanelPlan, arrs: dict, b: torch.Tensor,
                     mode: str = "highest") -> torch.Tensor:
    """The panel product in the slab layout (n_st·(sm+tm) rows,
    round_up(N, 128) columns) from the plan arrays in ``arrs`` (kt, st,
    offs, a_dense on b's device): per panel, a batched product of the
    stacked strips with the gathered B tiles through :func:`panel_matmul`,
    added into the slab by ``offs`` (``index_add_``)."""
    mode = normalize_panel_mode(mode)
    n = int(b.shape[1])
    n_pad = round_up(n, 128)
    P, tm, tk = plan.panel_strips, plan.tm, plan.tk
    b_tiles = pad_b(b, plan.num_k_tiles * tk, n_pad).reshape(
        plan.num_k_tiles, tk, n_pad)
    a3 = arrs["a_dense"].reshape(plan.n_panels, P * tm, tk)
    rows = slab_rows(arrs["st"], arrs["offs"], plan.sm, tm)
    out = torch.zeros(plan.n_supertiles * (plan.sm + tm), n_pad,
                      dtype=torch.float32, device=b.device)
    batch = max(1, PLAIN_BATCH_BYTES // ((tk + P * tm) * n_pad * 4))
    for p0 in range(0, plan.n_panels, batch):
        p1 = min(p0 + batch, plan.n_panels)
        acc = panel_matmul(a3[p0:p1], b_tiles[arrs["kt"][p0:p1].long()],
                           mode)
        out.index_add_(0, rows[p0 * P * tm:p1 * P * tm],
                       acc.reshape(-1, n_pad))
    return out


def finish_panel_output(out: torch.Tensor, plan, arrs: dict,
                        n: int) -> torch.Tensor:
    """Shared epilogue of the panel-family paths: drop each supertile's
    trash strip when ``out`` is in the slab layout (n_st·(sm+tm) rows, what
    the plain versions accumulate into; the strip-owner kernel writes the
    trash-free n_st·sm rows), restore the original row order of a
    row-permuted plan, and slice to (m, n)."""
    n_st, sm, tm = plan.n_supertiles, plan.sm, plan.tm
    if out.shape[0] == n_st * (sm + tm):
        out = out.reshape(n_st, sm + tm, -1)[:, :sm].reshape(n_st * sm, -1)
    if plan.row_perm is not None:
        return out.index_select(0, arrs["inv"])[:, :n]
    return out[:plan.shape[0], :n]


def check_operand(plan, b: torch.Tensor) -> None:
    """Refuse a dense operand that does not fit the plan."""
    if b.dim() != 2 or b.shape[0] != plan.shape[1]:
        raise ValueError(f"b must be (K={plan.shape[1]}, N), got "
                         f"{tuple(b.shape)}")


def spmm_panel(a_or_plan, b: torch.Tensor, mode: str = "highest",
               tm: int | None = None, tk: int | None = None,
               panel_strips: int | None = None) -> torch.Tensor:
    """Container- or plan-level entry of the panel kernel.

    On a CUDA tensor it launches the strip-owner kernel (``csrc/
    strip_spmm.cu``, ``panel_strip_spmm``, GROUP_ROWS rows a block) or
    raises; on a CPU tensor it runs :func:`panel_spmm_plain`.  ``mode``:
    "highest" (gate-exact) or "split2" (verified-only).  A container
    resolves its geometry for b's device (single supertile)."""
    split2 = normalize_panel_mode(mode) == "split"  # before planning
    n = int(b.shape[1])
    if isinstance(a_or_plan, PanelPlan):
        plan = a_or_plan
    else:
        geom = resolve_panel_geometry(a_or_plan, round_up(n, 128), tm=tm,
                                      tk=tk, panel_strips=panel_strips,
                                      plan_bytes_cap=PLAN_BYTES_CAP,
                                      device=b.device, b_dtype=b.dtype)
        if geom is None:
            raise ValueError(
                f"no panel geometry admissible at width {n}: every "
                "candidate plan exceeds PLAN_BYTES_CAP")
        plan = panel_plan_from_geometry(a_or_plan, geom)
    check_operand(plan, b)
    if b.device.type == "cpu":
        return panel_spmm_plain(plan, b, mode)
    from tpuspmm_torch.kernels import strip_cuda

    arrs = plan.device_arrays(b.device)
    out = strip_cuda.strip_spmm("panel_strip_spmm", arrs, b,
                                plan.n_out_strips, plan.tm, plan.tk, split2)
    spmm_panel.launches += 1
    return finish_panel_output(out, plan, arrs, n)


spmm_panel.launches = 0
