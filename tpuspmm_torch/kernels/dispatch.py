"""Best-kernel dispatch for the serving path, every format.

Counterpart of ``tpuspmm/kernels/dispatch.py::spmm_pallas``.  JAX's
admission rules decide which routes are candidates:

1. a matrix that needs the compensated path and can afford it routes
   there (``ops/exact.py``);
2. a BSR whose blocks K6 admits (``bsr_spmm.mxu_friendly``) takes the
   block-streaming kernel; another BSR takes it on its 128 × 128 packed
   copy where ``bsr_spmm.pack_blocks`` allows one ("bsr_stream"); any
   other BSR, and every ELL or CSC, goes on through its COO view, as in
   the JAX package;
3. densify (once, then one f32 matmul a serve, ``ops/xla.py``) with
   dense A ≤ densify_max_bytes and density ≥ densify_min_density;
4. the panel (K1) and pair (K2) geometries, resolved with this device's
   cost constants within its panel_max_plan_bytes, served at the
   "highest" tier whatever ``config.precision_mode`` says (as the JAX
   package does: the 2-term tier is verified-only);
5. with ≥ tile_min_nnz_per_chunk nonzeros per tile-plan chunk, the tile
   family member by residency: staged (K4) when the whole B stripe
   stages in one slab, else C-resident (K5a) when an owner's accumulator
   fits, else tile (K3), at ``config.precision_mode``.  An owner's
   accumulator is tile_m × 64 f32, so on an H100 (232,448 bytes of opt-in
   shared memory per block) the tile branch is reached only when tile_m >
   908;
6. the gather path (``ops/xla.py``) when nothing else admits.

Under a row with a serve-time model (every key of SERVE_TERMS, as the
H100 row has) each admitted route of steps 3-5 is priced
(:func:`route_costs`) and the least modelled serve time serves, a tie to
JAX's order.  A row without those keys (each of JAX's per-chip rows)
routes in JAX's fixed order: the first admitted of steps 3-6, panel or
pair by the lower geometry ``cost_us``.

The decision, what it serves from and the route's launch are one handle
(:class:`Served`), built once per (B width, B dtype, device, config, row)
and cached on the container, as the JAX package's ``jax.jit`` traces a
``pallas_call`` once per signature: a repeat serve checks B and
launches, and resolves, prices and checks the plan no more.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch
from torch.autograd import profiler as torch_profiler

from tpuspmm_torch.config import default_config
from tpuspmm_torch.engine.report import HBM_GBPS
from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.kernels.common import round_up
from tpuspmm_torch.utils import profiling

TILE_FAMILY = ("staged", "cres", "tile")
# the serve-time model: each route family's row keys, the coefficient of
# one term each (µs a unit; the units are ``route_features``'); the first,
# the fixed term, is the family's host work a serve, the rest its device
# work (``price``)
SERVE_TERMS = {
    "densify": ("serve_densify_us", "serve_densify_f32_us_per_gmac",
                "serve_densify_bf16_us_per_gmac"),
    "panel": ("serve_panel_us", "serve_panel_model",
              "serve_panel_entry_us_per_mcol", "serve_panel_b_us_per_mb",
              "serve_panel_tc_us_per_gflop", "serve_panel_group_us_per_step"),
    "pair": ("serve_pair_us", "serve_pair_model",
             "serve_pair_entry_us_per_mcol", "serve_pair_b_us_per_mb",
             "serve_pair_tc_us_per_gflop", "serve_pair_group_us_per_step"),
    "tile": ("serve_tile_us", "serve_tile_dense_f32_us_per_gmac",
             "serve_tile_dense_bf16_us_per_gmac",
             "serve_tile_gather_us_per_mcol",
             "serve_tile_straggler_us_per_mcol", "serve_tile_b_us_per_mb"),
}
# streaming multiprocessors of the card the row was fitted on (H100 SXM):
# the tile family's column tile and straggler term read it on every
# device, so the CPU prices as that card does
H100_SMS = 132

# The H100 row: every key of the JAX package's per-chip row
# (``tpuspmm/kernels/dispatch.py::_CHIP_THRESHOLDS``), each one measured
# on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi).
# - densify_min_density, densify_max_bytes, tile_min_nnz_per_chunk,
#   panel_max_plan_bytes and panel_gather_gbps: tools/fit_routing.py from
#   tools/routing_h100.jsonl (244 records), serve times through
#   tpuspmm_torch.spmm on both sides of each constant (CUDA events,
#   median of 20 serves, plan prebuilt), measured under this row:
#   - densify_min_density: least regret over 116 records (uniform 2048²
#     and 4096² at 0.0005-0.2, w256 / w1024; the pruned 4096² weights;
#     the corpus; f32 and bf16 B), the measured density of
#     uniform_4096_d0.001 (geometric-mean regret 1.135);
#   - densify_max_bytes: densify is least regret on dense A of 64 and
#     256 MiB and not at 1 GiB;
#   - tile_min_nnz_per_chunk: least regret over 72 records, the tile
#     family against the gather path: the fewest nonzeros per chunk
#     measured (uniform_16384_r4); the tile family won every record;
#   - panel_max_plan_bytes: the largest panel plan measured serving
#     faster than the route the cap below it gives (8192² at 0.016 and,
#     with bf16 B, 0.2);
#   - panel_gather_gbps: the un-permute's row gather, 20000 × 256 f32,
#     bytes read and written over its median time.
# - panel_step_us (per panel or pair chunk), panel_strip_us (per strip)
#   and panel_hbm_gbps (the plan stream's effective rate): tools/
#   fit_panel_model.py from tools/ablate_panel_h100.jsonl, 55 gate-passing
#   panel "highest" records of 5 matrices at B width 256, device time
#   (the launch replayed in a CUDA graph), residual RMS 0.0885 ms on
#   0.107-0.624 ms launches.  The residual is large because the strip
#   kernel's time follows its (64-row group, k-tile) entries and B
#   traffic, which the model does not count (PERF.md).  So the fitted
#   panel_hbm_gbps is a cost term (JAX's name), not the card's memory
#   rate: a roofline reads engine/report.hbm_gbps instead.
# - serve_* (the serve-time model, SERVE_TERMS): tools/fit_routing.py from
#   the same file's 170 "routes" records: every route JAX's rules admit
#   on 85 operands (the density set, the pruned weights, uniform 16384²,
#   the corpus at w256 / w512, medium_4096, large_15120 and medium_2048
#   at their on-disk B), f32 and bf16 B, each pinned, gated and timed in
#   five interleaved rounds, served from the served handle (`served`);
#   non-negative least squares in relative error, the device terms
#   against the graph-replayed device time (panel's and pair's together:
#   one kernel, one set of coefficients), one host term for every family
#   (one host path: the handle's launch) against the serve time of
#   host-bound serves.  The fit zeroes some terms (the strip routine's
#   entries, the tile family's gathered nonzeros): the tensor-core
#   products, the heaviest group and the heaviest warp carry those
#   routes' time.  Geometric-mean regret over the 138 records with two or
#   more routes: 1.046 priced, 2.469 in JAX's order under this row
#   (PERF.md).
# The row was measured on the SXM part; other H100s read it too.  The
# "cpu" row is the same row, so the CPU tests pick the route the card
# picks.
H100_FIT = {"densify_max_bytes": 268435456,
            "densify_min_density": 0.0009999275207519531,
            "tile_min_nnz_per_chunk": 4.069547938400397,
            "panel_max_plan_bytes": 268435456,
            "panel_step_us": 0.022, "panel_strip_us": 0.01041,
            "panel_hbm_gbps": 221.4,
            "panel_gather_gbps": 1238.5,
            "serve_densify_us": 42.6649,
            "serve_densify_f32_us_per_gmac": 43.0719,
            "serve_densify_bf16_us_per_gmac": 44.6969,
            "serve_panel_us": 42.6649, "serve_panel_model": 0.0124357,
            "serve_panel_entry_us_per_mcol": 0.0,
            "serve_panel_b_us_per_mb": 0.0430545,
            "serve_panel_tc_us_per_gflop": 4.39887,
            "serve_panel_group_us_per_step": 1.55222,
            "serve_pair_us": 42.6649, "serve_pair_model": 0.0124357,
            "serve_pair_entry_us_per_mcol": 0.0,
            "serve_pair_b_us_per_mb": 0.0430545,
            "serve_pair_tc_us_per_gflop": 4.39887,
            "serve_pair_group_us_per_step": 1.55222,
            "serve_tile_us": 42.6649,
            "serve_tile_dense_f32_us_per_gmac": 0.0,
            "serve_tile_dense_bf16_us_per_gmac": 3.80731,
            "serve_tile_gather_us_per_mcol": 0.0,
            "serve_tile_straggler_us_per_mcol": 1815.59,
            "serve_tile_b_us_per_mb": 4.39559}


# unrecorded card names already warned of (one warning a name a process)
_UNRECORDED = set()


def thresholds(device="cpu") -> dict:
    """Routing and cost constants for ``device``: the H100 row, for a CPU
    device and for any CUDA device.  A card whose name is not on record
    (``engine/report.HBM_GBPS``) is served with the H100 row too, as the
    JAX package serves an unknown chip with a known row, with one warning
    a card name."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if name not in HBM_GBPS and name not in _UNRECORDED:
            _UNRECORDED.add(name)
            warnings.warn(f"no routing row on record for {name!r}: routing "
                          "with the H100 row (H100_FIT)", stacklevel=2)
    elif device.type != "cpu":
        raise ValueError(f"no cost constants for device {device}")
    return dict(H100_FIT)


def route(a, b: torch.Tensor, config=None) -> str:
    """The path ``spmm_pallas`` serves (a, b) by: "exact", "bsr_stream",
    "densify", "panel", "pair", "staged", "cres", "tile" or "xla" (the
    route of its handle, :func:`served`, built here if need be)."""
    return served(a, b, config).route


def priced(th: dict) -> bool:
    """Whether a row prices the admitted routes (it holds every key of
    SERVE_TERMS); a row without them, as each of JAX's, routes in JAX's
    order."""
    return all(key in th for terms in SERVE_TERMS.values() for key in terms)


def family(kind: str) -> str:
    """The serve-model family of a route: a tile-family member is "tile"."""
    return "tile" if kind in TILE_FAMILY else kind


def _densify_ok(a, th: dict) -> bool:
    m, k = a.shape
    return (m * k * 4 <= th["densify_max_bytes"]
            and a.sparsity >= th["densify_min_density"])


def _geometries(a, b: torch.Tensor, config, th: dict) -> tuple:
    """(panel geometry, pair geometry), each None where the row's plan cap
    refuses it; resolved (and cached) with the row's cost constants."""
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm

    n_pad = round_up(int(b.shape[1]), 128)
    cap = th["panel_max_plan_bytes"]
    geom = panel_spmm.resolve_panel_geometry(
        a, n_pad, panel_strips=config.panel_strips, plan_bytes_cap=cap,
        device=b.device, b_dtype=b.dtype)
    pgeom = pair_spmm.resolve_pair_geometry(a, n_pad, plan_bytes_cap=cap,
                                            device=b.device, b_dtype=b.dtype)
    return geom, pgeom


def _tile_member(a, b: torch.Tensor, config, th: dict) -> tuple:
    """(the tile-family member the card's residency rule picks, or None
    below tile_min_nnz_per_chunk; the tile plan the rule reads)."""
    from tpuspmm_torch.formats.tiles import plan_from_container
    from tpuspmm_torch.kernels import cres_spmm, csr_vmem

    plan = plan_from_container(a, tile_m=config.tile_m,
                               tile_k=config.tile_k, chunk=config.chunk_nnz)
    if a.nnz / max(plan.num_chunks, 1) < th["tile_min_nnz_per_chunk"]:
        return None, plan
    k_pad = plan.num_k_tiles * plan.tile_k
    if csr_vmem.fits_whole_b(k_pad, plan.tile_m, plan.tile_k, b.device):
        return "staged", plan
    if cres_spmm.fits_card_out(plan.tile_m, b.device):
        return "cres", plan
    return "tile", plan


def _strip_plan(kind: str, a, geom, b: torch.Tensor):
    """The panel or pair plan of a resolved geometry."""
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm

    if kind == "panel":
        return panel_spmm.panel_plan_from_geometry(a, geom)
    return pair_spmm.pair_plan_from_container(
        a, chunk_strips=geom.chunk_strips,
        n_pad=round_up(int(b.shape[1]), 128), geom=geom, device=b.device)


def _admitted(a, b: torch.Tensor, config, th: dict) -> dict:
    """{route: what its terms are read from} for every route the row's
    admission rules admit past exact and bsr_stream, in JAX's order:
    densify (None), panel and pair (their geometries), the tile-family
    member (its plan).  Builds no panel or pair plan."""
    out = {}
    if _densify_ok(a, th):
        out["densify"] = None
    geom, pgeom = _geometries(a, b, config, th)
    if geom is not None:
        out["panel"] = geom
    if pgeom is not None:
        out["pair"] = pgeom
    member, plan = _tile_member(a, b, config, th)
    if member is not None:
        out[member] = plan
    return out


def _strip_terms(a, geom, tm: int, tk: int, kind: str, n: int,
                 bf16_b: bool) -> dict:
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm
    from tpuspmm_torch.ops.xla import coo_view

    perm = geom.row_perm
    fp = None if perm is None else hash(np.asarray(perm).tobytes())
    cache = container_cache(a)
    key = ("strip_layout", tm, tk, fp)
    coo = coo_view(a)
    if key not in cache:
        index = panel_spmm.layout_group_index(coo.rows, coo.cols, coo.shape,
                                              tm, tk, perm)
        bf16 = pair_spmm.plan_values_bf16_exact_cached(
            a, np.asarray(coo.rows, np.int64), np.asarray(coo.cols, np.int64),
            coo.values, coo.shape[1])
        cache[key] = (index, bf16)
    index, bf16 = cache[key]
    work = panel_spmm.strip_work(index, tm, tk, bf16, n)
    sfx = "_bf16" if bf16_b else ""
    return {f"serve_{kind}_us": 1.0,
            f"serve_{kind}_model": float(geom.cost_us),
            f"serve_{kind}_entry_us_per_mcol": work["group_pairs"] * n / 1e6,
            f"serve_{kind}_b_us_per_mb": work[f"b_mb_per_call{sfx}"],
            f"serve_{kind}_tc_us_per_gflop": work[f"tc_gflop{sfx}"],
            f"serve_{kind}_group_us_per_step": float(
                work[f"heaviest_group_steps{sfx}"])}


def _tile_terms(plan, member: str, b: torch.Tensor, config) -> dict:
    from tpuspmm_torch.kernels import chunk_cuda, cres_spmm, tile_spmm

    min_dense = tile_spmm.dense_min(plan.tile_k,
                                    config.precision_mode == "split2")
    index = tile_spmm.host_index(plan, min_dense)
    traffic = cres_spmm.b_traffic(plan, b, min_dense, H100_SMS)
    n = int(b.shape[1])
    # gathered nonzeros of each warp's rows (WARP_ROWS of a row tile)
    per_row = np.diff(index["row_ptr"].astype(np.int64))
    warp = np.add.reduceat(per_row, np.arange(0, len(per_row),
                                              chunk_cuda.WARP_ROWS)) \
        if len(per_row) else per_row
    straggler = float(warp.max(initial=0)) * traffic["column_tile"]
    dense = len(index["d_kt"]) * plan.tile_m * plan.tile_k * n / 1e9
    bf16 = b.dtype == torch.bfloat16
    return {"serve_tile_us": 1.0,
            "serve_tile_dense_f32_us_per_gmac": 0.0 if bf16 else dense,
            "serve_tile_dense_bf16_us_per_gmac": dense if bf16 else 0.0,
            "serve_tile_gather_us_per_mcol": len(index["g_val"]) * n / 1e6,
            "serve_tile_straggler_us_per_mcol": straggler / 1e6,
            "serve_tile_b_us_per_mb": traffic["b_panel_bytes"][
                "cluster" if member == "cres" else "owner"] / 1e6}


def route_features(a, b: torch.Tensor, config=None) -> dict:
    """{route: {row key: the term it multiplies}} for every route the
    row's admission rules admit past exact and bsr_stream (an empty dict
    when none does: the gather path serves), read from the geometries and
    the tile plan ``_resolve`` resolves and from A's coordinates:

    - densify: m·k·n (10^9 multiply-adds) at B's dtype;
    - panel / pair: the geometry search's ``cost_us``, the strip routine's
      (64-row group, k-tile) entries times n (10^6), the B bytes they
      load per call (MB) and the tensor-core products they run (GFLOP of
      the precision ladder; both ``panel_spmm.strip_work``), and the heaviest
      group's entries times the precision ladder's products an entry
      (1, 3 or 6): one block walks a group's entries in turn, so a
      matrix with few, long groups waits on that one;
    - the tile family: its dense tiles' tile_m·tile_k·n at B's dtype
      (10^9), its gathered nonzeros times n (10^6), the heaviest warp's
      gathered nonzeros (the 16 rows of a row tile one warp owns) times
      the column tile (10^6; the block's warps split its row tile, so
      nonzeros in a few rows finish last: the straggler of a matrix with
      few row tiles), and the B bytes its launch stages (MB;
      ``cres_spmm.b_traffic``, the cluster launch's for "cres", the owner
      routine's otherwise);
    - each route also a fixed term (1), its host work a serve.
    Every call recomputes; the served handle caches its decision."""
    config = config or default_config()
    th = thresholds(b.device)
    m, k = a.shape
    n = int(b.shape[1])
    bf16 = b.dtype == torch.bfloat16
    out = {}
    for kind, src in _admitted(a, b, config, th).items():
        if kind == "densify":
            mkn = m * k * n / 1e9
            out[kind] = {"serve_densify_us": 1.0,
                         "serve_densify_f32_us_per_gmac": 0.0 if bf16 else mkn,
                         "serve_densify_bf16_us_per_gmac": mkn if bf16
                         else 0.0}
        elif kind == "panel":
            out[kind] = _strip_terms(a, src, src.tm, src.tk, kind, n, bf16)
        elif kind == "pair":
            out[kind] = _strip_terms(a, src, 8, 128, kind, n, bf16)
        else:
            out[kind] = _tile_terms(src, kind, b, config)
    return out


def price(kind: str, terms: dict, th: dict) -> float:
    """A route's modelled serve time (µs): its host work a serve (the
    fixed term, ``serve_<family>_us``) or its device work (the other terms
    times the row's coefficients), whichever is longer, since back-to-back
    serves overlap one's host work with the device work before it."""
    host, *device = SERVE_TERMS[family(kind)]
    return max(th[host] * terms[host],
               float(sum(th[key] * terms[key] for key in device
                         if terms[key])))


def route_costs(a, b: torch.Tensor, config=None) -> dict:
    """{route: modelled serve µs} of every admitted route under the row
    (``route_features`` priced by its SERVE_TERMS coefficients), in JAX's
    order (``jax_rank``), which breaks a tie.  A row without them prices
    nothing: it raises."""
    th = thresholds(b.device)
    if not priced(th):
        raise ValueError("the row has no serve-time model (SERVE_TERMS): "
                         "it routes in JAX's order")
    features = route_features(a, b, config)
    return {kind: price(kind, features[kind], th)
            for kind in jax_rank(features)}


def jax_rank(features: dict) -> list:
    """The admitted routes (``route_features``) in JAX's fixed order:
    densify, panel and pair by the lower geometry ``cost_us`` (panel on a
    tie), the tile-family member."""
    strip = sorted((kind for kind in ("panel", "pair") if kind in features),
                   key=lambda kind: features[kind][f"serve_{kind}_model"])
    return ([k for k in ("densify",) if k in features] + strip
            + [k for k in TILE_FAMILY if k in features])


def cheapest(costs: dict) -> str:
    """The least modelled serve time of ``costs`` (listed in JAX's order,
    as ``route_costs`` lists them), a tie to the earlier; the gather path
    when nothing is admitted."""
    return min(costs, key=costs.get) if costs else "xla"


class Served:
    """The handle ``spmm_pallas`` serves an operand from, for one B width,
    B dtype and device under one config and row: the route, what the
    route serves from (``source``: the BSR K6 runs on, a panel, pair or
    tile plan, or None), the row it was resolved under (``row``) and
    ``launch(b)``, one serve.  On the card ``launch`` is the route's
    bound kernel launch (its plan checked once, when bound: ``bind`` in
    ``kernels/*_cuda.py``), the dense product on the cached dense A, or
    the plain-torch path (exact, xla); on the CPU it is the route's entry
    point, which runs the plain version.  ``span`` names ``launch``'s span,
    ``tpuspmm_torch.launch.<route>``."""

    __slots__ = ("route", "source", "row", "launch", "span")

    def __init__(self, route: str, source, row: dict, launch):
        self.route, self.source, self.row = route, source, row
        self.launch = launch
        self.span = f"tpuspmm_torch.launch.{route}"


def served(a, b: torch.Tensor, config=None) -> Served:
    """The handle ``spmm_pallas`` serves (a, b) from: built once per B
    width, B dtype, device and config (its fields' values, so a field
    changed in place builds another) and cached on the container; a row
    other than the one it was built under (a refit, a patched row) builds
    it again.  Building it runs everything the route needs (the
    compensated check, ``stream_operand``, the row, the pricing or JAX's
    order, the plans and their device arrays, the kernel's binding); a
    repeat serve runs none of it.  A build is the span
    ``tpuspmm_torch.served.build``, holding ``.decide`` (:func:`_decide`)
    and ``.bind`` (:func:`_launch`)."""
    config = config or default_config()
    key = ("served", int(b.shape[1]), b.dtype, b.device,
           tuple(vars(config).values()))
    cache = container_cache(a)
    handle = cache.get(key)
    if handle is None or handle.row != H100_FIT:
        with profiling.span("tpuspmm_torch.served.build"):
            row = dict(H100_FIT)
            with profiling.span("tpuspmm_torch.served.decide"):
                kind, source = _decide(a, b, config)
            with profiling.span("tpuspmm_torch.served.bind"):
                launch = _launch(kind, a, source, b, config)
            handle = cache[key] = Served(kind, source, row, launch)
    return handle


def _resolve(a, b: torch.Tensor, config=None):
    """(route, what that route serves from) of the handle (:func:`served`)."""
    handle = served(a, b, config)
    return handle.route, handle.source


def _decide(a, b: torch.Tensor, config):
    """(route, what that route serves from: the BSR K6 runs on, a panel or
    pair plan, a tile plan, or None)."""
    from tpuspmm_torch.kernels import bsr_spmm
    from tpuspmm_torch.ops import exact

    if exact.needs_compensated(a) and exact.exact_admissible(a):
        return "exact", None
    if a.format_name == "bsr":
        source = bsr_spmm.stream_operand(a)
        if source is not None:
            return "bsr_stream", source

    th = thresholds(b.device)
    if not priced(th):
        return _jax_order(a, b, config, th)
    kind = cheapest(route_costs(a, b, config))
    if kind in ("panel", "pair"):
        geom = _geometries(a, b, config, th)[kind == "pair"]
        return kind, _strip_plan(kind, a, geom, b)
    if kind in TILE_FAMILY:
        return kind, _tile_member(a, b, config, th)[1]
    return kind, None


def _launch(kind: str, a, source, b: torch.Tensor, config):
    """One serve of route ``kind`` from ``source`` for B of b's width,
    dtype and device: ``launch(b)`` is C."""
    from tpuspmm_torch.kernels import (bsr_spmm, cres_spmm, csr_vmem,
                                       pair_spmm, panel_spmm, tile_spmm)
    from tpuspmm_torch.ops import exact, xla

    if kind == "exact":
        return functools.partial(exact.spmm_exact, a)
    if kind == "xla":
        return functools.partial(xla.spmm_xla, a)
    if kind == "densify":
        return functools.partial(xla.dense_product,
                                 xla.dense_operand(a, b.device))
    mode = config.precision_mode
    # panel and pair serve at "highest" whatever the config says
    entry, bound, kwargs = {
        "bsr_stream": (bsr_spmm.spmm_bsr_stream, bsr_spmm.stream_launch, {}),
        "panel": (panel_spmm.spmm_panel, panel_spmm.panel_launch, {}),
        "pair": (pair_spmm.spmm_pair, pair_spmm.pair_launch, {}),
        "staged": (csr_vmem.spmm_staged, csr_vmem.staged_launch,
                   {"mode": mode}),
        "cres": (cres_spmm.spmm_cres, cres_spmm.cres_launch, {"mode": mode}),
        "tile": (tile_spmm.spmm_tiles, tile_spmm.tiles_launch,
                 {"mode": mode}),
    }[kind]
    if b.device.type == "cpu":
        return functools.partial(entry, source, **kwargs)
    return bound(source, b, **kwargs)


def _jax_order(a, b: torch.Tensor, config, th: dict):
    """JAX's fixed order past exact and bsr_stream: densify, then panel or
    pair by the lower ``cost_us``, then the tile family, then the gather
    path; each plan built only where the steps before refused."""
    if _densify_ok(a, th):
        return "densify", None
    geom, pgeom = _geometries(a, b, config, th)
    if (geom is not None and pgeom is not None
            and pgeom.cost_us < geom.cost_us):
        geom = None  # pair's modelled serve time wins
    if geom is not None:
        return "panel", _strip_plan("panel", a, geom, b)
    if pgeom is not None:
        return "pair", _strip_plan("pair", a, pgeom, b)
    member, plan = _tile_member(a, b, config, th)
    if member is not None:
        return member, plan
    return "xla", None


def spmm_pallas(a, b: torch.Tensor, config=None) -> torch.Tensor:
    """Best-strategy SpMM (the "pallas" / "auto" path) on b's device,
    served from the operand's handle (:func:`served`).  While a profiler
    records, the lookup is the span ``tpuspmm_torch.served`` and the
    launch the handle's (``Served.span``), one after the other."""
    b = b.contiguous()
    if not torch_profiler._is_profiler_enabled:
        return served(a, b, config).launch(b)
    with profiling.span("tpuspmm_torch.served"):
        handle = served(a, b, config)
    with profiling.span(handle.span):
        return handle.launch(b)
