"""Measure and fit the dispatcher's routing constants on the card.

The JAX package fits its dispatch row per chip (``tpuspmm/kernels/
dispatch.py``: thresholds from measured device times, one row a chip).
This tool does the same for the port's H100 row (``kernels/
dispatch.H100_FIT``): each constant is read from the crossover between
the two routes it chooses between, in serve time on the card.

    python -m tpuspmm_torch.tools.fit_routing --measure \\
        --out chiprun_out/routing_h100.jsonl          # on the card
    python -m tpuspmm_torch.tools.fit_routing \\
        tpuspmm_torch/tools/routing_h100.jsonl         # anywhere: the row

``--measure`` times each operand below through ``tpuspmm_torch.spmm`` on
both sides of one constant: "on", the route the row gives with the
constant moved so that it admits the operand (densify, the tile family,
the panel plan), and "off", the route with the constant moved past it,
each in JAX's fixed order (the row without its serve-time model, whose
constants these are).  The row is patched inside the measurement only.
A side's time is CUDA events, the median of 20 serves after the plan is
built (``ms``), with the call's graph replay beside it (``device_ms``)
where the route captures.
Each record carries the operand, the B dtype, both sides' routes, times
and gate verdicts (the reference's gate against an f64 product), the
seconds the first serve took with its plan build (``build_s``), and the
card's name and power limit (``nvidia-smi``).  Where both sides take one
route the record says so and times nothing.  With no card it exits 2.

The fit set and the rule for each constant:

- densify_min_density: uniform random 2048² and 4096² (values U(-1, 1),
  seed 0) at DENSITIES, B widths 256 and 1024; the pruned 4096² weights
  (PRUNED: 4 × 4 blocks at 80-99% block sparsity, 128 × 128 at 90%,
  served as CSR, w512, B standard_normal · 0.05, as ``sweeps/
  pruned_llm``); the 12 corpus dirs at their on-disk B.  Least regret: of
  the measured densities, the t that minimises the geometric mean, over
  every record, of (serve time under t) / (the faster side's time); a
  tie goes to the larger t.
- densify_max_bytes: dense A of 64 MiB, 256 MiB and 1 GiB (BYTES_DIMS) at
  three of the measured densities at or above the fitted floor (the
  floor, the middle one, the largest), w256, the floor held at the fitted
  value.  The cap is the largest size up to which densify is the
  least-regret side at every size; where it is not at the smallest, the
  largest dense A that densifies among the corpus dirs' records.  A size
  whose first operand took over BUILD_LIMIT_S to build is dropped, and
  the drop recorded.
- tile_min_nnz_per_chunk: the tile family against the gather path with
  densify and the panel / pair plans refused (the row's plan cap at 0):
  uniform random 16384² at TILE_ROW_NNZ nonzeros a row, and every corpus
  dir, at w256 and w512.  The same least-regret rule over the measured
  nonzeros per tile-plan chunk.
- panel_gather_gbps: the panel's un-permute, the row gather through a
  plan's ``inv`` index (``panel_spmm.finish_panel_output``), at m = 20000
  and n 256 and 1024: bytes (m·n·4·2) over the median time.  The row takes
  the w256 rate.
- panel_max_plan_bytes: on the densify_max_bytes operands served by panel
  or pair once densify is refused, that plan against the route the row
  gives with the cap just below it.  The cap is the largest plan the
  records show serving faster; where no plan reaches PLAN_FLOOR it stays
  at PLAN_CAP, the package-wide cap (``panel_spmm.PLAN_BYTES_CAP``).

Beside the fit set, the "served" group (measured by default, not
fitted) records every corpus dir's default serve at w256 beside the tile
family's and cuSPARSE's (``served_records``).

The "routes" group fits the dispatcher's serve-time model (``kernels/
dispatch.SERVE_TERMS``): for each operand and B dtype, every route the
row's admission rules admit (densify, panel, pair, the tile family; the
gather path only where nothing else admits) is served
through ``spmm``, pinned by a patched row (every other family's fixed
term infinite, ``forced``), gated and timed, with the terms
``dispatch.route_features`` reads for it.  The operands: the density
set (uniform 2048² / 4096², w256 / w1024), the pruned weights (w512),
uniform 16384² at TILE_ROW_NNZ a row (w256 / w512), the corpus at w256
and w512 (large_25605 w256, the headline, among them) and WIDE_DIRS at
their on-disk B, each in a family (uniform, pruned, sparse, corpus,
wide).  Each route is timed in ROUTE_ROUNDS interleaved rounds (the
median).  The fit (``fit_routes``) is a non-negative least squares in
relative error: the device terms one route family at a time (panel and
pair, one kernel, as one) against the serves' device time, one host term
for every family (one host path, the served handle's launch) against the
serve time of host-bound serves; the coefficients are rounded to 6
significant digits.
``--table`` prints, for every record with two or more routes measured,
the regret (serve time over the fastest measured route's) of the route
the fitted row prices cheapest and of the route JAX's fixed order takes
under the same admission rules; the geometric means overall and per
family; and each family's with that family held out of the fit.

Every side is timed in f32 and bf16 B.  A side that misses the gate
counts as not served (infinite time); a record whose sides both miss is
not fitted.  ``--table`` prints every record's regret under the fitted
row and under the row ``--against`` names.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch

MIB = 1024 * 1024
INF = float("inf")
DENSITIES = (0.0005, 0.001, 0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.1,
             0.2)
UNIFORM_DIMS = (2048, 4096)
UNIFORM_WIDTHS = (256, 1024)
# (block edge, block sparsity) of the pruned 4096² weights
PRUNED = ((4, 0.8), (4, 0.9), (4, 0.95), (4, 0.98), (4, 0.99), (128, 0.9))
PRUNED_DIM, PRUNED_WIDTH = 4096, 512
BYTES_DIMS = (4096, 8192, 16384)
BYTES_WIDTH = 256
BUILD_LIMIT_S = 120.0
TILE_DIM = 16384
TILE_ROW_NNZ = (4, 8, 16, 32, 64, 128)
TILE_WIDTHS = (256, 512)
GATHER_ROWS = 20000
GATHER_WIDTHS = (256, 1024)
SERVES = 20  # timed serves a side, after 3 warm-up serves
# the routes group times an operand's routes in turns, this many rounds
# each, and keeps each route's median round: the host work of a serve
# varies from one window of serves to the next far more than its device
# work does
ROUTE_ROUNDS = 5
PLAN_FLOOR = 128 * MIB
PLAN_CAP = 512 * MIB
B_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the routes group's dirs at their on-disk B (4096, 12600 and 2048 columns)
WIDE_DIRS = ("medium_4096", "large_15120", "medium_2048")
CONSTANTS = ("densify_min_density", "densify_max_bytes",
             "tile_min_nnz_per_chunk", "panel_gather_gbps",
             "panel_max_plan_bytes")
# the row each constant's records run under: (base, on, off) overrides
SIDES = {
    "densify_min_density": ({}, {"densify_min_density": 0.0},
                            {"densify_min_density": INF}),
    # densify and the panel / pair plans refused: the tile family or
    # the gather path
    "tile_min_nnz_per_chunk": (
        {"densify_min_density": INF, "panel_max_plan_bytes": 0},
        {"tile_min_nnz_per_chunk": 0.0}, {"tile_min_nnz_per_chunk": INF}),
}
# ---- operands ---------------------------------------------------------

def uniform(n: int, density: float, seed: int = 0):
    """n × n, scipy.sparse.random's pattern, values U(-1, 1)."""
    from tpuspmm_torch.formats import CSR

    return CSR.random(n, n, density, seed=seed, lo=-1.0, hi=1.0)


def pruned(block: int, sparsity: float, dim: int = PRUNED_DIM,
           seed: int = 0):
    """A pruned weight at ``sparsity`` block sparsity, as CSR."""
    from tpuspmm_torch.formats import BSR

    return BSR.random_blocks(dim, dim, (block, block), 1.0 - sparsity,
                             seed=seed).to_csr()


def b_uniform(k: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (k, n)).astype(
        np.float32)


def b_pruned(k: int, n: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((k, n))
            .astype(np.float32) * 0.05)


def corpus(width=None):
    """(name, A, B as f32 numpy) for every corpus dir: the on-disk B, or
    a synthesised one ``width`` wide."""
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert

    root = os.path.dirname(data_dir("small_32x32"))
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        a = convert.load_sparse(d, "csr")
        b = convert.load_dense(d, width=width,
                               force_synthetic=width is not None)
        yield name, a, np.asarray(b.data, np.float32)


def nnz_per_chunk(a) -> float:
    """Nonzeros per chunk of the default tile plan (what the row's
    tile_min_nnz_per_chunk is held against)."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.formats.tiles import plan_from_container

    c = default_config()
    plan = plan_from_container(a, tile_m=c.tile_m, tile_k=c.tile_k,
                               chunk=c.chunk_nnz)
    return a.nnz / max(plan.num_chunks, 1)


# ---- measuring --------------------------------------------------------

@contextlib.contextmanager
def patched_row(overrides: dict, jax_order: bool = False):
    """The dispatcher's row with ``overrides`` in place; with
    ``jax_order`` without its serve-time model, so that it routes in
    JAX's fixed order (the order each constant's two sides are read in)."""
    from tpuspmm_torch.kernels import dispatch

    row = {k: v for k, v in dispatch.H100_FIT.items()
           if not (jax_order and k.startswith("serve_"))}
    with mock.patch.dict(dispatch.H100_FIT, {**row, **overrides},
                         clear=True):
        yield


def served_route(call):
    """(call(), the route of the handle ``dispatch.spmm_pallas`` served the
    call from): each handle recorded as ``dispatch.served`` hands it out;
    the route's own entry points and launches run as they are."""
    from tpuspmm_torch.kernels import dispatch

    served, real = [], dispatch.served

    def recorder(*args, **kwargs):
        handle = real(*args, **kwargs)
        served.append(handle.route)
        return handle
    with mock.patch.object(dispatch, "served", recorder):
        out = call()
    return out, served[0] if served else None


def reference(a, b: torch.Tensor) -> torch.Tensor:
    """A·B in float64 on b's device (B's values as served, upcast)."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        t = torch.sparse_csr_tensor(
            torch.from_numpy(np.asarray(a.indptr, np.int64)),
            torch.from_numpy(np.asarray(a.indices, np.int64)),
            torch.from_numpy(np.asarray(a.values, np.float64)),
            size=tuple(a.shape), device=b.device, check_invariants=False)
        return t @ b.double()


def host_time_ms(fn, iters: int = 20) -> float:
    """Median host-clock ms of ``fn`` (a CPU rehearsal's timer)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


class Measurer:
    """Serves operands on ``device`` under patched rows.  ``timer`` times a
    call (CUDA events on the card); ``graph`` adds the graph replay."""

    def __init__(self, device, timer, graph: bool, card: str):
        self.device = torch.device(device)
        self.timer, self.graph, self.card = timer, graph, card

    def side(self, a, b, ref, overrides: dict, resolve_s: float,
             jax_order: bool = False) -> dict:
        """The route ``overrides`` give (in JAX's order with
        ``jax_order``), served and timed; ``build_s`` is ``resolve_s``
        (the route's resolution) and the first serve."""
        import tpuspmm_torch
        from tpuspmm_torch.kernels import dispatch
        from tpuspmm_torch.utils.compare import allclose

        with patched_row(overrides, jax_order):
            t0 = time.perf_counter()
            route, plan = dispatch._resolve(a, b)
            out, served = served_route(lambda: tpuspmm_torch.spmm(a, b))
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            build_s = resolve_s + time.perf_counter() - t0
            if served != route:
                raise RuntimeError(f"dispatch.route named {route}, spmm "
                                   f"served {served}")
            res = {"route": route, "gate": allclose(out, ref),
                   "build_s": round(build_s, 3)}
            if route in ("panel", "pair"):
                res["plan_bytes"] = int(plan.plan_bytes)
            del out
            res["ms"] = self.timer(lambda: tpuspmm_torch.spmm(a, b))
            if self.graph:
                from tpuspmm_torch.utils.timing import graph_time_ms

                try:
                    res["device_ms"] = graph_time_ms(
                        lambda: tpuspmm_torch.spmm(a, b))
                except RuntimeError as e:  # the gather path synchronises
                    res["device_ms"] = None
                    res["capture_error"] = str(e).splitlines()[0][:120]
        return res

    def record(self, constant: str, operand: str, a, b_np, dtype: str,
               x: float, on: dict, off: dict, base=None, on_side=None) -> dict:
        """Both sides of one constant on one operand, each in JAX's order.
        ``on_side``: an "on" side measured already (same operand, same
        row)."""
        from tpuspmm_torch.kernels import dispatch

        base = base or {}
        b = torch.from_numpy(b_np).to(self.device).to(B_DTYPES[dtype])
        rec = {"constant": constant, "operand": operand,
               "shape": list(a.shape), "nnz": int(a.nnz), "x": x,
               "width": int(b.shape[1]), "b_dtype": dtype}
        routes, resolve_s = [], []
        for over in (on, off):
            with patched_row({**base, **over}, jax_order=True):
                t0 = time.perf_counter()
                route, plan = dispatch._resolve(a, b)
                resolve_s.append(time.perf_counter() - t0)
            # a panel or pair route is one route per plan
            routes.append((route, getattr(plan, "plan_bytes", None)
                           if route in ("panel", "pair") else None))
        if routes[0] == routes[1]:
            rec["same_route"] = routes[0][0]
        else:
            ref = reference(a, b)
            rec["on"] = on_side or self.side(a, b, ref, {**base, **on},
                                             resolve_s[0], jax_order=True)
            rec["off"] = self.side(a, b, ref, {**base, **off}, resolve_s[1],
                                   jax_order=True)
            del ref
        rec["card"] = self.card
        return rec

    def gather(self, m: int, n: int) -> dict:
        """The un-permute's row gather: m × n f32 through a permutation."""
        g = torch.Generator().manual_seed(0)
        out = torch.rand(m, n, generator=g).to(self.device)
        inv = torch.randperm(m, generator=g).to(self.device)
        ms = self.timer(lambda: out.index_select(0, inv))
        moved = m * n * 4 * 2
        return {"constant": "panel_gather_gbps", "m": m, "width": n,
                "ms": ms, "bytes": moved,
                "gbps": moved / (ms * 1e-3) / 1e9, "card": self.card}


def operand_x(constant: str, a) -> float:
    """What a floor is held against: A's density, or its nonzeros per
    tile-plan chunk."""
    if constant == "densify_min_density":
        return float(a.sparsity)
    return nnz_per_chunk(a)


def both_sides(meas: Measurer, constant: str, name: str, a, b_np,
               dtypes=tuple(B_DTYPES)):
    base, on, off = SIDES[constant]
    x = operand_x(constant, a)
    for dtype in dtypes:
        yield meas.record(constant, name, a, b_np, dtype, x, on, off,
                          base=base)


def density_records(meas: Measurer, dims=UNIFORM_DIMS,
                    widths=UNIFORM_WIDTHS, densities=DENSITIES,
                    pruned_set=PRUNED, pruned_dim=PRUNED_DIM,
                    with_corpus=True):
    def both(name, a, b_np):
        return both_sides(meas, "densify_min_density", name, a, b_np)

    for n in dims:
        for d in densities:
            a = uniform(n, d)
            for w in widths:
                yield from both(f"uniform_{n}_d{d:g}", a, b_uniform(n, w))
            del a
    for block, s in pruned_set:
        yield from both(f"pruned_{block}x{block}_s{s:g}",
                        pruned(block, s, pruned_dim),
                        b_pruned(pruned_dim, PRUNED_WIDTH))
    if with_corpus:
        for name, a, b_np in corpus():
            yield from both(name, a, b_np)


def tile_records(meas: Measurer, dim=TILE_DIM, row_nnz=TILE_ROW_NNZ,
                 widths=TILE_WIDTHS, with_corpus=True):
    """The tile family (on) against the gather path (off), densify and
    the panel / pair plans refused."""
    def both(name, a, b_np):
        return both_sides(meas, "tile_min_nnz_per_chunk", name, a, b_np)

    for r in row_nnz:
        a = uniform(dim, r / dim)
        for w in widths:
            yield from both(f"uniform_{dim}_r{r}", a, b_uniform(dim, w))
        del a
    if with_corpus:
        for w in widths:
            for name, a, b_np in corpus(width=w):
                yield from both(name, a, b_np)


def bytes_records(meas: Measurer, floor: float, dims=BYTES_DIMS,
                  densities=DENSITIES, width=BYTES_WIDTH):
    """densify_max_bytes records (densify against the rest, the floor at
    the fitted value) and, where the rest is a panel or pair plan, that
    plan against the route with the row's cap just below it."""
    above = [d for d in densities if d >= floor]
    picked = sorted({above[0], above[len(above) // 2], above[-1]}) \
        if above else []
    base = {"densify_min_density": floor}
    on, off = {"densify_max_bytes": 1 << 62}, {"densify_max_bytes": 0}
    for n in dims:
        dropped = False
        for d in picked:
            a = uniform(n, d)
            name = f"uniform_{n}_d{d:g}"
            b_np = b_uniform(n, width)
            for dtype in B_DTYPES:
                rec = meas.record("densify_max_bytes", name, a, b_np, dtype,
                                  float(n * n * 4), on, off, base=base)
                built = max(rec.get(s, {}).get("build_s", 0.0)
                            for s in ("on", "off"))
                if built > BUILD_LIMIT_S:
                    rec["dropped"] = (f"plan build {built:.1f} s > "
                                      f"{BUILD_LIMIT_S:g} s")
                    dropped = True
                yield rec
                served = rec.get("off", {})
                if dropped:
                    break
                if "plan_bytes" in served:
                    x = served["plan_bytes"]
                    yield meas.record(
                        "panel_max_plan_bytes", name, a, b_np, dtype,
                        float(x), {}, {"panel_max_plan_bytes": x - 1},
                        base={**base, **off}, on_side=served)
            del a
            if dropped:
                break


def forced(kind: str) -> dict:
    """Row overrides that pin route ``kind`` among the admitted ones:
    every serve-model coefficient 0 and every other family's fixed term
    infinite (the gather path needs none: it serves when nothing else is
    admitted)."""
    from tpuspmm_torch.kernels import dispatch

    over = {key: 0.0 for terms in dispatch.SERVE_TERMS.values()
            for key in terms}
    for fam, terms in dispatch.SERVE_TERMS.items():
        if fam != dispatch.family(kind):
            over[terms[0]] = INF
    return over


def route_operands(dims=UNIFORM_DIMS, widths=UNIFORM_WIDTHS,
                   densities=DENSITIES, pruned_set=PRUNED,
                   pruned_dim=PRUNED_DIM, tile_dim=TILE_DIM,
                   row_nnz=TILE_ROW_NNZ, tile_widths=TILE_WIDTHS,
                   corpus_widths=TILE_WIDTHS, wide=WIDE_DIRS):
    """(family, operand, A, B as f32 numpy) of the routes group."""
    for n in dims:
        for d in densities:
            a = uniform(n, d)
            for w in widths:
                yield "uniform", f"uniform_{n}_d{d:g}", a, b_uniform(n, w)
    for block, s in pruned_set:
        yield ("pruned", f"pruned_{block}x{block}_s{s:g}",
               pruned(block, s, pruned_dim), b_pruned(pruned_dim,
                                                      PRUNED_WIDTH))
    for r in row_nnz:
        a = uniform(tile_dim, r / tile_dim)
        for w in tile_widths:
            yield "sparse", f"uniform_{tile_dim}_r{r}", a, b_uniform(
                tile_dim, w)
    for w in corpus_widths:
        for name, a, b_np in corpus(width=w):
            yield "corpus", name, a, b_np
    for name, a, b_np in corpus():
        if name in wide:
            yield "wide", name, a, b_np


def routes_record(meas: Measurer, fam: str, name: str, a, b_np,
                  dtype: str, rounds: int = ROUTE_ROUNDS) -> dict:
    """Every admitted route of one operand, each served, gated and timed
    with its terms (``routes``; ``ms`` the median of ``rounds`` rounds,
    ``ms_rounds``, the routes timed in turns); one ``same_route`` where
    exact or bsr_stream serves before any of them."""
    import tpuspmm_torch
    from tpuspmm_torch.kernels import dispatch

    b = torch.from_numpy(b_np).to(meas.device).to(B_DTYPES[dtype])
    rec = {"constant": "routes", "family": fam, "operand": name,
           "shape": list(a.shape), "nnz": int(a.nnz),
           "width": int(b.shape[1]), "b_dtype": dtype}
    first = dispatch.route(a, b)
    if first in ("exact", "bsr_stream"):
        rec["same_route"] = first
    else:
        t0 = time.perf_counter()
        terms = dispatch.route_features(a, b)
        resolve_s = time.perf_counter() - t0
        ref = reference(a, b)
        rec["routes"] = {}
        kinds = tuple(terms) or ("xla",)
        for kind in kinds:
            side = meas.side(a, b, ref, forced(kind) if terms else {},
                             resolve_s)
            if side["route"] != kind:
                raise RuntimeError(f"{name}: forcing {kind} served "
                                   f"{side['route']}")
            side["terms"] = terms.get(kind, {})
            side["ms_rounds"] = [side["ms"]]
            rec["routes"][kind] = side
        del ref
        for _ in range(rounds - 1):
            for kind in kinds:
                with patched_row(forced(kind) if terms else {}):
                    rec["routes"][kind]["ms_rounds"].append(meas.timer(
                        lambda: tpuspmm_torch.spmm(a, b)))
        for side in rec["routes"].values():
            side["ms"] = float(np.median(side["ms_rounds"]))
    rec["card"] = meas.card
    return rec


def routes_records(meas: Measurer, done=frozenset(), rounds=ROUTE_ROUNDS,
                   **operands):
    """The routes group; an (operand, width, B dtype) in ``done`` (a cut
    run's records) is not measured again."""
    for fam, name, a, b_np in route_operands(**operands):
        for dtype in B_DTYPES:
            if (name, int(b_np.shape[1]), dtype) not in done:
                yield routes_record(meas, fam, name, a, b_np, dtype, rounds)


def served_records(meas: Measurer, width: int = TILE_WIDTHS[0]):
    """Not fitted: every corpus dir at ``width``, its default serve (the
    row as it stands) beside the tile family's (densify and the panel /
    pair plans refused, the tile threshold at 0) and cuSPARSE's
    (``torch.sparse`` CSR @ B), each gated and timed."""
    import tpuspmm_torch
    from tpuspmm_torch.kernels import dispatch
    from tpuspmm_torch.ops import vendor
    from tpuspmm_torch.utils.compare import allclose

    tile = {**SIDES["tile_min_nnz_per_chunk"][0],
            **SIDES["tile_min_nnz_per_chunk"][1]}
    for name, a, b_np in corpus(width=width):
        for dtype in B_DTYPES:
            b = torch.from_numpy(b_np).to(meas.device).to(B_DTYPES[dtype])
            ref = reference(a, b)
            t0 = time.perf_counter()
            route = dispatch.route(a, b)
            rec = {"constant": None, "operand": name, "shape": list(a.shape),
                   "nnz": int(a.nnz), "width": width, "b_dtype": dtype,
                   "served": meas.side(a, b, ref, {},
                                       time.perf_counter() - t0)}
            if route not in ("exact",):
                with patched_row(tile, jax_order=True):
                    t0 = time.perf_counter()
                    dispatch.route(a, b)
                rec["tile_family"] = meas.side(a, b, ref, tile,
                                               time.perf_counter() - t0,
                                               jax_order=True)
            out = vendor.spmm_vendor(a, b)
            rec["cusparse"] = {"gate": allclose(out, ref),
                               "ms": meas.timer(
                                   lambda: vendor.spmm_vendor(a, b))}
            rec["card"] = meas.card
            del out, ref, b
            yield rec


# ---- the fit ----------------------------------------------------------

def served_ms(side: dict) -> float:
    return side["ms"] if side.get("gate") else INF


def sides_ms(rec: dict):
    """(on ms, off ms) with a gate miss as INF; (1, 1) for one route."""
    if "same_route" in rec:
        return 1.0, 1.0
    return served_ms(rec["on"]), served_ms(rec["off"])


def fitted(records, constant: str) -> list:
    """The records a constant's fit reads: not dropped, one side at the
    gate."""
    return [r for r in records if r.get("constant") == constant
            and "dropped" not in r and min(sides_ms(r)) < INF]


def admits(constant: str, x: float, value: float) -> bool:
    """Whether the row's ``value`` puts an operand at ``x`` on the "on"
    side: a floor admits at or above it, a cap at or below."""
    if constant in ("densify_min_density", "tile_min_nnz_per_chunk"):
        return x >= value
    return x <= value


def regret(rec: dict, value: float) -> float:
    """Serve time under the row's ``value`` over the faster side's."""
    on, off = sides_ms(rec)
    chosen = on if admits(rec["constant"], rec["x"], value) else off
    return chosen / min(on, off)


def geomean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 1.0


def least_regret(records, constant: str) -> tuple:
    """(t, geometric-mean regret) over the measured x, ties to the
    larger t."""
    recs = fitted(records, constant)
    if not recs:
        raise ValueError(f"no usable {constant} records")
    best = None
    for t in sorted({r["x"] for r in recs}):
        g = geomean(regret(r, t) for r in recs)
        if best is None or g <= best[1] * (1 + 1e-9):
            best = (t, g)
    return best


def fit_bytes(records, floor: float) -> tuple:
    """(cap, how): the largest size up to which densify is the
    least-regret side at every size, else the largest corpus dense A that
    densifies at the fitted floor."""
    recs = [r for r in fitted(records, "densify_max_bytes")]
    cap = None
    for size in sorted({r["x"] for r in recs}):
        at = [r for r in recs if r["x"] == size]
        on = geomean(sides_ms(r)[0] / min(sides_ms(r)) for r in at)
        off = geomean(sides_ms(r)[1] / min(sides_ms(r)) for r in at)
        if on > off:
            break
        cap = int(size)
    if cap is not None:
        return cap, "densify least regret up to this size"
    small = [r["shape"][0] * r["shape"][1] * 4
             for r in fitted(records, "densify_min_density")
             if not r["operand"].startswith(("uniform", "pruned"))
             and r["x"] >= floor]
    return (max(small) if small else 0,
            "densify never least regret above the floor: the corpus dirs' "
            "dense A")


def fit_plan_cap(records) -> tuple:
    recs = fitted(records, "panel_max_plan_bytes")
    if not recs or max(r["x"] for r in recs) < PLAN_FLOOR:
        return PLAN_CAP, "no plan reaches the floor: the package-wide cap"
    wins = [r["x"] for r in recs if sides_ms(r)[0] <= sides_ms(r)[1]]
    if not wins:
        return PLAN_CAP, "no plan measured faster: the package-wide cap"
    return int(max(wins)), "the largest plan served faster"


def route_records(records, fam=None) -> list:
    """The routes group's records with routes measured (of family
    ``fam`` only, where given)."""
    return [r for r in records if r.get("constant") == "routes"
            and "routes" in r and fam in (None, r["family"])]


def fit_routes(records, held_out=None) -> dict:
    """The serve-model coefficients (``dispatch.SERVE_TERMS``), per route
    family over its gate-passing serves (family ``held_out``'s records
    left out), each by a non-negative least squares in relative error
    and rounded to 6 significant digits: the device terms against the
    serves' device time (``device_ms``, the graph replay), panel's and
    pair's together (one kernel); the host term (a constant, one for every
    family: one host path) against the serve time of the host-bound
    serves, those whose device time is under half their serve time.
    Where the held-out fit leaves a family no serve of either kind, that
    family's coefficients are the fit of every record's."""
    from scipy.optimize import nnls

    from tpuspmm_torch.kernels import dispatch

    device = {fam: [] for fam in dispatch.SERVE_TERMS}
    host = {fam: [] for fam in dispatch.SERVE_TERMS}
    for r in route_records(records):
        if r["family"] == held_out:
            continue
        for kind, side in r["routes"].items():
            fam = dispatch.family(kind)
            if fam not in device or not side.get("gate") \
                    or not side.get("device_ms"):
                continue
            us = side["device_ms"] * 1e3
            device[fam].append([side["terms"][key] / us
                                for key in dispatch.SERVE_TERMS[fam][1:]])
            if side["device_ms"] < side["ms"] / 2:
                host[fam].append([1.0 / (side["ms"] * 1e3)])
    # every route serves through one host path, the served handle's
    # launch (dispatch.served): one host term, fitted over every family's
    # host-bound serves; panel and pair run one kernel, the strip routine:
    # one set of device coefficients, fitted over both routes' serves and
    # applied to each route's own plan
    shared = [row for fam in host for row in host[fam]]
    host = {fam: shared for fam in host}
    device["panel"] = device["pair"] = device["panel"] + device["pair"]
    coef = {}
    for fam, keys in dispatch.SERVE_TERMS.items():
        if held_out and not (device[fam] and host[fam]):
            full = fit_routes(records)
            coef.update({key: full[key] for key in keys})
            continue
        if not (device[fam] and host[fam]):
            raise ValueError(f"no usable routes records of {fam}")
        x, _ = nnls(np.asarray(host[fam]), np.ones(len(host[fam])))
        y, _ = nnls(np.asarray(device[fam]), np.ones(len(device[fam])))
        coef.update({key: float(f"{v:.6g}")
                     for key, v in zip(keys, list(x) + list(y))})
    return coef


def priced_route(rec: dict, row: dict) -> str:
    """The route the priced dispatcher takes on a routes record under
    ``row``."""
    from tpuspmm_torch.kernels import dispatch

    features = {kind: side["terms"] for kind, side in rec["routes"].items()
                if kind != "xla"}
    return dispatch.cheapest({kind: dispatch.price(kind, features[kind], row)
                              for kind in dispatch.jax_rank(features)})


def jax_route(rec: dict) -> str:
    """The route JAX's fixed order takes among a record's admitted routes:
    densify, then panel or pair by the lower geometry cost_us, then the
    tile-family member, then the gather path."""
    from tpuspmm_torch.kernels import dispatch

    rank = dispatch.jax_rank({kind: side["terms"] for kind, side
                              in rec["routes"].items() if kind != "xla"})
    return rank[0] if rank else "xla"


def route_regret(rec: dict, kind: str) -> float:
    """Serve time of ``kind`` over the fastest measured route's."""
    times = {k: served_ms(side) for k, side in rec["routes"].items()}
    return times[kind] / min(times.values())


def compared(records) -> list:
    """Routes records with two or more routes measured at the gate."""
    return [r for r in route_records(records)
            if sum(served_ms(s) < INF for s in r["routes"].values()) >= 2]


def regret_summary(records, row: dict) -> list:
    """Geometric-mean regret over ``compared`` records of the priced
    dispatcher under ``row`` and of JAX's order, overall and per family,
    with each family's priced regret under a fit that held it out."""
    recs = compared(records)
    out = []
    for fam in (None,) + tuple(sorted({r["family"] for r in recs})):
        sub = [r for r in recs if fam in (None, r["family"])]
        line = {"family": fam or "all", "records": len(sub),
                "priced_regret": geomean(route_regret(r, priced_route(r, row))
                                         for r in sub),
                "jax_order_regret": geomean(route_regret(r, jax_route(r))
                                            for r in sub)}
        if fam is not None:
            held = dict(row, **fit_routes(records, held_out=fam))
            line["held_out_priced_regret"] = geomean(
                route_regret(r, priced_route(r, held)) for r in sub)
        out.append(line)
    return out


def fit(records) -> tuple:
    """(row, notes): the five routing constants and how each was read,
    and, where the records hold a routes group, the serve-time model's
    coefficients."""
    notes = {}
    floor, g = least_regret(records, "densify_min_density")
    notes["densify_min_density"] = f"least regret, geomean {g:.4f}"
    tile, g = least_regret(records, "tile_min_nnz_per_chunk")
    notes["tile_min_nnz_per_chunk"] = f"least regret, geomean {g:.4f}"
    cap, how = fit_bytes(records, floor)
    notes["densify_max_bytes"] = how
    plan, how = fit_plan_cap(records)
    notes["panel_max_plan_bytes"] = how
    gather = [r for r in records if r.get("constant") == "panel_gather_gbps"
              and r["width"] == GATHER_WIDTHS[0]]
    if not gather:
        raise ValueError("no panel_gather_gbps record at width "
                         f"{GATHER_WIDTHS[0]}")
    notes["panel_gather_gbps"] = f"m={gather[0]['m']}, w{gather[0]['width']}"
    row = {"densify_max_bytes": cap, "densify_min_density": floor,
           "tile_min_nnz_per_chunk": tile,
           "panel_max_plan_bytes": plan,
           "panel_gather_gbps": round(gather[0]["gbps"], 1)}
    if route_records(records):
        coef = fit_routes(records)
        row.update(coef)
        notes.update({key: "non-negative least squares in relative error, "
                      f"{len(route_records(records))} routes records"
                      for key in coef})
    return row, notes


def table(records, row: dict, against: dict) -> list:
    """One line a record: operand, both sides, and the regret under
    ``row`` and under ``against``."""
    lines = []
    for r in records:
        c = r.get("constant")
        if c not in row or c == "panel_gather_gbps" or "dropped" in r:
            continue
        if "same_route" in r:
            sides = f"{r['same_route']} (both)"
        else:
            sides = (f"{r['on']['route']} {r['on']['ms']:.4f}"
                     f"{'' if r['on']['gate'] else ' (gate miss)'} / "
                     f"{r['off']['route']} {r['off']['ms']:.4f}"
                     f"{'' if r['off']['gate'] else ' (gate miss)'}")
        ok = min(sides_ms(r)) < INF
        lines.append({"constant": c, "operand": r["operand"],
                      "width": r["width"], "b_dtype": r["b_dtype"],
                      "x": r["x"], "on / off ms": sides,
                      "regret": regret(r, row[c]) if ok else None,
                      "regret_against": (regret(r, against[c])
                                         if ok and c in against else None)})
    return lines


def read_records(paths) -> list:
    records = []
    for path in paths:
        with open(path) as f:
            records += [json.loads(line) for line in f
                        if line.strip().startswith("{")]
    return records


def measure(out: str, groups) -> int:
    if not torch.cuda.is_available():
        print("fit_routing --measure needs a CUDA card: the routing "
              "constants are the card's serve times", file=sys.stderr)
        return 2
    from tpuspmm_torch.utils.timing import card_line, cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    meas = Measurer("cuda", lambda fn: cuda_time_ms(fn, warmup=3,
                                                    iters=SERVES),
                    graph=True, card=card_line())
    records = read_records([out]) if os.path.exists(out) else []
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def keep(rec):
        records.append(rec)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        sides = [rec[s] for s in ("on", "off", "served", "tile_family")
                 if s in rec] + list(rec.get("routes", {}).values())
        side = ("same route " + rec["same_route"] if "same_route" in rec
                else " / ".join(f"{x['route']} {x['ms']:.4f}"
                                for x in sides))
        print(f"# {rec['constant']} {rec.get('operand', '')} "
              f"w{rec['width']} {rec.get('b_dtype', '')}: {side}",
              file=sys.stderr, flush=True)
        torch.cuda.empty_cache()

    if "densify_min_density" in groups:
        for rec in density_records(meas):
            keep(rec)
    if "panel_gather_gbps" in groups:
        for n in GATHER_WIDTHS:
            keep(meas.gather(GATHER_ROWS, n))
    if "tile_min_nnz_per_chunk" in groups:
        for rec in tile_records(meas):
            keep(rec)
    if "densify_max_bytes" in groups:
        floor, _ = least_regret(records, "densify_min_density")
        for rec in bytes_records(meas, floor):
            keep(rec)
    if "served" in groups:
        for rec in served_records(meas):
            keep(rec)
    if "routes" in groups:
        done = {(r["operand"], r["width"], r["b_dtype"]) for r in records
                if r.get("constant") == "routes"}
        for rec in routes_records(meas, done):
            keep(rec)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("jsonl", nargs="*",
                   default=[os.path.join(os.path.dirname(
                       os.path.abspath(__file__)), "routing_h100.jsonl")],
                   help="records to fit (default: the committed ones)")
    p.add_argument("--measure", action="store_true",
                   help="measure on the card, appending to --out")
    p.add_argument("--out", default="chiprun_out/routing_h100.jsonl")
    p.add_argument("--groups", default=",".join(CONSTANTS + ("served",
                                                             "routes")),
                   help="constants to measure (densify_max_bytes also "
                        "measures panel_max_plan_bytes, after the floor), "
                        "\"served\": the corpus's default serves beside "
                        "the tile family and cuSPARSE, not fitted, and "
                        "\"routes\": every admitted route of each operand, "
                        "for the serve-time model (resumes a cut run)")
    p.add_argument("--table", action="store_true",
                   help="print every record's regret, one JSON line each")
    p.add_argument("--against", default="",
                   help="another row to price the records under, as "
                        "KEY=VALUE,...")
    args = p.parse_args(argv)
    if args.measure:
        return measure(args.out, set(args.groups.split(",")))
    records = read_records(args.jsonl)
    try:
        row, notes = fit(records)
    except ValueError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    if args.table:
        against = {k: float(v) for k, v in (
            kv.split("=") for kv in args.against.split(",") if kv)}
        for line in table(records, row, against):
            print(json.dumps(line))
        for c in row:
            recs = [] if c == "panel_gather_gbps" else fitted(records, c)
            if recs:
                print(json.dumps({
                    "constant": c, "records": len(recs),
                    "geomean_regret": geomean(regret(r, row[c])
                                              for r in recs),
                    "geomean_regret_against": (
                        geomean(regret(r, against[c]) for r in recs)
                        if c in against else None)}))
        for r in compared(records):
            chosen, theirs = priced_route(r, row), jax_route(r)
            print(json.dumps({
                "family": r["family"], "operand": r["operand"],
                "width": r["width"], "b_dtype": r["b_dtype"],
                "routes_ms": {k: s["ms"] if s.get("gate") else None
                              for k, s in r["routes"].items()},
                "priced": chosen, "priced_regret": route_regret(r, chosen),
                "jax_order": theirs,
                "jax_order_regret": route_regret(r, theirs)}))
        for line in regret_summary(records, row) if compared(records) \
                else ():
            print(json.dumps({"routes": line}))
    cards = sorted({r["card"] for r in records if "card" in r})
    print(json.dumps({"fitted": row, "notes": notes, "records": len(records),
                      "cards": cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
