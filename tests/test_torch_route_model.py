"""The dispatcher's serve-time model (``kernels/dispatch.route_costs``).

- The model's terms are the plans' own counts: the strip routine's
  entries and B bytes (``panel_spmm.strip_work``, the reckoning
  ``chip_smoke.py`` reports) from the group index a built plan carries,
  the tile family's dense and gathered tiles from its tile index and its
  B bytes from ``cres_spmm.b_traffic``.
- Under a priced row the route is the least modelled serve time among the
  routes JAX's admission rules admit, a tie to JAX's order; the decision is
  cached, so a repeat serve prices nothing.  A row without the model's
  keys routes as JAX's dispatcher does under the same row.
"""

import numpy as np
import pytest
import torch

from tpuspmm.formats import convert as jconvert
from tpuspmm.kernels import bsr_spmm as jk6
from tpuspmm.kernels import cres_spmm as jk5
from tpuspmm.kernels import csr_vmem as jk4
from tpuspmm.kernels import dispatch as jdispatch
from tpuspmm.kernels import pair_spmm as jpair
from tpuspmm.kernels import panel_spmm as jpanel
from tpuspmm.kernels import tile_spmm as jk3
from tpuspmm.ops import exact as jexact
from tpuspmm_torch.config import Config
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.formats import CSR, convert
from tpuspmm_torch.formats.tiles import plan_from_container
from tpuspmm_torch.kernels import (cres_spmm, dispatch, pair_spmm,
                                   panel_spmm, tile_spmm)

TILE_FAMILY = dispatch.TILE_FAMILY
SERVE_KEYS = {k for terms in dispatch.SERVE_TERMS.values() for k in terms}


def load(name, fmt="csr"):
    return convert.load_sparse(data_dir(name), fmt)


def synthetic(m, k, density, seed):
    return CSR.random(m, k, density, seed=seed, lo=-1.0, hi=1.0)


# ---- the terms are the plans' counts ----------------------------------

def test_strip_work_on_the_headline():
    """The reckoning ``chip_smoke.py`` reported before it moved into the
    package, on large_25605's panel and pair plans at w256."""
    a = load("large_25605")
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a, 256, plan_bytes_cap=cap)
    pgeom = pair_spmm.resolve_pair_geometry(a, 256, plan_bytes_cap=cap)
    plans = (panel_spmm.panel_plan_from_geometry(a, geom),
             pair_spmm.pair_plan_from_container(
                 a, chunk_strips=pgeom.chunk_strips, n_pad=256, geom=pgeom))
    for plan in plans:
        work = panel_spmm.plan_strip_work(plan, 256)
        # a bf16 plan (the values are exact in bf16): 3 products an
        # entry with f32 B, 1 with bf16 B
        assert plan.a_dense.dtype == np.uint16
        heaviest = np.diff(panel_spmm.cached_group_index(
            plan, 64 // plan.tm)[0]).max()
        assert work.pop("heaviest_group_steps") == 3 * heaviest
        assert work.pop("heaviest_group_steps_bf16") == heaviest
        assert work == pytest.approx({
            "group_rows": 64, "group_pairs": 1412, "groups": 99,
            "m16_tiles": 3797, "b_mb_per_call": 185.073664,
            "tc_gflop": 11.944329216, "tc_floor_ms": 0.01207717817593529,
            "b_mb_per_call_bf16": 92.536832, "tc_gflop_bf16": 3.981443072,
            "tc_floor_ms_bf16": 0.004025726058645096}, rel=1e-12)


@pytest.mark.parametrize("tm,tk,order", [(8, 128, "natural"),
                                         (16, 256, "signature"),
                                         (32, 512, "centroid"),
                                         (8, 128, "signature")])
def test_layout_group_index_is_the_plans(tm, tk, order):
    """The group index read from A's coordinates at a geometry equals the
    one the built panel and pair plans carry (entries, k-tiles, strips
    present), with and without a row order."""
    from tpuspmm_torch.ops.xla import coo_view

    a = synthetic(700, 1500, 0.01, seed=5)
    coo = coo_view(a)
    perm = (None if order == "natural" else panel_spmm._order_perm(
        np.asarray(coo.rows, np.int64), np.asarray(coo.cols, np.int64),
        700, np.asarray(coo.cols, np.int64) // tk, order))
    got = panel_spmm.layout_group_index(coo.rows, coo.cols, coo.shape, tm,
                                        tk, perm)
    panel = panel_spmm.build_panel_plan(coo.rows, coo.cols, coo.values,
                                        coo.shape, tm=tm, tk=tk,
                                        panel_strips=16, row_perm=perm)
    plans = [panel]
    if (tm, tk) == (8, 128):
        plans.append(pair_spmm.build_pair_plan(
            coo.rows, coo.cols, coo.values, coo.shape, tm=tm, tk=tk,
            chunk_strips=16, row_perm=perm))
    for plan in plans:
        want = panel_spmm.cached_group_index(plan, 64 // tm)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2] >= 0, want[2] >= 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_features_are_the_plans_counts(dtype):
    """Every term of every admitted route, from the plans a serve of that
    route builds: the panel and pair plans' strip work, the tile index's
    dense and gathered tiles, the cluster launch's B bytes, the heaviest
    row tile against the mean."""
    # above the floor, B's 768 rows in one slab: staged
    a = synthetic(600, 700, 0.03, seed=7)
    n = 200
    b = torch.zeros(700, n, dtype=dtype)
    feats = dispatch.route_features(a, b)
    assert set(feats) == {"densify", "panel", "pair", "staged"}
    bf16 = dtype == torch.bfloat16
    tag = "bf16" if bf16 else "f32"
    assert feats["densify"] == {
        "serve_densify_us": 1.0,
        "serve_densify_f32_us_per_gmac": 0.0 if bf16 else 600 * 700 * n / 1e9,
        "serve_densify_bf16_us_per_gmac": 600 * 700 * n / 1e9 if bf16
        else 0.0}
    th = dispatch.thresholds("cpu")
    geom, pgeom = dispatch._geometries(a, b, Config(), th)
    for kind, g in (("panel", geom), ("pair", pgeom)):
        plan = dispatch._strip_plan(kind, a, g, b)
        work = panel_spmm.plan_strip_work(plan, n)
        group_ptr = panel_spmm.cached_group_index(plan, 64 // plan.tm)[0]
        passes = 3 if bf16 else 6  # an f32 plan: U(-1, 1) values
        assert plan.a_dense.dtype == np.float32
        assert feats[kind] == pytest.approx({
            f"serve_{kind}_us": 1.0, f"serve_{kind}_model": g.cost_us,
            f"serve_{kind}_entry_us_per_mcol": work["group_pairs"] * n / 1e6,
            f"serve_{kind}_b_us_per_mb":
                work["b_mb_per_call" + ("_bf16" if bf16 else "")],
            f"serve_{kind}_tc_us_per_gflop":
                work["tc_gflop" + ("_bf16" if bf16 else "")],
            f"serve_{kind}_group_us_per_step":
                np.diff(group_ptr).max() * passes}, rel=1e-12)
    plan = plan_from_container(a)
    index = tile_spmm.host_index(plan, tile_spmm.dense_min(128, False))
    dense = len(index["d_kt"]) * 128 * 128 * n / 1e9
    traffic = cres_spmm.b_traffic(plan, b, tile_spmm.dense_min(128, False),
                                  dispatch.H100_SMS)
    # no dense tile here: every nonzero is gathered, and each warp owns 16
    # rows of its row tile (600 rows: 38 warps' rows, the last of 8)
    assert not len(index["d_kt"])
    per_warp = np.add.reduceat(np.diff(np.asarray(a.indptr)),
                               np.arange(0, 600, 16))
    straggler = per_warp.max() * traffic["column_tile"]
    assert feats["staged"] == pytest.approx({
        "serve_tile_us": 1.0,
        f"serve_tile_dense_{tag}_us_per_gmac": dense,
        f"serve_tile_dense_{'f32' if bf16 else 'bf16'}_us_per_gmac": 0.0,
        "serve_tile_gather_us_per_mcol": len(index["g_val"]) * n / 1e6,
        "serve_tile_straggler_us_per_mcol": straggler / 1e6,
        "serve_tile_b_us_per_mb": traffic["b_panel_bytes"]["owner"] / 1e6},
        rel=1e-12)
    assert len(index["g_val"]) + sum(
        index["tile_nnz"][index["tile_dense"]]) == a.nnz


def test_cres_prices_the_cluster_launch_bytes(monkeypatch):
    """A C-resident member's B term is the cluster launch's bytes, the
    launch it is served by; staged and tile read the owner routine's."""
    a = synthetic(512, 2048, 0.2, seed=8)  # every 128 x 128 tile dense
    b = torch.zeros(2048, 256)
    feats = dispatch.route_features(a, b)
    assert "cres" in feats
    plan = plan_from_container(a)
    t = cres_spmm.b_traffic(plan, b, tile_spmm.dense_min(128, False),
                            dispatch.H100_SMS)
    assert t["b_panel_bytes"]["cluster"] < t["b_panel_bytes"]["owner"]
    assert feats["cres"]["serve_tile_b_us_per_mb"] == \
        t["b_panel_bytes"]["cluster"] / 1e6
    monkeypatch.setattr(cres_spmm, "fits_card_out", lambda tm, dev: False)
    feats = dispatch.route_features(a, b)
    assert feats["tile"]["serve_tile_b_us_per_mb"] == \
        t["b_panel_bytes"]["owner"] / 1e6


# ---- the priced route --------------------------------------------------

PRICED_CASES = [("large_25605", 256, torch.float32),
                ("large_25605", 256, torch.bfloat16),
                ("medium_4096", 4096, torch.float32),
                ("medium_2048", 256, torch.bfloat16),
                ("large_21074", 512, torch.float32),
                ("small_210", 256, torch.float32)]


@pytest.mark.parametrize("name,n,dtype", PRICED_CASES)
def test_route_is_the_least_modelled_time(name, n, dtype):
    """The route is the argmin of ``route_costs`` over the admitted
    routes, and the admitted routes are those JAX's rules admit."""
    a = load(name)
    b = torch.zeros(a.shape[1], n, dtype=dtype)
    costs = dispatch.route_costs(a, b)
    th = dispatch.thresholds("cpu")
    assert ("densify" in costs) == dispatch._densify_ok(a, th)
    assert {"panel", "pair"} & set(costs)
    chosen = dispatch.route(a, b)
    assert costs[chosen] == min(costs.values())
    assert chosen == dispatch.cheapest(costs)
    assert list(costs) == dispatch.jax_rank(dispatch.route_features(a, b))


def test_ties_go_to_jax_order(monkeypatch):
    """Equal modelled times go to JAX's order, which ``route_costs``
    lists its routes in (``jax_rank``: pair before panel where pair's
    geometry cost is the lower)."""
    b = torch.zeros(400, 64)

    def fixed(costs):
        monkeypatch.setattr(dispatch, "route_costs",
                            lambda a, b, config=None: dict(costs))
        return dispatch.route(synthetic(300, 400, 0.03, seed=9), b)

    assert fixed({"densify": 6.0, "panel": 5.0, "pair": 5.0,
                  "staged": 5.0}) == "panel"
    assert fixed({"pair": 5.0, "panel": 5.0, "staged": 5.0}) == "pair"
    assert fixed({"panel": 5.0, "staged": 4.0}) == "staged"
    assert fixed({}) == "xla"
    feats = {"staged": {}, "pair": {"serve_pair_model": 1.0},
             "panel": {"serve_panel_model": 2.0}, "densify": {}}
    assert dispatch.jax_rank(feats) == ["densify", "pair", "panel",
                                        "staged"]
    feats["panel"]["serve_panel_model"] = 1.0
    assert dispatch.jax_rank(feats)[1:3] == ["panel", "pair"]


def test_repeat_serve_prices_nothing(monkeypatch):
    """Two serves of one container at one width and B dtype price once;
    another width, dtype or config prices again, and the row's own change
    (a refit) does too."""
    calls = []
    real = dispatch.route_costs

    def counting(a, b, config=None):
        calls.append(int(b.shape[1]))
        return real(a, b, config)
    monkeypatch.setattr(dispatch, "route_costs", counting)
    a = synthetic(500, 700, 0.004, seed=10)
    b = torch.from_numpy(np.random.default_rng(11).uniform(
        -1, 1, (700, 64)).astype(np.float32))
    first = dispatch.spmm_pallas(a, b)
    assert torch.equal(dispatch.spmm_pallas(a, b), first)
    assert calls == [64]
    dispatch.spmm_pallas(a, b[:, :32])
    dispatch.spmm_pallas(a, b.to(torch.bfloat16))
    dispatch.spmm_pallas(a, b, Config(panel_strips=16))
    assert len(calls) == 4
    monkeypatch.setitem(dispatch.H100_FIT, "serve_densify_us",
                        dispatch.H100_FIT["serve_densify_us"] + 1.0)
    dispatch.spmm_pallas(a, b)
    assert len(calls) == 5


def test_route_costs_needs_a_priced_row(monkeypatch):
    a = synthetic(100, 100, 0.05, seed=12)
    monkeypatch.delitem(dispatch.H100_FIT, "serve_tile_us")
    assert not dispatch.priced(dispatch.thresholds("cpu"))
    with pytest.raises(ValueError, match="JAX's order"):
        dispatch.route_costs(a, torch.zeros(100, 8))


# ---- a row without the model: JAX's order ------------------------------

class _Served(Exception):
    pass


@pytest.fixture
def jax_route(monkeypatch):
    """The path JAX's spmm_pallas takes, recorded at the call that would
    serve it (nothing is computed)."""
    served = []

    def recorder(tag):
        def call(*args, **kwargs):
            served.append(tag)
            raise _Served
        return call

    for mod, attr, tag in ((jexact, "spmm_exact", "exact"),
                           (jk6, "spmm_bsr_stream", "bsr_stream"),
                           (jdispatch, "_densify", "densify"),
                           (jpanel, "spmm_panel", "panel"),
                           (jpair, "spmm_pair", "pair"),
                           (jk4, "spmm_staged", "staged"),
                           (jk5, "spmm_cres", "cres"),
                           (jk3, "spmm_tiles", "tile"),
                           (jdispatch, "_spmm_xla_any", "xla")):
        monkeypatch.setattr(mod, attr, recorder(tag))

    def route(a, n):
        served.clear()
        with pytest.raises(_Served):
            jdispatch.spmm_pallas(a, np.zeros((a.shape[1], n), np.float32))
        return served[0]
    return route


DIRS = ("large_15120", "large_21074", "large_25605", "medium_2048",
        "medium_4000", "medium_4096", "small_210", "small_32x32")


@pytest.mark.parametrize("name", DIRS)
def test_a_row_without_the_model_routes_as_jax(name, jax_route,
                                               monkeypatch):
    """The H100 row without its serve-time keys, fed to both dispatchers:
    the port routes in JAX's fixed order (its tile-family member by the
    card's residency rule)."""
    for key in SERVE_KEYS:
        monkeypatch.delitem(dispatch.H100_FIT, key)
    row = dispatch.thresholds("cpu")
    monkeypatch.setattr(jdispatch, "thresholds", lambda: row)
    d = data_dir(name)
    for fmt in ("csr", "coo"):
        a_j, a_t = jconvert.load_sparse(d, fmt), convert.load_sparse(d, fmt)
        mine = dispatch.route(a_t, torch.zeros(a_t.shape[1], 256))
        theirs = jax_route(a_j, 256)
        if theirs in TILE_FAMILY:
            assert mine in TILE_FAMILY
        else:
            assert mine == theirs, fmt


# ---- the routes pinned ---------------------------------------------------

# chip_smoke.py's phase 10d operands: (operand, B width, B dtype): the
# port's route under its H100 row
ROUTING_PINS = {
    ("pruned_4x4_s0.9", 512, "f32"): "densify",
    ("pruned_4x4_s0.9", 512, "bf16"): "panel",
    ("pruned_128x128_s0.9", 512, "f32"): "cres",
    ("pruned_128x128_s0.9", 512, "bf16"): "cres",
    ("uniform_2048_d0.016", 1024, "f32"): "cres",
    ("uniform_2048_d0.1", 1024, "f32"): "densify",
    ("large_21074", 512, "f32"): "cres",
    ("medium_4096", 4096, "f32"): "cres",
    ("large_15120", 12600, "f32"): "cres",
}


def operand(name):
    """A phase 10d operand as ``chip_smoke.py`` builds it."""
    from tpuspmm_torch.tools import fit_routing as fr

    if name.startswith("pruned_"):
        block, s = name[len("pruned_"):].split("_s")
        return fr.pruned(int(block.split("x")[0]), float(s))
    if name.startswith("uniform_"):
        n, d = name[len("uniform_"):].split("_d")
        return fr.uniform(int(n), float(d))
    return load(name)


def committed_routes(name, width, b_dtype):
    """{route: serve ms (inf off the gate)} of the committed routes record
    of one operand (tools/routing_h100.jsonl, served on the card)."""
    import os

    from tpuspmm_torch.tools import fit_routing as fr

    recs = [r for r in fr.route_records(fr.read_records([os.path.join(
        os.path.dirname(fr.__file__), "routing_h100.jsonl")]))
        if (r["operand"], r["width"], r["b_dtype"]) == (name, width,
                                                        b_dtype)]
    assert len(recs) == 1, (name, width, b_dtype)
    return {k: fr.served_ms(side) for k, side in recs[0]["routes"].items()}


@pytest.mark.parametrize("name,width,dtype", sorted(ROUTING_PINS))
def test_routing_operands_are_pinned(name, width, dtype):
    """The port's route on each phase 10d operand; where it is not the
    route JAX's order takes among the same admitted routes, it is the
    cheaper in the model and a committed record of the card shows it
    served faster."""
    from tpuspmm_torch.tools.fit_routing import B_DTYPES

    a = operand(name)
    b = torch.zeros(a.shape[1], width, dtype=B_DTYPES[dtype])
    mine = dispatch.route(a, b)
    assert mine == ROUTING_PINS[name, width, dtype]
    theirs = dispatch.jax_rank(dispatch.route_features(a, b))[0]
    if mine != theirs:
        costs = dispatch.route_costs(a, b)
        assert costs[mine] < costs[theirs]
        measured = committed_routes(name, width, dtype)
        assert measured[mine] < measured[theirs]


def test_chip_smoke_expects_the_pinned_routes():
    """``chip_smoke.py``'s serving phase holds each serve to
    SERVED_ROUTES: the routes the dispatcher gives here, on the headline
    at w256 and on each MAIN_CORPUS dir at the B ``chip_smoke.py`` loads
    (on-disk, or 256 synthesised columns)."""
    import chip_smoke

    for (name, tag), want in chip_smoke.SERVED_ROUTES.items():
        a = load(name)
        shape = convert.load_dense(data_dir(name),
                                   width=chip_smoke.WIDTH).data.shape
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        assert dispatch.route(a, torch.zeros(shape, dtype=dtype)) == want
    assert {name for name, _ in chip_smoke.SERVED_ROUTES} == {
        chip_smoke.HEADLINE, *chip_smoke.MAIN_CORPUS}
    assert {n for n, *_ in chip_smoke.ROUTING_OPERANDS} == {
        n for n, _, _ in ROUTING_PINS}
