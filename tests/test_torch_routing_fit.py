"""The port's routing row (``kernels/dispatch.H100_FIT``) against the JAX
package's per-chip rows and against the card's records.

- The H100 row has every key of JAX's rows, ``panel_max_plan_bytes``
  included, and the "cpu" row is the H100 row.
- ``tools/fit_routing.py``'s fit of the committed ``routing_h100.jsonl``
  gives the row's routing constants, by the rules its docstring states
  (held here on synthetic records too).
- On small operands on each side of every fitted constant, CSR and COO,
  the port prices exactly the routes JAX's rules admit under the port's
  row (densify iff the density is at or above the floor, and so on), and
  serves the cheapest: JAX's own route where it is, a route modelled
  cheaper where it is not.
- The serve-time model's fit (``fit_routes``) and its regret table on
  synthetic records; the routes group's measuring code on the CPU.
- ``--measure`` needs a card; its measuring code runs on the CPU at a
  tiny size, each side served by the route the dispatcher names.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from tpuspmm.formats import BSR as JBSR
from tpuspmm.formats import CSR as JCSR
from tpuspmm.kernels import bsr_spmm as jk6
from tpuspmm.kernels import cres_spmm as jk5
from tpuspmm.kernels import csr_vmem as jk4
from tpuspmm.kernels import dispatch as jdispatch
from tpuspmm.kernels import pair_spmm as jpair
from tpuspmm.kernels import panel_spmm as jpanel
from tpuspmm.kernels import tile_spmm as jk3
from tpuspmm.ops import exact as jexact
import tpuspmm_torch
from tpuspmm_torch.formats import BSR, CSR
from tpuspmm_torch.kernels import dispatch
from tpuspmm_torch.tools import fit_routing as fr

RECORDS = os.path.join(os.path.dirname(fr.__file__), "routing_h100.jsonl")
ROW = dispatch.H100_FIT
TILE_FAMILY = ("staged", "cres", "tile")


class _Served(Exception):
    pass


@pytest.fixture
def jax_route(monkeypatch):
    """The path JAX's spmm_pallas takes under the port's row, recorded at
    the call that would serve it (nothing is computed)."""
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
    monkeypatch.setattr(jdispatch, "thresholds",
                        lambda: dispatch.thresholds("cpu"))

    def route(a, n):
        served.clear()
        with pytest.raises(_Served):
            jdispatch.spmm_pallas(a, np.zeros((a.shape[1], n), np.float32))
        return served[0]
    return route


def priced_among_jax_admitted(pair, jax_route, n=64):
    """Under the port's row, CSR and COO: the port's route is the least
    modelled serve time (``dispatch.route_costs``) among the routes JAX's
    rules admit; the route JAX's dispatcher takes under the same row is
    one of them (a tile-family member by the card's residency rule), and
    where the two differ the port's is modelled cheaper.  Returns the
    port's route and the priced routes."""
    a_j, a_t = pair
    for fmt_j, fmt_t in ((a_j, a_t), (a_j.to_coo(), a_t.to_coo())):
        b = torch.zeros(a_t.shape[1], n)
        costs = dispatch.route_costs(fmt_t, b)
        mine = dispatch.route(fmt_t, b)
        assert mine == dispatch.cheapest(costs)
        theirs = jax_route(fmt_j, n)
        if theirs in TILE_FAMILY:
            k_pad = -(-a_t.shape[1] // 128) * 128
            theirs = "staged" if k_pad <= 768 else "cres"
        assert theirs in costs or theirs == mine == "xla"
        if mine != theirs:
            assert costs[mine] < costs[theirs]
    return mine, costs


def pair_of(sp):
    """(JAX CSR, port CSR) of one scipy matrix."""
    return JCSR.from_scipy(sp), CSR.from_scipy(sp)


SERVE_KEYS = {k for terms in dispatch.SERVE_TERMS.values() for k in terms}


def test_h100_row_has_jax_rows_keys():
    """Every key of JAX's rows, and beside them only the serve-time
    model's."""
    for chip, row in jdispatch._CHIP_THRESHOLDS.items():
        assert set(ROW) - SERVE_KEYS == set(row), chip
        assert not SERVE_KEYS & set(row)
    assert SERVE_KEYS <= set(ROW)
    assert ROW["panel_max_plan_bytes"] == dispatch.thresholds("cpu")[
        "panel_max_plan_bytes"]


def test_cpu_row_is_the_h100_row():
    assert dispatch.thresholds("cpu") == ROW
    with mock.patch.object(torch.cuda, "get_device_name",
                           lambda d=None: "NVIDIA H100 80GB HBM3"):
        assert dispatch.thresholds("cuda:0") == dispatch.thresholds("cpu")
    # a card not on record is served with the same row, as JAX serves an
    # unknown chip with a known one (and warns)
    with mock.patch.object(torch.cuda, "get_device_name",
                           lambda d=None: "Some Other Card"), \
            mock.patch.object(dispatch, "_UNRECORDED", set()):
        with pytest.warns(UserWarning, match="Some Other Card"):
            assert dispatch.thresholds("cuda:0") == ROW


def test_fit_of_the_committed_records_is_the_row(capsys):
    records = fr.read_records([RECORDS])
    assert all(r["card"].startswith("NVIDIA H100") for r in records)
    row, notes = fr.fit(records)
    assert set(row) == set(fr.CONSTANTS) | SERVE_KEYS == set(notes)
    for key, value in row.items():
        assert ROW[key] == value, key
    assert fr.main([RECORDS]) == 0
    assert json.loads(capsys.readouterr().out)["fitted"] == row


def test_records_cover_the_fit_set():
    """Every operand the docstring names has its records, in both B
    dtypes, and each record's sides are the routes its constant moves."""
    records = fr.read_records([RECORDS])
    ops = {(r["constant"], r["operand"], r["b_dtype"]) for r in records
           if r["constant"] != "panel_gather_gbps"}
    for n in fr.UNIFORM_DIMS:
        for d in fr.DENSITIES:
            for dt in fr.B_DTYPES:
                assert ("densify_min_density", f"uniform_{n}_d{d:g}",
                        dt) in ops
    for block, s in fr.PRUNED:
        assert ("densify_min_density", f"pruned_{block}x{block}_s{s:g}",
                "bf16") in ops
    for r in fr.TILE_ROW_NNZ:
        assert ("tile_min_nnz_per_chunk", f"uniform_{fr.TILE_DIM}_r{r}",
                "f32") in ops
    assert {r["width"] for r in records
            if r["constant"] == "panel_gather_gbps"} == set(fr.GATHER_WIDTHS)
    for r in records:
        if "on" in r:
            assert r["on"]["route"] != r["off"]["route"] or \
                r["constant"] == "panel_max_plan_bytes"
        if r["constant"] == "densify_min_density" and "on" in r:
            assert r["on"]["route"] == "densify"
        if r["constant"] == "tile_min_nnz_per_chunk" and "on" in r:
            assert r["on"]["route"] in TILE_FAMILY
            assert r["off"]["route"] == "xla"


def test_table_prices_both_rows(capsys):
    against = "densify_min_density=1,tile_min_nnz_per_chunk=1e9"
    assert fr.main([RECORDS, "--table", "--against", against]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    summary = {x["constant"]: x for x in lines if "geomean_regret" in x}
    # the fitted row is never worse than another row on its own records
    for c in ("densify_min_density", "tile_min_nnz_per_chunk"):
        assert summary[c]["geomean_regret"] <= \
            summary[c]["geomean_regret_against"]
    assert all(x["regret"] >= 1.0 for x in lines if x.get("regret"))


# ---- the rules, on synthetic records ----------------------------------

def rec(constant, x, on, off, gate=(True, True), **kw):
    return {"constant": constant, "operand": kw.pop("operand", "op"),
            "x": x, "shape": kw.pop("shape", [4, 4]),
            "on": {"route": "a", "ms": on, "gate": gate[0]},
            "off": {"route": "b", "ms": off, "gate": gate[1]}, **kw}


def test_least_regret_takes_the_crossover_and_ties_to_the_larger():
    c = "densify_min_density"
    recs = [rec(c, 0.001, 2.0, 1.0), rec(c, 0.01, 1.0, 2.0),
            rec(c, 0.1, 1.0, 3.0)]
    assert fr.least_regret(recs, c) == (0.01, 1.0)
    # a tie between 0.01 and 0.1 (the 0.01 record's sides are equal)
    recs[1] = rec(c, 0.01, 1.0, 1.0)
    assert fr.least_regret(recs, c)[0] == 0.1
    # a gate miss is never served; both sides missing: not fitted
    recs = [rec(c, 0.001, 1.0, 5.0, gate=(False, True)),
            rec(c, 0.01, 1.0, 2.0), rec(c, 0.02, 1.0, 1.0,
                                        gate=(False, False))]
    assert fr.least_regret(recs, c) == (0.01, 1.0)
    assert len(fr.fitted(recs, c)) == 2
    with pytest.raises(ValueError, match="no usable"):
        fr.least_regret([], c)


def test_densify_cap_and_plan_cap_rules():
    c = "densify_max_bytes"
    mib = fr.MIB
    recs = [rec(c, 64 * mib, 1.0, 2.0), rec(c, 256 * mib, 1.0, 1.5),
            rec(c, 1024 * mib, 3.0, 1.0)]
    assert fr.fit_bytes(recs, 0.01)[0] == 256 * mib
    # densify never least regret: the corpus dirs' dense A at the floor
    recs = [rec(c, 64 * mib, 2.0, 1.0),
            rec("densify_min_density", 0.05, 1.0, 2.0, operand="small",
                shape=[32, 32]),
            rec("densify_min_density", 0.005, 1.0, 2.0, operand="mid",
                shape=[64, 64])]
    cap, how = fr.fit_bytes(recs, 0.01)
    assert cap == 32 * 32 * 4 and "corpus" in how
    p = "panel_max_plan_bytes"
    assert fr.fit_plan_cap([rec(p, 64 * mib, 1.0, 2.0)])[0] == fr.PLAN_CAP
    assert fr.fit_plan_cap([rec(p, 64 * mib, 1.0, 2.0),
                            rec(p, 200 * mib, 1.0, 2.0),
                            rec(p, 300 * mib, 2.0, 1.0)])[0] == 200 * mib
    assert fr.regret(rec(p, 300 * mib, 2.0, 1.0), 512 * mib) == 2.0
    assert fr.regret(rec(p, 300 * mib, 2.0, 1.0), 200 * mib) == 1.0
    assert fr.regret({"constant": p, "x": 1, "same_route": "panel"}, 0) == 1


# ---- JAX's dispatcher under the port's row ----------------------------

def uniform_pair(n, density, seed=0):
    import scipy.sparse

    rng = np.random.default_rng(seed)
    return pair_of(scipy.sparse.random(
        n, n, density=density, format="csr", random_state=rng,
        data_rvs=lambda k: rng.uniform(-1, 1, k)))


@pytest.mark.parametrize("density", sorted(set(fr.DENSITIES) | {
    ROW["densify_min_density"] * 0.9, ROW["densify_min_density"] * 1.1}))
def test_density_sweep_routes_as_jax(density, jax_route):
    """Densify is priced iff the density is at or above the row's floor;
    the route is the cheapest JAX's rules admit."""
    pair = uniform_pair(256, density, seed=3)
    _, costs = priced_among_jax_admitted(pair, jax_route)
    assert ("densify" in costs) == (pair[1].sparsity
                                    >= ROW["densify_min_density"])


@pytest.mark.parametrize("side", [0.5, 2.0])
def test_pruned_pattern_routes_as_jax(side, jax_route):
    """A 256² weight pruned to 4 × 4 blocks, its block density on each
    side of the floor, served as CSR and COO."""
    d = min(ROW["densify_min_density"] * side, 1.0)
    a_j = JBSR.random_blocks(256, 256, (4, 4), d, seed=4).to_csr()
    a_t = BSR.random_blocks(256, 256, (4, 4), d, seed=4).to_csr()
    _, costs = priced_among_jax_admitted((a_j, a_t), jax_route)
    assert ("densify" in costs) == (side > 1)


@pytest.mark.parametrize("side", [0.5, 2.0])
def test_densify_cap_routes_as_jax(side, jax_route):
    """Dense A on each side of the cap, above the floor: 64 rows of
    cap · side / 256 columns, each row's nonzeros in a band of its own."""
    import scipy.sparse

    rows = 64
    cols = int(ROW["densify_max_bytes"] * side / (rows * 4))
    per_row = int(np.ceil(ROW["densify_min_density"] * cols * 1.5))
    r = np.repeat(np.arange(rows), per_row)
    c = (r * per_row + np.tile(np.arange(per_row), rows)) % cols
    vals = np.random.default_rng(5).uniform(-1, 1, r.size)
    pair = pair_of(scipy.sparse.csr_matrix((vals, (r, c)),
                                           shape=(rows, cols)))
    assert pair[1].sparsity >= ROW["densify_min_density"]
    _, costs = priced_among_jax_admitted(pair, jax_route, n=1)
    assert ("densify" in costs) == (side < 1)


@pytest.mark.parametrize("side", [0.5, 0.9, 1.1, 2.0])
def test_tile_threshold_routes_as_jax(side, jax_route, monkeypatch):
    """Nonzeros per tile-plan chunk on each side of the tile threshold,
    with the row's plan cap at 1 in both packages (no panel or pair plan)
    and a density under the floor: each 128-row tile holds its nonzeros
    in one 128-column tile."""
    import scipy.sparse

    monkeypatch.setitem(ROW, "panel_max_plan_bytes", 1)
    t = ROW["tile_min_nnz_per_chunk"] * side
    per_tile = max(int(np.ceil(t) if side > 1 else np.floor(t)), 1)
    n, t = 2048, 128
    rng = np.random.default_rng(6)
    r, c = [], []
    for i in range(n // t):
        cells = rng.choice(t * t, per_tile, replace=False)
        r.append(i * t + cells // t)
        c.append(((i * 5) % (n // t)) * t + cells % t)
    r, c = np.concatenate(r), np.concatenate(c)
    sp = scipy.sparse.csr_matrix((rng.uniform(-1, 1, r.size), (r, c)),
                                 shape=(n, n))
    pair = pair_of(sp)
    assert pair[1].sparsity < ROW["densify_min_density"]
    x = fr.nnz_per_chunk(pair[1])
    assert (x >= ROW["tile_min_nnz_per_chunk"]) == (side > 1)
    route, costs = priced_among_jax_admitted(pair, jax_route)
    assert set(costs) <= set(TILE_FAMILY)  # no densify, no panel or pair
    assert bool(costs) == (route in TILE_FAMILY) == (
        x >= ROW["tile_min_nnz_per_chunk"])


# ---- --measure ---------------------------------------------------------

def test_measure_needs_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.jsonl"
    assert fr.main(["--measure", "--out", str(out)]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert not out.exists()


def test_measuring_code_on_the_cpu():
    """Every group at a tiny size on the CPU (host clock): each side is
    served by the route the dispatcher names (``served_route`` raises
    otherwise), at the gate, and the fit reads the records."""
    meas = fr.Measurer("cpu", lambda fn: fr.host_time_ms(fn, iters=2),
                       graph=False, card="cpu")
    recs = list(fr.density_records(
        meas, dims=(128,), widths=(16,), densities=(0.002, 0.1),
        pruned_set=((4, 0.9),), pruned_dim=128, with_corpus=False))
    recs += list(fr.tile_records(meas, dim=512, row_nnz=(2, 64),
                                 widths=(16,), with_corpus=False))
    recs.append(meas.gather(300, fr.GATHER_WIDTHS[0]))
    floor, _ = fr.least_regret(recs, "densify_min_density")
    recs += list(fr.bytes_records(meas, floor, dims=(128,),
                                  densities=(0.002, 0.1), width=16))
    by = {}
    for r in recs:
        by.setdefault(r["constant"], []).append(r)
        for side in ("on", "off"):
            if side in r:
                assert r[side]["gate"] and r[side]["ms"] > 0
    assert [r["on"]["route"] for r in by["densify_min_density"]] == \
        ["densify"] * 6
    assert {r["off"]["route"] for r in by["tile_min_nnz_per_chunk"]} == \
        {"xla"}
    assert {r["on"]["route"] for r in by["tile_min_nnz_per_chunk"]} <= \
        set(TILE_FAMILY)
    plan = by["panel_max_plan_bytes"]
    assert plan and all(r["on"]["plan_bytes"] == r["x"] for r in plan)
    assert all(r["off"].get("plan_bytes", 0) < r["x"] for r in plan
               if "off" in r)
    assert by["panel_gather_gbps"][0]["bytes"] == 300 * 256 * 8
    row, notes = fr.fit(recs)
    assert row["panel_max_plan_bytes"] == fr.PLAN_CAP
    assert len(fr.table(recs, row, {})) == len(recs) - 1


def test_served_records_on_the_cpu(monkeypatch):
    """The corpus's default serves beside the tile family and cuSPARSE
    (two small dirs here), every one at the gate; not fitted."""
    small = [x for x in fr.corpus(width=16)
             if x[0] in ("small_210", "medium_2048")]
    monkeypatch.setattr(fr, "corpus", lambda width=None: iter(small))
    meas = fr.Measurer("cpu", lambda fn: fr.host_time_ms(fn, iters=2),
                       graph=False, card="cpu")
    recs = list(fr.served_records(meas, width=16))
    assert [(r["operand"], r["b_dtype"]) for r in recs] == [
        (n, d) for n, _, _ in small for d in fr.B_DTYPES]
    for r in recs:
        assert r["constant"] is None and r["served"]["gate"]
        assert r["tile_family"]["route"] in TILE_FAMILY
        assert r["tile_family"]["gate"] and r["cusparse"]["gate"]
    assert fr.table(recs, {"densify_min_density": 0.1}, {}) == []


def test_served_route_keeps_the_callees_counts(monkeypatch):
    """The recorder reads the handle spmm_pallas serves from and wraps no
    callee: a route's entry that counts its calls on itself counts them,
    once a serve, through the recorder."""
    from tpuspmm_torch.ops import xla

    a = CSR.random(64, 64, 0.05, seed=1)
    b = torch.zeros(64, 8)
    real = xla.spmm_xla

    def counting(a, b):
        counting.probe += 1
        return real(a, b)
    counting.probe = 0
    monkeypatch.setattr(xla, "spmm_xla", counting)
    # nothing admitted: the gather path serves
    with fr.patched_row({"densify_min_density": fr.INF,
                         "panel_max_plan_bytes": 0,
                         "tile_min_nnz_per_chunk": fr.INF}):
        out, served = fr.served_route(lambda: tpuspmm_torch.spmm(a, b))
        assert served == "xla" and counting.probe == 1
        out, served = fr.served_route(lambda: tpuspmm_torch.spmm(a, b))
        assert served == "xla" and counting.probe == 2
    assert out.shape == (64, 8)


# ---- the serve-time model's records and fit ------------------------------

def test_routes_records_cover_the_routes_group():
    """The committed routes records are the routes group's operands, each
    in both B dtypes, every admitted route measured at the gate with the
    terms its family reads; exact serves only the compensated dirs."""
    records = fr.read_records([RECORDS])
    got = {(r["family"], r["operand"], r["width"], r["b_dtype"])
           for r in records if r["constant"] == "routes"}
    dirs = sorted(d for d in os.listdir(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"))
        if not d.endswith(".md"))
    want = set()
    for dt in fr.B_DTYPES:
        want |= {("uniform", f"uniform_{n}_d{d:g}", w, dt)
                 for n in fr.UNIFORM_DIMS for d in fr.DENSITIES
                 for w in fr.UNIFORM_WIDTHS}
        want |= {("pruned", f"pruned_{b}x{b}_s{s:g}", fr.PRUNED_WIDTH, dt)
                 for b, s in fr.PRUNED}
        want |= {("sparse", f"uniform_{fr.TILE_DIM}_r{r}", w, dt)
                 for r in fr.TILE_ROW_NNZ for w in fr.TILE_WIDTHS}
        want |= {("corpus", d, w, dt) for d in dirs for w in fr.TILE_WIDTHS}
        want |= {("wide", "medium_4096", 4096, dt),
                 ("wide", "large_15120", 12600, dt),
                 ("wide", "medium_2048", 2048, dt)}
    assert got == want
    for r in fr.route_records(records):
        for kind, side in r["routes"].items():
            assert side["route"] == kind and side["gate"]
            assert len(side["ms_rounds"]) == fr.ROUTE_ROUNDS
            assert set(side["terms"]) == set(
                dispatch.SERVE_TERMS[dispatch.family(kind)])
    assert {r["operand"] for r in records
            if r.get("same_route") == "exact"} == {
        "large_20000", "medium_1484", "medium_2880"}


def routes_rec(fam, routes, operand="op"):
    """A synthetic routes record: {route: (ms, device_ms, terms)}."""
    return {"constant": "routes", "family": fam, "operand": operand,
            "width": 8, "b_dtype": "f32",
            "routes": {k: {"route": k, "gate": True, "ms": ms,
                           "device_ms": dev, "terms": terms}
                       for k, (ms, dev, terms) in routes.items()}}


def terms_of(kind, **values):
    """Every term of ``kind``'s family, 0 but the fixed term and
    ``values`` (by the key's last word)."""
    keys = dispatch.SERVE_TERMS[dispatch.family(kind)]
    out = {k: 0.0 for k in keys}
    out[keys[0]] = 1.0
    for word, v in values.items():
        (key,) = [k for k in keys if k.endswith(word)]
        out[key] = v
    return out


def test_fit_routes_recovers_host_and_device_terms():
    """Device terms from the device times, each family on its own (panel's
    and pair's serves pooled: one kernel), the host term from every
    family's host-bound serves (one host path): exact on records that
    follow the model."""
    recs = []
    for x in (1.0, 2.0, 4.0, 8.0, 1.0, 2.0, 4.0, 8.0):
        recs.append(routes_rec("ab"[len(recs) // 4], {
            "densify": (max(0.07, 0.02 * x), 0.02 * x,
                        terms_of("densify", f32_us_per_gmac=x)),
            "panel": (max(0.07, 0.03 * x), 0.03 * x,
                      terms_of("panel", tc_us_per_gflop=x)),
            "pair": (max(0.07, 0.01 * x), 0.01 * x,
                     terms_of("pair", group_us_per_step=x)),
            "cres": (max(0.07, 0.01 * x), 0.01 * x,
                     terms_of("cres", straggler_us_per_mcol=x))}))
    coef = fr.fit_routes(recs)
    assert set(coef) == {k for t in dispatch.SERVE_TERMS.values()
                         for k in t}
    assert coef["serve_densify_f32_us_per_gmac"] == pytest.approx(20.0)
    assert coef["serve_panel_tc_us_per_gflop"] == pytest.approx(30.0)
    assert coef["serve_pair_group_us_per_step"] == pytest.approx(10.0)
    assert coef["serve_tile_straggler_us_per_mcol"] == pytest.approx(10.0)
    # panel and pair: one set of coefficients
    assert all(coef[f"serve_panel_{key}"] == coef[f"serve_pair_{key}"]
               for key in ("model", "entry_us_per_mcol", "b_us_per_mb",
                           "tc_us_per_gflop", "group_us_per_step"))
    assert coef["serve_densify_us"] == coef["serve_panel_us"] == \
        coef["serve_pair_us"] == coef["serve_tile_us"] == \
        pytest.approx(70.0)
    assert coef["serve_densify_bf16_us_per_gmac"] == 0.0
    # a family with no serve is not fitted; held out, it takes the fit
    # of every record
    with pytest.raises(ValueError, match="no usable"):
        fr.fit_routes([routes_rec("a", {"densify": (
            0.05, 0.02, terms_of("densify", f32_us_per_gmac=1.0))})])
    assert fr.fit_routes(recs, held_out="a") == coef
    summary = fr.regret_summary(recs, dict(ROW, **coef))
    assert [(x["family"], x["records"]) for x in summary] == [
        ("all", 8), ("a", 4), ("b", 4)]
    assert all(x["priced_regret"] == pytest.approx(1.0) for x in summary)


def test_priced_and_jax_routes_and_their_regret():
    """JAX's order takes densify first, then panel or pair by the lower
    geometry cost; the priced route is the least modelled time; the
    regret is its serve time over the fastest route's."""
    row = {k: 0.0 for t in dispatch.SERVE_TERMS.values() for k in t}
    row.update(serve_densify_us=50.0, serve_panel_us=90.0,
               serve_pair_us=90.0, serve_tile_us=70.0,
               serve_panel_model=1.0, serve_pair_model=1.0)
    rec = routes_rec("a", {
        "densify": (0.3, 0.3, terms_of("densify")),
        "panel": (0.2, 0.2, terms_of("panel", model=120.0)),
        "pair": (0.25, 0.25, terms_of("pair", model=110.0)),
        "cres": (0.1, 0.03, terms_of("cres"))})
    assert fr.jax_route(rec) == "densify"
    assert fr.priced_route(rec, row) == "densify"  # 50 µs host
    assert fr.route_regret(rec, "densify") == pytest.approx(3.0)
    del rec["routes"]["densify"]
    assert fr.jax_route(rec) == "pair"  # the lower cost_us
    assert fr.priced_route(rec, row) == "cres"  # 70 µs
    assert fr.route_regret(rec, "cres") == 1.0
    # a tie in modelled time goes to JAX's order: pair before panel here
    row["serve_tile_us"] = 200.0
    assert fr.priced_route(rec, row) == "pair"


def test_routes_group_on_the_cpu(monkeypatch):
    """The routes group at a tiny size on the CPU (host clock): every
    admitted route of each operand is forced and served by that route, at
    the gate, timed in rounds; the compensated dirs record exact."""
    small = [x for x in fr.corpus(width=16)
             if x[0] in ("small_210", "medium_1484")]
    monkeypatch.setattr(fr, "corpus", lambda width=None: iter(small))
    meas = fr.Measurer("cpu", lambda fn: fr.host_time_ms(fn, iters=2),
                       graph=False, card="cpu")
    recs = list(fr.routes_records(
        meas, rounds=2, dims=(128,), widths=(16,), densities=(0.1,),
        pruned_set=((4, 0.9),), pruned_dim=128, tile_dim=512,
        row_nnz=(64,), tile_widths=(16,), corpus_widths=(16,), wide=()))
    assert [(r["family"], r["operand"], r["b_dtype"]) for r in recs] == [
        (f, n, d) for f, n in (("uniform", "uniform_128_d0.1"),
                               ("pruned", "pruned_4x4_s0.9"),
                               ("sparse", "uniform_512_r64"),
                               *(("corpus", x[0]) for x in small))
        for d in fr.B_DTYPES]
    for r in recs:
        if r["operand"] == "medium_1484":
            assert r["same_route"] == "exact" and "routes" not in r
            continue
        assert set(r["routes"]) == {"densify", "panel", "pair", "staged"}
        for kind, side in r["routes"].items():
            assert side["route"] == kind and side["gate"]
            assert len(side["ms_rounds"]) == 2
            assert side["ms"] == pytest.approx(np.median(side["ms_rounds"]))
    # a cut run resumes: what it measured is not measured again
    done = {(r["operand"], r["width"], r["b_dtype"]) for r in recs}
    assert not list(fr.routes_records(
        meas, done, rounds=1, dims=(128,), widths=(16,), densities=(0.1,),
        pruned_set=(), row_nnz=(), corpus_widths=(), wide=()))
