"""tpuspmm_torch's autotuner (engine/autotune.py) and the geometry
candidates, pins and disk caches it rests on, against tpuspmm's.

The candidate enumerators must list the JAX package's geometries under the
same constants (JAX's pair candidates collapsed by the port's identity,
(sm, CH, order): the port's pair geometry has no column tile).  The
autotune behaviours of tests/test_engine.py are replayed on the port at
small sizes on the CPU, where every variant runs its plain version: the
ranking is gated against the f64 oracle, carries the measured geometry
and pins it, skips verified-only entries when serving, keys on the Config
fingerprint, B dtype and card, and a budgeted run resumes within the JAX
package's bound on measurements.  Every disk path goes to ``tmp_path``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import tpuspmm
from tpuspmm.formats import convert as jconvert
from tpuspmm.kernels import dispatch as jdispatch
from tpuspmm.kernels import pair_spmm as jq
from tpuspmm.kernels import panel_spmm as jp
from tpuspmm_torch import interop
from tpuspmm_torch.config import Config
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.engine import autotune, report
from tpuspmm_torch.engine.registry import get_engine
from tpuspmm_torch.formats import convert
from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.kernels import pair_spmm as tq
from tpuspmm_torch.kernels import panel_spmm as tp
from tpuspmm_torch.kernels.dispatch import thresholds
from tpuspmm_torch.ops import oracle
from tpuspmm_torch.ops.api import spmm
from tpuspmm_torch.utils import timing
from tpuspmm_torch.utils.compare import allclose

CPU = Config(device="cpu")
CAP = tp.PLAN_BYTES_CAP


@pytest.fixture(autouse=True)
def no_disk_cache(monkeypatch):
    """No test reads or writes a cache file unless it names one under
    tmp_path."""
    monkeypatch.delenv("TPUSPMM_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv("TPUSPMM_TORCH_GEOM_CACHE", raising=False)


def caches_in(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSPMM_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("TPUSPMM_TORCH_GEOM_CACHE", str(tmp_path / "geom.json"))


def jax_random(m, k, density, seed):
    """JAX's CSR.random (U(-100, 100) values) and the same arrays as the
    port's container."""
    j = tpuspmm.CSR.random(m, k, density, seed=seed)
    return interop.csr_from_arrays(np.asarray(j.indptr), np.asarray(j.indices),
                                   np.asarray(j.values), j.shape)


def operand(k, n, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (k, n)).astype(np.float32)).to(dtype)


def pair_of(source):
    """(JAX container, port container) of a corpus dir or (m, k, density,
    seed)."""
    if isinstance(source, str):
        d = data_dir(source)
        return jconvert.load_sparse(d, "csr"), convert.load_sparse(d, "csr")
    m, k, density, seed = source
    j = tpuspmm.CSR.random(m, k, density, seed=seed)
    return j, interop.csr_from_arrays(np.asarray(j.indptr),
                                      np.asarray(j.indices),
                                      np.asarray(j.values), j.shape)


CANDIDATE_SOURCES = ["small_32x32", "small_210", "medium_2048",
                     (300, 500, 0.02, 5), (512, 640, 0.04, 33)]


@pytest.mark.parametrize("source", CANDIDATE_SOURCES, ids=str)
def test_candidates_match_jax(source, monkeypatch):
    """k = 3 panel and pair candidates under the port's "cpu" constants,
    patched into the JAX dispatcher's thresholds."""
    th = thresholds("cpu")
    monkeypatch.setattr(jdispatch, "thresholds", lambda: dict(th))
    ja, ta = pair_of(source)
    n_pad = 128
    ref = jp.resolve_panel_geometry_candidates(ja, n_pad, k=3,
                                               plan_bytes_cap=CAP)
    got = tp.resolve_panel_geometry_candidates(ta, n_pad, k=3,
                                               plan_bytes_cap=CAP)
    assert got and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.panel_strips, g.sm, g.plan_bytes, g.tm, g.order_kind,
                g.tk) == (r.panel_strips, r.sm, r.plan_bytes, r.tm,
                          r.order_kind, r.tk)
        assert g.cost_us == pytest.approx(r.cost_us, rel=1e-12)
        assert (g.row_perm is None) == (r.row_perm is None)
        if r.row_perm is not None:
            np.testing.assert_array_equal(g.row_perm, r.row_perm)
    pref = jq.resolve_pair_geometry_candidates(ja, n_pad, k=3,
                                               plan_bytes_cap=CAP)
    seen, collapsed = set(), []
    for r in pref:  # JAX's identity holds tile_n: collapse to the port's
        if (r.sm, r.chunk_strips, r.order_kind) not in seen:
            seen.add((r.sm, r.chunk_strips, r.order_kind))
            collapsed.append(r)
    pgot = tq.resolve_pair_geometry_candidates(ta, n_pad, k=3,
                                               plan_bytes_cap=CAP)
    assert pgot and [(g.sm, g.chunk_strips, g.plan_bytes, g.order_kind)
                     for g in pgot] == [
        (r.sm, r.chunk_strips, r.plan_bytes, r.order_kind)
        for r in collapsed]
    for g, r in zip(pgot, collapsed):
        assert g.cost_us == pytest.approx(r.cost_us, rel=1e-12)


def test_candidates_lead_with_resolver_pick():
    a = jax_random(512, 640, 0.04, 33)
    cands = tp.resolve_panel_geometry_candidates(a, 128, k=3,
                                                 plan_bytes_cap=CAP)
    plain = tp.resolve_panel_geometry(a, 128, plan_bytes_cap=CAP)
    ident = lambda g: (g.tm, g.panel_strips, g.tk, g.sm,  # noqa: E731
                       g.order_kind)
    assert ident(cands[0]) == ident(plain)
    assert len({ident(g) for g in cands}) == len(cands) == 3
    pc = tq.resolve_pair_geometry_candidates(a, 128, k=3, plan_bytes_cap=CAP)
    pplain = tq.resolve_pair_geometry(a, 128, plan_bytes_cap=CAP)
    pident = lambda g: (g.sm, g.chunk_strips, g.order_kind)  # noqa: E731
    assert pident(pc[0]) == pident(pplain)
    assert len({pident(g) for g in pc}) == len(pc) == 3


@pytest.mark.parametrize("family", ["panel", "pair"])
def test_pin_is_resolved_here_and_from_disk(family, tmp_path, monkeypatch):
    """A pinned geometry is what the serving call's resolver returns, on
    the same container and, through the disk cache, on a fresh one."""
    caches_in(tmp_path, monkeypatch)
    a = jax_random(400, 600, 0.03, 9)
    b = operand(600, 96, 1)
    if family == "panel":
        cands = tp.resolve_panel_geometry_candidates(a, 128, k=3,
                                                     plan_bytes_cap=CAP)
        resolve = lambda c: tp.resolve_panel_geometry(  # noqa: E731
            c, 128, plan_bytes_cap=CAP)
        pin = lambda g, disk: tp.pin_panel_geometry(  # noqa: E731
            a, g, n_pad=128, plan_bytes_cap=CAP, disk=disk)
        ident = lambda g: (g.tm, g.panel_strips, g.tk, g.sm,  # noqa: E731
                           g.plan_bytes, g.order_kind)
        entry, counter = tp.spmm_panel, "pallas_panel"
    else:
        cands = tq.resolve_pair_geometry_candidates(a, 128, k=3,
                                                    plan_bytes_cap=CAP)
        resolve = lambda c: tq.resolve_pair_geometry(  # noqa: E731
            c, 128, plan_bytes_cap=CAP)
        pin = lambda g, disk: tq.pin_pair_geometry(  # noqa: E731
            a, g, n_pad=128, plan_bytes_cap=CAP, disk=disk)
        ident = lambda g: (g.sm, g.chunk_strips, g.plan_bytes,  # noqa: E731
                           g.order_kind)
        entry, counter = tq.spmm_pair, "pallas_pair"
    g = cands[-1]
    assert ident(g) != ident(cands[0])
    pin(g, disk=False)  # a candidate under measurement: this process only
    assert ident(resolve(a)) == ident(g)
    assert not (tmp_path / "geom.json").exists()
    pin(g, disk=True)
    for c in (a, dataclasses.replace(a)):
        got = resolve(c)
        assert ident(got) == ident(g)
        assert (got.row_perm is None) == (g.row_perm is None)
        if g.row_perm is not None:
            np.testing.assert_array_equal(got.row_perm, g.row_perm)
    # the serving entry point and the registry's variant serve it
    fresh = dataclasses.replace(a)
    ref = oracle.spmm_scipy_oracle(a, b.numpy())
    assert allclose(entry(fresh, b), ref)
    number = next(v.number for v in get_engine("csr").variants
                  if v.name == counter)
    assert allclose(get_engine("csr").run_kernel(number, fresh, b, CPU), ref)
    assert json.loads((tmp_path / "geom.json").read_text())


@pytest.mark.parametrize("family", ["panel", "pair"])
def test_pins_are_per_b_dtype(family, tmp_path, monkeypatch):
    """A geometry pinned for bf16 B does not replace the one pinned for
    f32 B: each dtype's serving call resolves its own, on the same
    container and, from disk, on a fresh one."""
    caches_in(tmp_path, monkeypatch)
    a = jax_random(400, 600, 0.03, 9)
    if family == "panel":
        cands = tp.resolve_panel_geometry_candidates(a, 128, k=3,
                                                     plan_bytes_cap=CAP)
        pin, resolve = tp.pin_panel_geometry, tp.resolve_panel_geometry
        ident = lambda g: (g.tm, g.panel_strips, g.tk, g.sm,  # noqa: E731
                           g.order_kind)
    else:
        cands = tq.resolve_pair_geometry_candidates(a, 128, k=3,
                                                    plan_bytes_cap=CAP)
        pin, resolve = tq.pin_pair_geometry, tq.resolve_pair_geometry
        ident = lambda g: (g.sm, g.chunk_strips, g.order_kind)  # noqa: E731
    assert len({ident(g) for g in cands}) == 3
    pins = {torch.float32: cands[1], torch.bfloat16: cands[2]}
    for dt, g in pins.items():
        pin(a, g, n_pad=128, plan_bytes_cap=CAP, b_dtype=dt)
    for c in (a, dataclasses.replace(a)):
        for dt, g in pins.items():
            assert ident(resolve(c, 128, plan_bytes_cap=CAP,
                                 b_dtype=dt)) == ident(g), dt


@pytest.mark.parametrize("order", ["f32_first", "bf16_first"])
def test_tuned_geometries_survive_every_tune(order, tmp_path, monkeypatch):
    """After tunes of f32 and bf16 B on one matrix, in either order, each
    ranking's panel and pair geometry is what that dtype's serving call
    resolves on a fresh container (from the disk cache).  The timer makes
    the last candidate win with f32 B and the first with bf16 B, so the
    two tunes pin different geometries."""
    caches_in(tmp_path, monkeypatch)
    calls = iter(range(1, 10 ** 6))

    def timer(fn, bb, iters=8, windows=1):
        i = next(calls)
        return 1000.0 - i if bb.dtype == torch.float32 else float(i)

    monkeypatch.setattr(timing, "serve_time_ms", timer)
    a = jax_random(256, 384, 0.08, 21)
    b = operand(384, 64, 3)
    dtypes = [torch.float32, torch.bfloat16]
    if order == "bf16_first":
        dtypes.reverse()
    rankings = {dt: autotune.tune(a, b.to(dt), iters=1, config=CPU)
                for dt in dtypes}
    geoms = [{r.variant_name: r.geom for r in rk}["pallas_panel"]
             for rk in rankings.values()]
    assert geoms[0] != geoms[1]
    fresh = dataclasses.replace(a)
    for dt, ranking in rankings.items():
        by_name = {r.variant_name: r.geom for r in ranking}
        panel, pair = by_name["pallas_panel"], by_name["pallas_pair"]
        g = tp.resolve_panel_geometry(fresh, 128, plan_bytes_cap=CAP,
                                      panel_strips=CPU.panel_strips,
                                      b_dtype=dt)
        assert (g.tm, g.panel_strips, g.tk, g.sm, g.order_kind) == (
            panel["tm"], panel["P"], panel["tk"], panel["sm"],
            panel["order"]), dt
        pg = tq.resolve_pair_geometry(fresh, 128, plan_bytes_cap=CAP,
                                      b_dtype=dt)
        assert (pg.chunk_strips, pg.sm, pg.order_kind) == (
            pair["CH"], pair["sm"], pair["order"]), dt


@pytest.mark.parametrize("default_ms, leads", [(1.05, True), (1.2, False)])
def test_default_route_leads_within_tie(default_ms, leads, monkeypatch):
    """The dispatcher's default variant leads the ranking when it is
    within DEFAULT_TIE of the fastest entry that is not verified-only;
    otherwise the ranking is fastest first."""
    from tpuspmm_torch.kernels import dispatch

    monkeypatch.setattr(dispatch, "route", lambda a, b, config=None: "panel")
    a = jax_random(64, 96, 0.2, 3)
    results = [autotune.TuneResult("torch_sparse_csr", -1, 1.1),
               autotune.TuneResult("pallas_panel", 7, default_ms),
               autotune.TuneResult("pallas_tile_mxu", 2, 1.0),
               autotune.TuneResult("pallas_c_resident_split2", 6, 0.5,
                                   verified_only=True)]
    got = [r.variant_name for r in autotune._default_first(
        results, a, operand(96, 32, 5), CPU)]
    fastest = ["pallas_c_resident_split2", "pallas_tile_mxu",
               "torch_sparse_csr", "pallas_panel"]
    assert got == (["pallas_panel"] + fastest[:3] if leads else fastest)


def test_cpu_writes_no_cache_by_default(tmp_path, monkeypatch):
    """On a CPU device, with the variables unset, neither cache file is
    read or written: nothing lands in the home directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tp.geom_disk_path("cpu") is None
    assert autotune._disk_path(torch.device("cpu")) is None
    a = jax_random(64, 96, 0.2, 3)
    assert autotune.tune(a, operand(96, 32, 5), iters=1)
    assert not list(tmp_path.rglob("*.json"))
    monkeypatch.setenv("TPUSPMM_TORCH_GEOM_CACHE", str(tmp_path / "g.json"))
    assert tp.geom_disk_path("cpu") == str(tmp_path / "g.json")


def test_keys_carry_config_dtype_and_card(monkeypatch):
    a = jax_random(64, 96, 0.2, 3)
    b = operand(96, 32, 0)
    b16 = b.to(torch.bfloat16)
    c1 = Config(device="cpu")
    c2 = dataclasses.replace(c1, precision_mode="split2")
    c3 = dataclasses.replace(c1, tile_k=256)
    c4 = dataclasses.replace(c1, panel_strips=16)
    c5 = dataclasses.replace(c1, device="cuda")  # not a numerics field
    keys = {autotune._disk_key(a, b, c) for c in (c1, c2, c3, c4)}
    assert len(keys) == 4
    assert autotune._disk_key(a, b, c1) == autotune._disk_key(a, b, c5)
    assert autotune._tune_key(b, c1) != autotune._tune_key(b, c2)
    assert autotune._tune_key(b, c1) != autotune._tune_key(b16, c1)
    assert autotune._disk_key(a, b, c1) != autotune._disk_key(a, b16, c1)
    cpu_key = autotune._disk_key(a, b, c1)
    assert ":cpu:" in cpu_key
    monkeypatch.setattr(report, "detect_card",
                        lambda device: "NVIDIA H100 80GB HBM3")
    card_key = autotune._disk_key(a, b, c1)
    assert card_key != cpu_key and "NVIDIA H100 80GB HBM3" in card_key
    # a geometry's disk key names the card too, and B's value bytes
    key = tp._panel_key(128, None, None, None, True, CAP, thresholds("cpu"))
    assert "NVIDIA H100" in tp.geom_disk_key(a, key, "cpu")
    assert key != tp._panel_key(128, None, None, None, True, CAP,
                                thresholds("cpu"), torch.bfloat16)
    assert (tq._pair_key(128, 8, 128, True, CAP, None, thresholds("cpu"))
            != tq._pair_key(128, 8, 128, True, CAP, None, thresholds("cpu"),
                            torch.bfloat16))


def test_ranking_is_gated():
    """U(-100, 100) values: a ranked variant must pass the gate when it
    is run again, whatever its tier."""
    a = jax_random(300, 511, 0.15, 811)
    b = operand(511, 96, 7)
    ref = oracle.spmm_oracle(a, b.numpy())
    ranking = autotune.tune(a, b, iters=1, config=CPU)
    assert ranking
    engine = get_engine("csr")
    for r in ranking:
        assert allclose(engine.run_kernel(r.number, a, b, CPU), ref), (
            r.variant_name)
    # fastest first, the default route leading only within its tie
    assert [r.ms for r in ranking[1:]] == sorted(r.ms for r in ranking[1:])
    assert ([r.variant_name for r in ranking] == [
        r.variant_name for r in autotune._default_first(ranking, a, b, CPU)])
    names = {r.variant_name for r in ranking}
    assert "torch_sparse_csr" in names  # the vendor competes
    # the 2-term tiers miss the gate on these values and are not ranked
    assert not names & {"pallas_c_resident_split2", "pallas_panel_split",
                        "pallas_pair_split"}


def test_ranking_carries_geometry_and_pins():
    a = jax_random(256, 384, 0.08, 21)
    b = operand(384, 64, 3)
    ref = oracle.spmm_oracle(a, b.numpy())
    ranking = autotune.tune(a, b, iters=1, config=CPU)
    by_name = {r.variant_name: r for r in ranking}
    for name, family in autotune._GEOM_FAMILIES.items():
        if name in by_name:
            assert by_name[name].geom["family"] == family, name
    panel = by_name["pallas_panel"].geom
    g = tp.resolve_panel_geometry(a, 128, panel_strips=CPU.panel_strips,
                                  plan_bytes_cap=CAP)
    assert (g.tm, g.panel_strips, g.tk, g.sm, g.order_kind) == (
        panel["tm"], panel["P"], panel["tk"], panel["sm"], panel["order"])
    pair = by_name["pallas_pair"].geom
    pg = tq.resolve_pair_geometry(a, 128, plan_bytes_cap=CAP)
    assert (pg.chunk_strips, pg.sm, pg.order_kind) == (
        pair["CH"], pair["sm"], pair["order"])
    assert allclose(spmm(a, b, method="tuned", config=CPU), ref)


def test_tuned_serving_skips_verified_only():
    a = jax_random(64, 96, 0.2, 3)
    b = operand(96, 32, 5)
    ref = oracle.spmm_oracle(a, b.numpy())
    ranking = autotune.tune(a, b, iters=1, config=CPU)
    engine = get_engine("csr")
    flagged = {v.name for v in engine.variants if v.verified_only}
    for r in ranking:
        assert r.verified_only == (r.variant_name in flagged), r
    assert any(r.verified_only for r in ranking)
    ranking.sort(key=lambda r: (not r.verified_only, r.ms))
    container_cache(a)["tune"][autotune._tune_key(b, CPU)] = ranking
    safe = next(r for r in ranking if not r.verified_only)
    served = autotune.spmm_tuned(a, b, CPU)
    assert allclose(served, ref)
    torch.testing.assert_close(served, engine.run_kernel(safe.number, a, b,
                                                         CPU), rtol=0, atol=0)


def test_bf16_ranking():
    a = jax_random(128, 160, 0.1, 4)
    b16 = operand(160, 48, 2, torch.bfloat16)
    ranking = autotune.tune(a, b16, iters=1, config=CPU)
    assert ranking and not all(r.verified_only for r in ranking)
    assert autotune._tune_key(b16, CPU) in container_cache(a)["tune"]
    ref16 = oracle.spmm_oracle(a, b16.float().numpy())
    assert allclose(spmm(a, b16, method="tuned", config=CPU), ref16)


def test_budget_and_resume(tmp_path, monkeypatch):
    """A run cut by its budget stores a partial entry; a fresh container
    resumes it with no more measurements than the JAX package's bound,
    and a third call measures nothing."""
    caches_in(tmp_path, monkeypatch)
    a = jax_random(100, 140, 0.08, 11)
    b = operand(140, 32, 2)
    autotune.tune(a, b, iters=1, config=CPU, budget_s=0.0)
    (key, entry), = json.loads((tmp_path / "tune.json").read_text()).items()
    assert not entry["complete"]
    n_done_1 = len(entry["done"])
    assert n_done_1 < get_engine("csr").num_kernels

    measured = []
    orig = timing.serve_time_ms

    def spy(*args, **kw):
        measured.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(timing, "serve_time_ms", spy)
    fresh = lambda: dataclasses.replace(a)  # noqa: E731  the same digest
    ranking2 = autotune.tune(fresh(), b, iters=1, config=CPU)
    entry2 = json.loads((tmp_path / "tune.json").read_text())[key]
    assert entry2["complete"]
    assert set(entry["done"]) <= set(entry2["done"])
    bound = (get_engine("csr").num_kernels - n_done_1 + 2
             + 2 * (autotune.GEOM_CANDIDATES_K - 1))
    assert 0 < len(measured) <= bound
    measured.clear()
    ranking3 = autotune.tune(fresh(), b, iters=1, config=CPU)
    assert not measured
    assert [(r.variant_name, r.ms) for r in ranking3] == [
        (r.variant_name, r.ms) for r in ranking2]


def test_csc_tunes_through_its_csr_view():
    a = jax_random(64, 96, 0.2, 3)
    csc = convert.to_format(a, "csc")
    b = operand(96, 32, 5)
    out = spmm(csc, b, method="tuned", config=CPU)
    assert allclose(out, oracle.spmm_oracle(a, b.numpy()))
    view = container_cache(csc)["tunable_csr"]
    assert autotune._tune_key(b, CPU) in container_cache(view)["tune"]
