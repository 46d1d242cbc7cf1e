"""The port's serving API end to end: tpuspmm_torch.spmm against
tpuspmm.spmm, the vendor baseline, the gather / densify / compensated
paths against the JAX package's, and the import boundary (no jax, no
ml_dtypes)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import tpuspmm
import tpuspmm_torch
from tpuspmm.kernels import dispatch as jdispatch
from tpuspmm.ops import exact as jexact
from tpuspmm.ops import xla as jxla
from tpuspmm_torch import interop
from tpuspmm_torch.config import Config
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.engine import report
from tpuspmm_torch.formats import convert
from tpuspmm_torch.kernels import dispatch, pair_spmm, panel_spmm
from tpuspmm_torch.ops import exact, oracle, xla
from tpuspmm_torch.utils.compare import allclose, max_abs_err


DIRS = sorted(d for d in os.listdir(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"))
    if not d.endswith(".md"))


def synthetic(m=1000, k=2000, density=0.002, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="csr",
                             random_state=rng,
                             data_rvs=lambda n: rng.uniform(-scale, scale, n))
    a_t = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape)
    a_j = tpuspmm.CSR.from_scipy(sp)
    return a_j, a_t


def test_import_loads_neither_jax_nor_ml_dtypes():
    code = ("import sys, tpuspmm_torch, tpuspmm_torch.interop, "
            "tpuspmm_torch.kernels.dispatch, tpuspmm_torch.kernels.strip_cuda,"
            "tpuspmm_torch.kernels.chunk_cuda,"
            "tpuspmm_torch.kernels.cuda_build,"
            "tpuspmm_torch.kernels.tile_spmm, tpuspmm_torch.kernels.csr_vmem,"
            "tpuspmm_torch.kernels.cres_spmm, tpuspmm_torch.formats.tiles,"
            "tpuspmm_torch.ops.xla, tpuspmm_torch.ops.exact,"
            "tpuspmm_torch.engine.registry, tpuspmm_torch.engine.runner,"
            "tpuspmm_torch.engine.select, tpuspmm_torch.kernels.bsr_spmm,"
            "tpuspmm_torch.kernels.bsr_cuda, tpuspmm_torch.formats.convert,"
            "tpuspmm_torch.cli, tpuspmm_torch.bench,"
            "tpuspmm_torch.engine.autotune, tpuspmm_torch.utils.profiling,"
            "tpuspmm_torch.utils.disk_cache, tpuspmm_torch.utils.timing;"
            "bad = [m for m in ('jax', 'ml_dtypes', 'tpuspmm') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_spmm_matches_tpuspmm_pallas(method):
    a_j, a_t = synthetic()
    b = np.random.default_rng(1).uniform(-1, 1, (2000, 256)).astype(
        np.float32)
    ref = np.asarray(tpuspmm.spmm(a_j, b, method="pallas"))
    got = tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method=method)
    assert got.shape == (1000, 256) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    exact_ref = oracle.spmm_scipy_oracle(a_t, b)
    assert allclose(got, exact_ref) and allclose(ref, exact_ref)


def test_dispatch_serves_the_cheaper_model(monkeypatch):
    # below the row's densify floor, in JAX's order (the row's serve-time
    # model prices the tile family cheaper on this operand): the panel /
    # pair step decides, by the lower geometry cost
    jax_order_row(monkeypatch)
    a_j, a_t = synthetic(density=0.0008, seed=3)
    assert a_t.sparsity < dispatch.thresholds("cpu")["densify_min_density"]
    b = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2000, 128)).astype(np.float32))
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a_t, 128, plan_bytes_cap=cap)
    pgeom = pair_spmm.resolve_pair_geometry(a_t, 128, plan_bytes_cap=cap)
    if pgeom.cost_us < geom.cost_us:
        want = pair_spmm.spmm_pair(pair_spmm.pair_plan_from_container(
            a_t, chunk_strips=pgeom.chunk_strips, n_pad=128, geom=pgeom), b)
    else:
        want = panel_spmm.spmm_panel(
            panel_spmm.panel_plan_from_geometry(a_t, geom), b)
    assert torch.equal(dispatch.spmm_pallas(a_t, b), want)


# the default route at B width 256 on every data/ dir under the fitted
# H100 row (the serve-time model prices the admitted routes), with the
# panel geometry the geometry model picks (P, tm, tk, row order; its
# un-permute rate prices the row orders) and pair's (CH, row order): pair's
# geometry never prices below panel's at the default config, since pair's
# candidates (tm 8, tk 128) are a subset of panel's and pair at CH = c
# prices as panel at P = c
FITTED_ROUTES = {
    "large_15120": ("cres", (8, 16, 128, "natural"), (8, "natural")),
    "large_20000": ("exact", (8, 16, 128, "signature"), (16, "signature")),
    "large_21074": ("cres", (8, 16, 512, "natural"), (32, "natural")),
    "large_25605": ("cres", (8, 16, 128, "natural"), (8, "natural")),
    "medium_1484": ("exact", (8, 16, 128, "natural"), (16, "natural")),
    "medium_2048": ("cres", (8, 16, 128, "natural"), (8, "natural")),
    "medium_2880": ("exact", (8, 8, 128, "signature"), (16, "signature")),
    "medium_4000": ("panel", (8, 16, 128, "natural"), (16, "natural")),
    "medium_4096": ("cres", (16, 8, 512, "signature"), (32, "signature")),
    "small_10x10": ("densify", (8, 8, 128, "natural"), (8, "natural")),
    "small_210": ("densify", (8, 16, 256, "natural"), (16, "natural")),
    "small_32x32": ("densify", (8, 8, 128, "natural"), (8, "natural")),
}


@pytest.mark.parametrize("name", sorted(FITTED_ROUTES))
def test_fitted_routes_on_data_dirs(name):
    """The fitted model's default route and geometries at w256; where the
    panel / pair step decides, panel prices no higher than pair."""
    a = convert.load_sparse(data_dir(name), "csr")
    route, panel, pair = FITTED_ROUTES[name]
    assert dispatch.route(a, torch.zeros(a.shape[1], 256)) == route
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a, 256, plan_bytes_cap=cap)
    pgeom = pair_spmm.resolve_pair_geometry(a, 256, plan_bytes_cap=cap)
    assert (geom.panel_strips, geom.tm, geom.tk, geom.order_kind) == panel
    assert (pgeom.chunk_strips, pgeom.order_kind) == pair
    assert geom.cost_us <= pgeom.cost_us


def jax_order_row(monkeypatch):
    """The port's row without its serve-time model: the dispatcher routes
    in JAX's fixed order, panel or pair by the geometry model."""
    for terms in dispatch.SERVE_TERMS.values():
        for key in terms:
            monkeypatch.delitem(dispatch.H100_FIT, key)


def test_pinned_panel_strips_route_to_pair(monkeypatch):
    """A pinned P prices the panel plan above pair's searched one on
    large_15120 (the panel search keeps tm 8, tk 128 at P = 16, where pair
    takes CH = 8): in JAX's order (the row without its serve-time model,
    which prices the tile family below both here) the dispatcher serves
    the pair kernel, and only it."""
    jax_order_row(monkeypatch)
    a = convert.load_sparse(data_dir("large_15120"), "csr")
    b = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, (a.shape[1], 128)).astype(np.float32))
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a, 128, panel_strips=16,
                                             plan_bytes_cap=cap)
    pgeom = pair_spmm.resolve_pair_geometry(a, 128, plan_bytes_cap=cap)
    assert pgeom.cost_us < geom.cost_us
    served = []
    for mod, name in ((panel_spmm, "spmm_panel"), (pair_spmm, "spmm_pair")):
        def record(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            served.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, record)
    got = tpuspmm_torch.spmm(a, b, config=Config(panel_strips=16))
    assert served == ["spmm_pair"]
    plan = pair_spmm.pair_plan_from_container(
        a, chunk_strips=pgeom.chunk_strips, n_pad=128, geom=pgeom)
    assert torch.equal(got, pair_spmm.pair_spmm_plain(plan, b))


def test_vendor_matches_oracle():
    _, a_t = synthetic(seed=4)
    b = np.random.default_rng(5).uniform(-1, 1, (2000, 64)).astype(
        np.float32)
    got = tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method="vendor")
    ref = tpuspmm_torch.spmm(a_t, b, method="oracle",
                             config=Config(device="cpu"))
    assert isinstance(ref, torch.Tensor)
    assert allclose(got, ref)
    assert max_abs_err(got, ref) < 1e-4


def test_compensated_matrix_raises():
    """Values beyond the 2e4 cut-off: the dispatcher serves the
    compensated path (float64 accumulation here, the JAX package's
    compensated f32 there), equal to both the JAX path and the oracle;
    the autotuned method serves a winner that passes the gate there."""
    a_j, a_t = synthetic(m=200, k=300, density=0.02, seed=6, scale=1e5)
    assert jexact.needs_compensated(a_j) and jexact.exact_admissible(a_j)
    assert exact.needs_compensated(a_t) and exact.exact_admissible(a_t)
    b = np.random.default_rng(9).uniform(-1, 1, (300, 128)).astype(
        np.float32)
    ref = np.asarray(jexact.spmm_exact(a_j, b))
    f64 = a_t.to_scipy().astype(np.float64) @ b.astype(np.float64)
    assert dispatch.route(a_t, torch.from_numpy(b)) == "exact"
    for method in ("auto", "pallas", "exact"):
        got = tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method=method)
        assert got.dtype == torch.float32
        # f64 accumulation rounds once, to f32
        assert np.abs(got.numpy() - f64).max() <= 2 ** -23 * np.abs(f64).max()
        assert allclose(got, ref) and allclose(ref, f64)
    tuned = tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method="tuned")
    assert allclose(tuned, f64) and allclose(tuned, ref)


@pytest.mark.parametrize("method", ["xla", "exact", "densify", "tuned"])
def test_methods_not_yet_ported_raise(method):
    """Every method of the JAX package's API serves: "xla", "exact" and
    "densify" equal to the JAX package's spmm_csr_xla / spmm_exact /
    spmm_densify_cached within f32 summation order (1e-5·max|C|) and to
    the oracle at the gate; "tuned" serves the first ranked entry that is
    not verified-only, at the gate.  An unknown method raises
    ValueError."""
    a_j, a_t = synthetic(m=50, k=60, density=0.1)
    b = np.random.default_rng(10).uniform(-1, 1, (60, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method="nope")
    if method == "tuned":
        from tpuspmm_torch.engine import autotune
        from tpuspmm_torch.engine.registry import get_engine

        got = tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method=method)
        assert allclose(got, oracle.spmm_scipy_oracle(a_t, b))
        ranking = autotune.tune(a_t, torch.from_numpy(b))  # its cache
        first = next(r for r in ranking if not r.verified_only)
        want = get_engine("csr").run_kernel(first.number, a_t,
                                            torch.from_numpy(b))
        assert torch.equal(got, want)
        return
    jax_fn = {"xla": jxla.spmm_csr_xla, "exact": jexact.spmm_exact,
              "densify": jxla.spmm_densify_cached}[method]
    ref = np.asarray(jax_fn(a_j, b))
    got = tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method=method)
    assert got.shape == (50, 8) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert allclose(got, oracle.spmm_scipy_oracle(a_t, b))


def test_triplets_match_tpuspmm():
    """spmm_triplets: sentinel rows (< 0) dropped, duplicate coordinates
    summed, bf16 B accumulated in f32, as the JAX package's."""
    rng = np.random.default_rng(11)
    rows = rng.integers(-1, 40, 500).astype(np.int32)
    rows[:20] = rows[20:40]  # duplicates ...
    cols = rng.integers(0, 70, 500).astype(np.int32)
    cols[:20] = cols[20:40]  # ... at equal coordinates
    vals = rng.uniform(-1, 1, 500).astype(np.float32)
    b = rng.uniform(-1, 1, (70, 33)).astype(np.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        jb = jnp.asarray(b, dtype=dt)
        ref = np.asarray(jxla.spmm_triplets(rows, cols, vals, jb,
                                            num_rows=40))
        tb = torch.from_numpy(np.array(jb.astype(jnp.float32)))
        if dt == jnp.bfloat16:
            tb = tb.to(torch.bfloat16)
        got = xla.spmm_triplets(torch.from_numpy(rows),
                                torch.from_numpy(cols),
                                torch.from_numpy(vals), tb, 40)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_densify_is_full_f32_and_cached():
    """The densify path caches dense A per device and multiplies in full
    f32 even with TF32 allowed for CUDA matmuls."""
    a_j, a_t = synthetic(m=64, k=96, density=0.3, seed=12)
    b = torch.from_numpy(np.random.default_rng(13).uniform(
        -1, 1, (96, 16)).astype(np.float32))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = xla.spmm_densify_cached(a_t, b)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert xla.spmm_densify_cached(a_t, b.to(torch.bfloat16)).dtype == \
        torch.float32
    f64 = a_t.to_scipy().astype(np.float64) @ b.double().numpy()
    assert np.abs(got.numpy() - f64).max() <= 1e-5 * np.abs(f64).max()


def test_split2_config_serves_panel_pair_at_highest(monkeypatch):
    """Config(precision_mode="split2") sets the tile-plan kernels' tier;
    the dispatcher still serves panel / pair at "highest", equal to
    tpuspmm.kernels.dispatch.spmm_pallas and to the default config's
    result bit for bit (in JAX's order: the row's serve-time model prices
    the tile family cheaper on this operand)."""
    jax_order_row(monkeypatch)
    a_j, a_t = synthetic(density=0.0008, seed=14)  # below the floor
    b = np.random.default_rng(15).uniform(-1, 1, (2000, 256)).astype(
        np.float32)
    tb = torch.from_numpy(b)
    assert dispatch.route(a_t, tb) in ("panel", "pair")
    got = dispatch.spmm_pallas(a_t, tb, Config(precision_mode="split2"))
    assert torch.equal(got, dispatch.spmm_pallas(a_t, tb, Config()))
    ref = np.asarray(jdispatch.spmm_pallas(a_j, b))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert Config().precision_mode == "split"


def test_exact_predicates_match_tpuspmm():
    for scale in (1.0, 3e4):
        a_j, a_t = synthetic(m=300, k=400, density=0.01, seed=7, scale=scale)
        assert exact.needs_compensated(a_t) == jexact.needs_compensated(a_j)
        assert exact.exact_admissible(a_t) == jexact.exact_admissible(a_j)
        assert exact.exact_admissible(a_t.to_coo()) == \
            jexact.exact_admissible(a_j.to_coo())


def test_thresholds_and_roofline_tables():
    th = dispatch.thresholds("cpu")
    assert th == dispatch.H100_FIT and th is not dispatch.H100_FIT
    assert th["panel_step_us"] > 0 and th["panel_strip_us"] > 0
    # the un-permute's rate is measured (tools/routing_h100.jsonl), not the
    # data sheet's bandwidth
    assert 0 < th["panel_gather_gbps"] != report.HBM_GBPS[
        "NVIDIA H100 80GB HBM3"]
    with pytest.raises(KeyError):
        report.hbm_gbps("Some Other Card")
    with pytest.raises(ValueError):
        dispatch.thresholds("meta")
    assert report.spmm_min_bytes(10, 2, 3, 4) == 10 * 8 + 3 * 4 * 4 + 2 * 4 * 4
    rec = report.make_record(testcase="t", sparsity=0.1, fmt="csr",
                             kernel_type=1, kernel_ms=0.5, correct=True)
    assert rec["cudaKernelTimeMs"] == rec["cudaTotalTimeMs"] == 0.5
    assert rec["correct"] == "1"



def test_unrecorded_card_is_served_with_the_h100_row(monkeypatch):
    """A CUDA card whose name is not on record routes with the H100 row,
    as the JAX package serves an unknown chip with a known row, and warns
    once; the roofline's data-sheet rate still raises for it."""
    import warnings

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    monkeypatch.setattr(dispatch, "_UNRECORDED", set())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert dispatch.thresholds("cuda:0") == dispatch.H100_FIT
        assert dispatch.thresholds("cuda:0") == dispatch.H100_FIT
    assert [str(w.message) for w in caught] == [
        "no routing row on record for 'Some Other Card': routing with the "
        "H100 row (H100_FIT)"]
    with pytest.raises(KeyError):
        report.hbm_gbps("Some Other Card")


def test_host_b_goes_to_the_card_unless_asked(monkeypatch):
    """A numpy B goes to Config.device, "cuda" by default: with no card
    spmm raises and never carries on on the CPU; Config(device="cpu") runs
    there; a torch tensor keeps its own device."""
    from tpuspmm_torch.ops import api

    _, a_t = synthetic(m=40, k=50, density=0.1, seed=30)
    b = np.random.default_rng(31).uniform(-1, 1, (50, 8)).astype(np.float32)
    assert Config().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpuspmm_torch.spmm(a_t, b)
    got = tpuspmm_torch.spmm(a_t, b, config=Config(device="cpu"))
    assert got.device.type == "cpu"
    assert torch.equal(tpuspmm_torch.spmm(a_t, torch.from_numpy(b)), got)
    moved = []

    class Probe(torch.Tensor):
        def to(self, device, *args, **kwargs):
            moved.append(torch.device(device))
            return torch.Tensor(self)

    original = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda x: original(x).as_subclass(Probe))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    api._as_tensor(b, Config())
    assert moved == [torch.device("cuda")]


def _bsr_pair(args):
    return tpuspmm.BSR.random_blocks(*args), \
        tpuspmm_torch.BSR.random_blocks(*args)


@pytest.mark.parametrize("args", [(64, 512, (8, 128), 0.15, 3),
                                  (256, 256, (4, 4), 0.3, 5)])
def test_spmm_serves_bsr_through_k6(args, monkeypatch):
    """spmm on a BSR K6 admits, directly or packed, is served by K6 (its
    plain version here) and equals tpuspmm.spmm's pallas path."""
    from tpuspmm_torch.kernels import bsr_spmm

    a_j, a_t = _bsr_pair(args)
    b = np.random.default_rng(32).standard_normal(
        (a_t.shape[1], 96)).astype(np.float32)
    served = []
    plain = bsr_spmm.bsr_spmm_plain
    monkeypatch.setattr(bsr_spmm, "bsr_spmm_plain",
                        lambda a, bb: served.append(a) or plain(a, bb))
    got = tpuspmm_torch.spmm(a_t, torch.from_numpy(b))
    assert served and all(x is served[0] for x in served)
    assert served[0].block_size in ((8, 128), (128, 128))
    ref = np.asarray(tpuspmm.spmm(a_j, b, method="pallas"))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert allclose(got, oracle.spmm_oracle(a_t, b))


@pytest.mark.parametrize("fmt", ["bsr", "ell", "csc"])
def test_spmm_on_every_format_matches_tpuspmm(fmt):
    """The dispatcher and the gather path on BSR, ELL and CSC containers of
    a corpus dir equal tpuspmm's."""
    from tpuspmm.formats import convert as jconvert

    d = data_dir("small_210")
    a_t, a_j = convert.load_sparse(d, "coo"), jconvert.load_sparse(d, "coo")
    a_t, a_j = convert.to_format(a_t, fmt), jconvert.to_format(a_j, fmt)
    b = np.random.default_rng(33).uniform(-1, 1, (a_t.shape[1], 20)).astype(
        np.float32)
    tb = torch.from_numpy(b)
    for method, jmethod in (("auto", "pallas"), ("xla", "xla")):
        got = tpuspmm_torch.spmm(a_t, tb, method=method)
        ref = np.asarray(tpuspmm.spmm(a_j, b, method=jmethod))
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert allclose(tpuspmm_torch.spmm(a_t, tb, method="vendor"),
                    oracle.spmm_oracle(a_t, b))


def test_bsr_ell_paths_run_with_jax_blocked():
    """With jax blocked in sys.modules, tpuspmm_torch imports and serves a
    BSR (K6's plain version), a 4 x 4 BSR (packed) and an ELL on the CPU,
    and its engines run, at the gate against the oracle."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import tpuspmm_torch
from tpuspmm_torch.config import Config
from tpuspmm_torch.engine import registry
from tpuspmm_torch.formats import BSR, convert
from tpuspmm_torch.ops import oracle
from tpuspmm_torch.utils.compare import allclose
cpu = Config(device="cpu")
for a in (BSR.random_blocks(64, 512, (8, 128), 0.3, seed=1),
          BSR.random_blocks(256, 256, (4, 4), 0.3, seed=5),
          convert.to_format(BSR.random_blocks(64, 256, (8, 8), 0.3, seed=2),
                            "ell")):
    b = np.random.default_rng(0).standard_normal((a.shape[1], 16)).astype(
        np.float32)
    ref = oracle.spmm_oracle(a, b)
    assert allclose(tpuspmm_torch.spmm(a, b, config=cpu), ref)
    engine = registry.get_engine(a.format_name)
    for v in engine.variants:
        if v.admissible is None or v.admissible(a, torch.from_numpy(b), cpu):
            assert allclose(v.fn(a, torch.from_numpy(b), cpu), ref), v.name
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m.startswith("tpuspmm.") or m == "tpuspmm"
               for m in sys.modules)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr
