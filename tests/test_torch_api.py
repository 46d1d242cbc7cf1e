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
            "tpuspmm_torch.cli;"
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


def test_dispatch_serves_the_cheaper_model():
    a_j, a_t = synthetic(seed=3)
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


@pytest.mark.parametrize("name", DIRS)
def test_unfitted_model_never_prices_pair_below_panel(name):
    """With the step and strip costs unfitted (0.0) the model prices plan
    bytes alone: on every data/ dir pair's modelled serve time is not
    below panel's, so the default dispatch serves the panel kernel."""
    a = convert.load_sparse(data_dir(name), "csr")
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a, 256, plan_bytes_cap=cap)
    pgeom = pair_spmm.resolve_pair_geometry(a, 256, plan_bytes_cap=cap)
    assert pgeom.cost_us >= geom.cost_us


def test_pinned_panel_strips_route_to_pair(monkeypatch):
    """A pinned P prices the panel plan above pair's searched one: the
    dispatcher serves the pair kernel, and only it."""
    a = convert.load_sparse(data_dir("medium_2048"), "csr")
    b = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, (2048, 128)).astype(np.float32))
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
    ref = tpuspmm_torch.spmm(a_t, b, method="oracle")
    assert isinstance(ref, torch.Tensor)
    assert allclose(got, ref)
    assert max_abs_err(got, ref) < 1e-4


def test_compensated_matrix_raises():
    """Values beyond the 2e4 cut-off: the dispatcher serves the
    compensated path (float64 accumulation here, the JAX package's
    compensated f32 there), equal to both the JAX path and the oracle;
    only the autotuned method still raises."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method="tuned")


@pytest.mark.parametrize("method", ["xla", "exact", "densify", "tuned"])
def test_methods_not_yet_ported_raise(method):
    """Every method of the JAX package's API: "tuned" still raises naming
    ROADMAP; "xla", "exact" and "densify" serve, equal to the JAX
    package's spmm_csr_xla / spmm_exact / spmm_densify_cached within f32
    summation order (1e-5·max|C|) and to the oracle at the gate.  An
    unknown method raises ValueError."""
    a_j, a_t = synthetic(m=50, k=60, density=0.1)
    b = np.random.default_rng(10).uniform(-1, 1, (60, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method="nope")
    if method == "tuned":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpuspmm_torch.spmm(a_t, torch.from_numpy(b), method=method)
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


def test_split2_config_serves_panel_pair_at_highest():
    """Config(precision_mode="split2") sets the tile-plan kernels' tier;
    the dispatcher still serves panel / pair at "highest", equal to
    tpuspmm.kernels.dispatch.spmm_pallas and to the default config's
    result bit for bit."""
    a_j, a_t = synthetic(seed=14)
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
    assert th["panel_step_us"] == th["panel_strip_us"] == 0.0
    assert th["panel_hbm_gbps"] == report.HBM_GBPS["NVIDIA H100 80GB HBM3"]
    with pytest.raises(KeyError):
        report.hbm_gbps("Some Other Card")
    with pytest.raises(ValueError):
        dispatch.thresholds("meta")
    assert report.spmm_min_bytes(10, 2, 3, 4) == 10 * 8 + 3 * 4 * 4 + 2 * 4 * 4
    rec = report.make_record(testcase="t", sparsity=0.1, fmt="csr",
                             kernel_type=1, kernel_ms=0.5, correct=True)
    assert rec["cudaKernelTimeMs"] == rec["cudaTotalTimeMs"] == 0.5
    assert rec["correct"] == "1"

