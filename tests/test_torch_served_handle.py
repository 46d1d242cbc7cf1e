"""The dispatcher's served handle (``kernels/dispatch.served``) and the
kernels' bound launches (``kernels/cuda_build.Launch``).

``spmm_pallas`` serves from a handle built once per container, B width,
B dtype, device, config and row: the route, what it serves from and its
launch.  On the card the launch is the kernel's binding (``bind`` in
``kernels/{strip,chunk,bsr}_cuda.py``: the plan checked once; a call
checks B, allocates C and launches once); on the CPU it is the route's
entry point, which runs the plain version.  Held here, on the CPU:

- a repeat serve does no resolution work: no row, pricing, plan or plan
  check is taken again;
- another B width, another B dtype, a Config field changed in place or a
  changed row builds another handle;
- for every route the handle's output is bit-equal to the route's entry
  point on the handle's own plan, agrees with the JAX package's
  counterpart on the same plan (Pallas interpret mode, or its plain
  path) at the tolerance that route's own tests state, and passes the
  gate against the f64 oracle;
- a B of the wrong K is refused with the entry points' message;
- a bound launch, driven with a stand-in library, allocates a fresh C and
  reads the current stream at every call, passes B's pointer of that
  call, and counts one launch a call.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import tpuspmm
import tpuspmm.formats as jformats
from tpuspmm.formats import tiles as jtiles
from tpuspmm.kernels import bsr_spmm as jk6
from tpuspmm.kernels import cres_spmm as jk5
from tpuspmm.kernels import csr_vmem as jk4
from tpuspmm.kernels import pair_spmm as jpair
from tpuspmm.kernels import panel_spmm as jpanel
from tpuspmm.kernels import tile_spmm as jk3
from tpuspmm.ops import exact as jexact
from tpuspmm.ops import xla as jxla
from tpuspmm_torch import interop
from tpuspmm_torch.config import Config
from tpuspmm_torch.formats import BSR
from tpuspmm_torch.kernels import (bsr_cuda, bsr_spmm, chunk_cuda, cres_spmm,
                                   csr_vmem, cuda_build, dispatch, pair_spmm,
                                   panel_spmm, strip_cuda, tile_spmm)
from tpuspmm_torch.ops import exact, oracle, xla
from tpuspmm_torch.utils.compare import allclose

INF = float("inf")
ROUTES = ("exact", "bsr_stream", "densify", "panel", "pair", "staged",
          "cres", "tile", "xla")
# each route against the JAX package's counterpart on the same plan, at
# the tolerance (· max|C|) that route's own comparison tests state: f32
# sums in another order (test_torch_api, _panel, _pair, _bsr), the tile
# family's tiers term for term (test_torch_tiles' TOL)
JAX_TOL = {"tile_family": 2.0 ** -20, "other": 1e-5}


def csr_pair(m, k, density, seed, scale=1.0):
    """The same seeded CSR in both packages."""
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="csr",
                             random_state=rng,
                             data_rvs=lambda n: rng.uniform(-scale, scale, n))
    return (tpuspmm.CSR.from_scipy(sp),
            interop.csr_from_arrays(sp.indptr, sp.indices, sp.data,
                                    sp.shape))


def dense_b(k, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (k, n)).astype(
        np.float32)


def force(monkeypatch, route):
    """The priced dispatcher takes ``route`` where it is admitted (the
    model's pick replaced; the admission rules stay)."""
    def pick(costs):
        assert route in costs, (route, costs)
        return route
    monkeypatch.setattr(dispatch, "cheapest", pick)


def operands(route, monkeypatch):
    """(JAX container, port container, B as f32 numpy) the dispatcher
    serves by ``route``."""
    if route == "exact":  # values beyond the compensated cut-off
        a_j, a_t = csr_pair(200, 300, 0.02, seed=1, scale=1e5)
        return a_j, a_t, dense_b(300, 64, 2)
    if route == "bsr_stream":  # (8, 128) blocks: K6 admits them
        args = (64, 512, (8, 128), 0.4, 0)
        return (jformats.BSR.random_blocks(*args), BSR.random_blocks(*args),
                dense_b(512, 64, 3))
    if route == "xla":  # nothing admitted
        for key, value in (("densify_min_density", INF),
                           ("panel_max_plan_bytes", 0),
                           ("tile_min_nnz_per_chunk", INF)):
            monkeypatch.setitem(dispatch.H100_FIT, key, value)
        a_j, a_t = csr_pair(300, 400, 0.02, seed=4)
        return a_j, a_t, dense_b(400, 64, 5)
    if route == "tile":  # the C-resident rule refused
        monkeypatch.setattr(cres_spmm, "fits_card_out",
                            lambda tile_m, device: False)
    force(monkeypatch, route)
    # K ≤ 768 stages the whole B stripe (staged); wider K is C-resident
    k = 700 if route in ("densify", "panel", "pair", "staged") else 900
    a_j, a_t = csr_pair(300, k, 0.02, seed=6)
    return a_j, a_t, dense_b(k, 64, 7)


def jax_values(a_dense):
    a_dense = np.asarray(a_dense)
    return a_dense.view(jnp.bfloat16) if a_dense.dtype == np.uint16 \
        else a_dense


def jax_counterpart(route, a_j, source, b):
    """The JAX package's result for ``route`` on the handle's own plan."""
    if route == "exact":
        return jexact.spmm_exact(a_j, b)
    if route == "densify":
        return jxla.spmm_densify_cached(a_j, b)
    if route == "xla":
        return jxla.spmm_csr_xla(a_j, b)
    if route == "bsr_stream":
        assert source.block_size == a_j.block_size
        return jk6.spmm_bsr_stream(a_j, b, interpret=True)
    if route == "panel":
        plan = jpanel.PanelPlan(
            kt=source.kt, st=source.st, offs=source.offs,
            a_dense=jax_values(source.a_dense), shape=source.shape,
            tm=source.tm, tk=source.tk, panel_strips=source.panel_strips,
            sm=source.sm, row_perm=source.row_perm)
        return jpanel.spmm_panel(plan, b, interpret=True)
    if route == "pair":
        plan = jpair.PairPlan(
            kt=source.kt, st=source.st, start=source.start,
            count=source.count, offs=source.offs,
            a_dense=jax_values(source.a_dense), shape=source.shape,
            tm=source.tm, tk=source.tk, chunk_strips=source.chunk_strips,
            sm=source.sm, row_perm=source.row_perm)
        return jpair.spmm_pair(plan, b, interpret=True)
    plan = jtiles.TilePlan(
        rt=source.rt, kt=source.kt, first=source.first, rows=source.rows,
        cols=source.cols, vals=source.vals, shape=source.shape,
        tile_m=source.tile_m, tile_k=source.tile_k, chunk=source.chunk)
    run = {"staged": jk4.spmm_staged, "cres": jk5.spmm_cres,
           "tile": jk3.spmm_tiles}[route]
    return run(plan, b, interpret=True, mode="split")


def entry_point(route, a, source, b):
    """The route's public entry on the handle's plan (or container)."""
    return {
        "exact": lambda: exact.spmm_exact(a, b),
        "bsr_stream": lambda: bsr_spmm.spmm_bsr_stream(source, b),
        "densify": lambda: xla.spmm_densify_cached(a, b),
        "panel": lambda: panel_spmm.spmm_panel(source, b),
        "pair": lambda: pair_spmm.spmm_pair(source, b),
        "staged": lambda: csr_vmem.spmm_staged(source, b),
        "cres": lambda: cres_spmm.spmm_cres(source, b),
        "tile": lambda: tile_spmm.spmm_tiles(source, b),
        "xla": lambda: xla.spmm_xla(a, b),
    }[route]()


# the resolution and plan-check work a handle's build runs, and a repeat
# serve must not: (module, attribute)
RESOLUTION = ((dispatch, "thresholds"), (dispatch, "route_costs"),
              (dispatch, "_tile_member"), (dispatch, "_strip_plan"),
              (dispatch, "_geometries"), (exact, "needs_compensated"),
              (bsr_spmm, "stream_operand"), (chunk_cuda, "_checked"),
              (chunk_cuda, "_checked_cluster"), (strip_cuda, "_checked"),
              (bsr_cuda, "_checked"))


def count_calls(monkeypatch):
    calls = {}
    for mod, name in RESOLUTION:
        real = getattr(mod, name)

        def counting(*args, _real=real, _key=f"{mod.__name__}.{name}",
                     **kwargs):
            calls[_key] = calls.get(_key, 0) + 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
    return calls


@pytest.mark.parametrize("route", ROUTES)
def test_repeat_serve_does_no_resolution_work(route, monkeypatch):
    """The first serve builds the handle (the route's resolution runs);
    the second serves from it and runs none of it, with the same bits."""
    _, a, b_np = operands(route, monkeypatch)
    b = torch.from_numpy(b_np)
    calls = count_calls(monkeypatch)
    first = dispatch.spmm_pallas(a, b)
    built = dict(calls)
    # the route's own resolution ran in the build
    assert built.get(f"{exact.__name__}.needs_compensated")
    if route not in ("exact", "bsr_stream"):
        assert built.get(f"{dispatch.__name__}.thresholds")
        assert built.get(f"{dispatch.__name__}.route_costs")
    handle = dispatch.served(a, b)
    assert handle.route == route
    calls.clear()
    again = dispatch.spmm_pallas(a, b)
    assert calls == {}
    assert torch.equal(again, first)
    assert dispatch.served(a, b) is handle and calls == {}


@pytest.mark.parametrize("change", ["width", "dtype", "config_field",
                                    "row"])
def test_another_input_builds_another_handle(change, monkeypatch):
    """Another B width, B dtype, a Config field changed in place or a
    changed row builds a new handle; the old one stays for its own key,
    and the new one serves the new input right."""
    _, a, b_np = operands("panel", monkeypatch)
    b = torch.from_numpy(b_np)
    config = Config(device="cpu")
    handle = dispatch.served(a, b, config)
    assert dispatch.served(a, b, config) is handle
    if change == "width":
        b = b[:, :48].contiguous()
    elif change == "dtype":
        b = b.to(torch.bfloat16)
    elif change == "config_field":
        config.precision_mode = "split2"  # the same object, mutated
    else:
        monkeypatch.setitem(dispatch.H100_FIT, "serve_panel_us",
                            dispatch.H100_FIT["serve_panel_us"] + 1.0)
    new = dispatch.served(a, b, config)
    assert new is not handle
    assert dispatch.served(a, b, config) is new
    got = dispatch.spmm_pallas(a, b, config)
    assert got.shape == (a.shape[0], b.shape[1])
    assert allclose(got, oracle.spmm_oracle(a, b.float().numpy()))
    if change == "config_field":
        config.precision_mode = "split"  # back: the first handle again
        assert dispatch.served(a, b, config) is handle


@pytest.mark.parametrize("route", ROUTES)
def test_every_route_matches_its_entry_and_jax(route, monkeypatch):
    """The handle's output equals its entry point's bit for bit, the JAX
    package's counterpart on the same plan within the route's tolerance,
    and the f64 oracle at the gate."""
    a_j, a, b_np = operands(route, monkeypatch)
    b = torch.from_numpy(b_np)
    got = dispatch.spmm_pallas(a, b)
    handle = dispatch.served(a, b)
    assert handle.route == route
    assert got.shape == (a.shape[0], 64) and got.dtype == torch.float32
    assert torch.equal(got, entry_point(route, a, handle.source, b))
    ref = np.asarray(jax_counterpart(route, a_j, handle.source, b_np))
    tol = JAX_TOL["tile_family" if route in dispatch.TILE_FAMILY
                  else "other"]
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    f64 = oracle.spmm_oracle(a, b_np)
    assert allclose(got, f64) and allclose(ref, f64)


@pytest.mark.parametrize("route", ["panel", "pair", "staged", "cres",
                                   "tile", "bsr_stream"])
def test_bad_b_is_refused_as_before(route, monkeypatch):
    """A B of another K is refused by the handle with the entry point's
    message; a handle is keyed by its width, so a B of another width gets
    its own handle, never this one's launch."""
    _, a, b_np = operands(route, monkeypatch)
    b = torch.from_numpy(b_np)
    dispatch.spmm_pallas(a, b)
    short = torch.zeros(b.shape[0] - 1, b.shape[1])
    message = (rf"b must be \({a.shape[1]}, N\)" if route == "bsr_stream"
               else rf"b must be \(K={a.shape[1]}, N\)")
    with pytest.raises(ValueError, match=message):
        dispatch.spmm_pallas(a, short)
    with pytest.raises(ValueError, match=message):
        entry_point(route, a, dispatch.served(a, b).source, short)
    narrow = b[:, :16].contiguous()
    assert dispatch.served(a, narrow) is not dispatch.served(a, b)
    assert torch.equal(dispatch.spmm_pallas(a, narrow),
                       dispatch.spmm_pallas(a, b)[:, :16])


class _Library:
    """A stand-in for a built CUDA library: records each call's
    arguments and returns 0 (a launch that was taken)."""

    def __init__(self):
        self.calls = []

    def fake_entry(self, *args):
        self.calls.append(args)
        return 0


def test_bound_launch_checks_b_and_launches_each_call(monkeypatch):
    """What a bound launch does each call: B checked against the bound
    shape, dtype and device; C a fresh ``torch.empty`` (a result the
    caller holds is never written again); the current stream read anew
    (a capture on a side stream launches there); B's pointer of that
    call; one launch counted."""
    lib = _Library()
    module = types.SimpleNamespace(load=lambda: lib)
    streams = iter(range(100, 200))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: next(streams), raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    counter = types.SimpleNamespace(launches=0)
    b = torch.zeros(12, 8)
    launch = cuda_build.Launch(
        module, "fake_entry", "no_error_string", "fake", b, 5,
        lambda b_ptr, out_ptr, stream: (7, b_ptr, out_ptr, stream), (),
        counter)
    b2 = torch.ones(12, 8)
    out1, out2 = launch(b), launch(b2)
    assert out1.shape == out2.shape == (5, 8)
    assert out1.dtype == torch.float32 and out1.data_ptr() != \
        out2.data_ptr()
    assert lib.calls == [(7, b.data_ptr(), out1.data_ptr(), 100),
                         (7, b2.data_ptr(), out2.data_ptr(), 101)]
    assert counter.launches == 2
    # refused before anything launches: another K (the entry points'
    # message), another width, dtype or a strided B (the bound one named);
    # B's own checks (check_b: CUDA, f32 / bf16, 2-D, contiguous) stood
    # in for, since B is on the CPU here
    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    with pytest.raises(ValueError, match=r"b must be \(K=12, N\)"):
        launch(torch.zeros(11, 8))
    for bad in (torch.zeros(12, 9), torch.zeros(12, 8, dtype=torch.bfloat16),
                torch.zeros(8, 12).t()):
        with pytest.raises(ValueError):
            launch(bad)
    assert counter.launches == 2 and len(lib.calls) == 2


def test_bind_refuses_a_b_no_kernel_takes():
    """Each binding refuses a B off the card by name before it reads the
    plan, as the launchers did on every call."""
    b = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="CUDA"):
        strip_cuda.bind("panel_strip_spmm", {}, b, 1, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        chunk_cuda.bind("tile_chunk_spmm", {}, b, 64, 64, 128, False)
    with pytest.raises(ValueError, match="CUDA"):
        bsr_cuda.bind(*(torch.zeros(1, dtype=torch.int32),) * 3,
                      torch.zeros(1, dtype=torch.int16), b, 8, (8, 128))
    # an f16 B on the card is refused by its type (phase 5c of
    # chip_smoke.py launches one)
    with pytest.raises(ValueError, match="contiguous 2-D f32/bf16"):
        cuda_build.check_b("tile_chunk_spmm", _FakeCuda(torch.float16))


class _FakeCuda:
    """A B that reports a CUDA device (the dtype check comes next)."""

    def __init__(self, dtype):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype
        self.shape = (4, 4)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True
