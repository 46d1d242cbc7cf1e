"""tpuspmm_torch.tools.{profile_variants, hbm_control, weak_scaling} on the
CPU, against the JAX package's bench tools where they run here.

- ``profile_variants --device cpu``: the strategy names of
  ``bench/profile_variants.py`` (run here once, interpret mode), every
  result at the gate (rel 1e-2 / abs 1e-3 against the f64 oracle) on
  small_32x32 and on ``--random 256x256x0.1``; a strategy that raises
  gives an ``error`` result and exit 1; a refused strategy an
  ``inadmissible`` result; no card without ``--device cpu`` exits 2.
- ``hbm_control --device cpu --stream-mb 1``: three records, the stream
  equal to ``2 * x + 1`` bit for bit, the matmul shapes from the port's own
  panel and pair plans, no ``frac_of_nominal`` off the card.
- ``weak_scaling --device cpu --devices 1,2,4``: gloo ranks, one process
  each; the C gathered at every count is the base C stacked count times,
  bit for bit (each rank's shard is one copy of the base), and passes the
  gate against the oracle of the replicated matrix, as
  ``tests/test_parallel.py::test_weak_scaling_consistency`` holds JAX's.
"""

import json

import numpy as np
import pytest
import torch

from bench import profile_variants as jprofile
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.formats import convert
from tpuspmm_torch.kernels import csr_vmem, pair_spmm, panel_spmm, tile_spmm
from tpuspmm_torch.ops import oracle
from tpuspmm_torch.tools import (hbm_control, profile_variants,
                                 serve_compare, weak_scaling)
from tpuspmm_torch.utils.compare import allclose

RANDOM = ["--random", "256x256x0.1", "--width", "64"]


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_names():
    """The variant names JAX's tool gives on the random operand."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jprofile.main(RANDOM + ["--repeats", "1"]) == 0
    return [r["variant"] for r in last_json(out.getvalue())["results"]]


@pytest.mark.parametrize("argv", [["-d", "small_32x32"], RANDOM],
                         ids=["small_32x32", "random_256"])
def test_profile_variants_names_and_gates(argv, jax_names, capsys):
    assert profile_variants.main(argv + ["--device", "cpu",
                                         "--repeats", "2"]) == 0
    line = last_json(capsys.readouterr().out)
    names = [r["variant"] for r in line["results"]]
    assert names == jax_names
    for r in line["results"]:
        assert r["correct"] is True and r["device_ms"] is None, r
        assert r["ms"] > 0 and "error" not in r
    assert line["device"] == "cpu" and line["timer"] == "host"


def test_profile_variants_results_are_the_strategies_outputs(capsys):
    """Each strategy's callable is the entry point it names: its output
    passes the gate on the same operands."""
    import argparse

    args = argparse.Namespace(random="256x256x0.1", width=64, data_dir=None,
                              skip="", tile_ks="128,256", chunks="128")
    a, b, name = profile_variants.load_operands(args)
    assert name == "random_256x256x0.1" and b.shape == (256, 64)
    ref = oracle.spmm_scipy_oracle(a, b)
    got = profile_variants.strategies(a, args, torch.device("cpu"))
    assert [n for n, _, _ in got] == [
        "xla_segment_sum", "pallas_tile_tk128_c128", "pallas_tile_tk256_c128",
        "pallas_c_resident", "pallas_staged_b", "xla_densify_matmul",
        "vendor_bcoo"]
    for n, fn, refusal in got:
        assert refusal is None and allclose(fn(torch.from_numpy(b)), ref), n


def test_profile_variants_a_raising_strategy_exits_1(monkeypatch, capsys):
    def boom(*_a, **_k):
        raise RuntimeError("injected")

    monkeypatch.setattr(tile_spmm, "spmm_tiles", boom)
    assert profile_variants.main(RANDOM + ["--device", "cpu", "--repeats",
                                           "1", "--tile-ks", "128"]) == 1
    line = last_json(capsys.readouterr().out)
    by = {r["variant"]: r for r in line["results"]}
    assert by["pallas_tile_tk128_c128"]["error"] == "RuntimeError: injected"
    assert by["pallas_c_resident"]["correct"] is True  # the rest still ran


def test_profile_variants_refused_strategy_is_recorded(monkeypatch, capsys):
    monkeypatch.setattr(csr_vmem, "fits_whole_b", lambda *a: False)
    assert profile_variants.main(RANDOM + ["--device", "cpu", "--repeats",
                                           "1", "--skip", "tile"]) == 0
    by = {r["variant"]: r for r in last_json(
        capsys.readouterr().out)["results"]}
    assert by["pallas_staged_b"]["inadmissible"]["rule"] == (
        "B stripe in opt-in shared memory")
    assert "ms" not in by["pallas_staged_b"]


def test_tools_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert profile_variants.main(RANDOM) == 2
    assert hbm_control.main([]) == 2
    assert weak_scaling.main(["--devices", "1"]) == 2
    assert serve_compare.main(["."]) == 2


def test_hbm_control_three_records_from_the_ports_plans(capsys):
    assert hbm_control.main(["--device", "cpu", "--stream-mb", "1",
                             "--repeats", "1", "--data-dir", "medium_2048",
                             "--width", "128"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["control"] for r in recs] == ["stream", "matmul_sol",
                                            "matmul_pair"]
    stream = recs[0]
    assert stream["equal_to_plain"] and stream["library_equal"]
    assert stream["elements"] == 2 ** 18 and stream["bytes"] == 2 ** 21
    a = convert.load_sparse(data_dir("medium_2048"), "csr")
    plans = hbm_control.plan_controls(data_dir("medium_2048"), 128,
                                      torch.device("cpu"))
    geom = panel_spmm.resolve_panel_geometry(
        a, 128, plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP, device="cpu")
    panel = panel_spmm.panel_plan_from_geometry(a, geom)
    assert plans["matmul_sol"] == (panel.m_pad, panel.plan_bytes)
    pgeom = pair_spmm.resolve_pair_geometry(
        a, 128, plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP, device="cpu")
    assert plans["matmul_pair"][1] == pair_spmm.pair_plan_from_container(
        a, chunk_strips=pgeom.chunk_strips, n_pad=128, geom=pgeom,
        device="cpu").plan_bytes
    for r in recs:
        assert r["card"] == "cpu" and "frac_of_nominal" not in r
    for r in recs[1:]:
        m, plan_bytes = plans[r["control"]]
        assert r["m"] == m and r["plan_bytes"] == plan_bytes
        assert r["kd"] == max(128, round(plan_bytes / (m * 2) / 128) * 128)
        c_size = 4 if r["c_dtype"] == "torch.float32" else 2
        assert r["bytes"] == (m * r["kd"] * 2 + r["kd"] * r["n"] * 2
                              + m * r["n"] * c_size)


def test_stream_kernel_wrapper_on_the_cpu():
    x = torch.linspace(-3, 3, 1001)
    assert torch.equal(hbm_control_stream(x), 2 * x + 1)
    with pytest.raises(ValueError, match="1-D float32"):
        hbm_control_stream(x.double())


def hbm_control_stream(x):
    from tpuspmm_torch.kernels import stream_cuda

    before = stream_cuda.stream.launches
    y = stream_cuda.stream(x)
    assert stream_cuda.stream.launches == before  # the CPU: no launch
    return y


def test_weak_scaling_gloo_ranks(tmp_path, capsys):
    save = tmp_path / "c"
    assert weak_scaling.main([
        "--device", "cpu", "--devices", "1,2,4", "--base-dir", "small_32x32",
        "--local", "tile", "--repeats", "2", "--save-dir", str(save)]) == 0
    line = last_json(capsys.readouterr().out)
    assert [r["devices"] for r in line["scaling"]] == [1, 2, 4]
    assert line["dropped"] == [] and line["width"] == 32
    base = convert.load_sparse(data_dir("small_32x32"), "csr")
    b = np.asarray(convert.load_dense(data_dir("small_32x32")).data,
                   np.float32)
    c1 = np.load(save / "c_n1.npy")
    for r in line["scaling"]:
        n = r["devices"]
        assert r["correct"] and r["nnz"] == n * base.nnz
        c = np.load(save / f"c_n{n}.npy")
        np.testing.assert_array_equal(c, np.tile(c1, (n, 1)))
        ref = oracle.spmm_scipy_oracle(weak_scaling.replicate_rows(base, n),
                                       b)
        assert allclose(c, ref)
    assert line["scaling"][0]["efficiency"] == 1.0


def test_stream_binding_matches_the_source():
    """The ctypes argument types are the C entry's, parameter for
    parameter (a pointer bound as an int would be cut to 32 bits)."""
    import ctypes
    import re
    import types

    from tpuspmm_torch.kernels import stream_cuda

    with open(stream_cuda.LIBRARY.source) as f:
        src = f.read()
    params = re.search(r"int stream_2x_plus_1\(([^)]*)\)", src).group(1)
    kinds = [" ".join(p.split()[:-1]) for p in params.split(",")]
    want = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int}
    lib = types.SimpleNamespace(stream_2x_plus_1=types.SimpleNamespace(),
                                stream_error_string=types.SimpleNamespace())
    stream_cuda._bind(lib)
    assert lib.stream_2x_plus_1.argtypes == [want[k] for k in kinds]
    assert lib.stream_2x_plus_1.restype is ctypes.c_int


def test_strip_sweep_patches_apply_once():
    """Every variant patch of ``strip_sweep.py`` names text that is in
    its source exactly once (else that variant's build is an error record
    on the card), the running-sums controls among them; every override
    variant sets constants that its module has, to values of their type,
    and shares no name with a patch variant."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import strip_sweep

    from tpuspmm_torch.kernels import bsr_cuda, chunk_cuda, strip_cuda

    for variants, source, patches_of in (
            (strip_sweep.VARIANTS, strip_cuda.SOURCE, lambda v: v),
            (strip_sweep.CHUNK_VARIANTS, chunk_cuda.SOURCE, lambda v: v[0]),
            (strip_sweep.BSR_VARIANTS, bsr_cuda.SOURCE, lambda v: v)):
        with open(source) as f:
            text = f.read()
        for name, value in variants.items():
            for old, _ in patches_of(value):
                assert text.count(old) == 1, (os.path.basename(source), name)
    assert "running_sums" in strip_sweep.VARIANTS
    assert "running_sums" in strip_sweep.CHUNK_VARIANTS
    for overrides, module, patched in (
            (strip_sweep.BSR_OVERRIDES, bsr_cuda, strip_sweep.BSR_VARIANTS),
            (strip_sweep.CHUNK_OVERRIDES, chunk_cuda,
             strip_sweep.CHUNK_VARIANTS)):
        assert overrides and not set(overrides) & set(patched)
        for name, values in overrides.items():
            for const, value in values.items():
                assert const.isupper() and hasattr(module, const), (name,
                                                                    const)
                assert type(value) is type(getattr(module, const)), name


@pytest.mark.parametrize("name", ["ws_waves0", "ws_one_consumer",
                                  "ws_persistent", "ws_no_persist", "tn64",
                                  "tn128"])
def test_strip_sweep_overrides_reach_the_binding(name, monkeypatch):
    """An override variant of ``strip_sweep.py`` changes what its bindings
    hand the C entry on the serving library, and only inside its block:
    K6's consumers, grid and tiles (16 block rows of 128 on 132 SMs: at
    w512 and w1024 one consumer and a block a tile, at w4096 two
    consumers and a persistent grid of 132 blocks over 512 tiles), the
    tile-owner routine's column tile (3 row tiles at w256, every tile
    dense: 64 on 132 SMs, 128 on 6; an index with no dense tile takes the
    gather build, which has none).  The card is stood in for."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import strip_sweep

    from tpuspmm_torch.formats import tiles
    from tpuspmm_torch.kernels import bsr_cuda, chunk_cuda, cuda_build

    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    if name in strip_sweep.CHUNK_OVERRIDES:
        rng = np.random.default_rng(3)
        r, c = rng.integers(0, 300, 900), rng.integers(0, 700, 900)
        tp = tiles.build_tile_plan(r, c, np.ones(900, np.float32),
                                   (300, 700))
        idx = tile_spmm.index_arrays(tp, "cpu", 1.0)
        b = torch.zeros(700, 256)

        def tn(sms):
            monkeypatch.setattr(cuda_build, "sm_count", lambda device: sms)
            return chunk_cuda.bind("tile_chunk_spmm", idx, b, 300,
                                   tp.tile_m, tp.tile_k,
                                   False).shape["column_tile"]

        assert (tn(132), tn(6)) == (64, 128)
        with strip_sweep.overridden(chunk_cuda,
                                    strip_sweep.CHUNK_OVERRIDES[name]):
            want = int(name[2:])
            assert (tn(132), tn(6)) == (want, want)
        assert (tn(132), tn(6)) == (64, 128)
        return
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 132)
    arrays = (torch.arange(17, dtype=torch.int32),
              torch.zeros(16, dtype=torch.int32),
              torch.arange(16, dtype=torch.int32),
              torch.zeros(bsr_cuda.planes_shape(16, 128, 128),
                          dtype=torch.int16))

    def shape(n):
        s = bsr_cuda.bind(*arrays, torch.zeros(128, n, dtype=torch.bfloat16),
                          1, (128, 128)).shape
        return s["consumers"], s["grid"], s["tiles"]

    widths = (512, 1024, 4096)
    serving = {n: shape(n) for n in widths}
    assert serving == {512: (1, 128, 128), 1024: (1, 256, 256),
                       4096: (2, 132, 512)}
    with strip_sweep.overridden(bsr_cuda, strip_sweep.BSR_OVERRIDES[name]):
        got = {n: shape(n) for n in widths}
    want = {"ws_waves0": {512: (2, 64, 64), 1024: (2, 128, 128),
                          4096: (2, 132, 512)},
            "ws_one_consumer": {512: (1, 128, 128), 1024: (1, 256, 256),
                                4096: (1, 132, 1024)},
            "ws_persistent": {512: (1, 128, 128), 1024: (1, 132, 256),
                              4096: (2, 132, 512)},
            "ws_no_persist": {512: (1, 128, 128), 1024: (1, 256, 256),
                              4096: (2, 512, 512)}}[name]
    assert got == want
    assert {n: shape(n) for n in widths} == serving


# the gather build's shape on a 300-row index with no dense tile at f32
# w256, on 1 and on 132 SMs: (rows a warp, warps, passes, grid)
GATHER_SERVING = {1: (2, 8, 2, [19, 1]), 132: (1, 8, 2, [38, 1])}
GATHER_WANT = {
    "gather_rows1": {1: (1, 8, 2, [38, 1]), 132: (1, 8, 2, [38, 1])},
    "gather_rows2": {1: (2, 8, 2, [19, 1]), 132: (2, 8, 2, [19, 1])},
    "gather_rows4": {1: (4, 8, 2, [10, 1]), 132: (1, 8, 2, [38, 1])},
    "gather_warps4": {1: (2, 4, 2, [38, 1]), 132: (1, 4, 2, [75, 1])},
    "gather_rows1_warps4": {1: (1, 4, 2, [75, 1]),
                            132: (1, 4, 2, [75, 1])},
    "gather_one_pass": {1: (2, 8, 1, [19, 2]), 132: (1, 8, 1, [38, 2])}}


@pytest.mark.parametrize("name", list(GATHER_WANT))
def test_strip_sweep_gather_overrides_reach_the_binding(name, monkeypatch):
    """A gather override of ``strip_sweep.py --chunk`` changes the shape
    that ``chunk_cuda.bind`` hands ``gather_spmm`` for an index with no
    dense tile (300 rows, f32 B w256), only inside its block: rows a warp
    (one where a warp a row fits the SMs in one wave, else 2), warps a
    block, passes over f32 B.  The card is stood in for."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import strip_sweep

    from tpuspmm_torch.formats import tiles
    from tpuspmm_torch.kernels import chunk_cuda, cuda_build

    assert set(GATHER_WANT) == {n for n in strip_sweep.CHUNK_OVERRIDES
                                if n.startswith("gather_")}
    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 300, 900), rng.integers(0, 700, 900)
    tp = tiles.build_tile_plan(r, c, np.ones(900, np.float32), (300, 700))
    idx = tile_spmm.index_arrays(tp, "cpu", float("inf"))
    b = torch.zeros(700, 256)

    def shapes():
        got = {}
        for sms in (1, 132):
            monkeypatch.setattr(cuda_build, "sm_count", lambda device: sms)
            s = chunk_cuda.bind("tile_chunk_spmm", idx, b, 300, tp.tile_m,
                                tp.tile_k, False).shape
            got[sms] = (s["rows_per_warp"], s["warps"], s["passes"],
                        s["grid"])
        return got

    assert shapes() == GATHER_SERVING
    with strip_sweep.overridden(chunk_cuda,
                                strip_sweep.CHUNK_OVERRIDES[name]):
        assert shapes() == GATHER_WANT[name]
    assert shapes() == GATHER_SERVING
