"""tpuspmm_torch's engine (registry, runner, CLI) and dispatcher against
tpuspmm's.

- The registries carry the JAX package's numbers, names and
  ``verified_only`` flags, and the admission predicates they share agree.
- The dispatcher takes the JAX package's route on every ``data/`` dir when
  both read JAX's row (no serve-time model: JAX's fixed order), and under
  a lowered plan-bytes cap both fall through to the tile family or the
  gather path alike.  Inside the tile family the port's member follows
  the card's residency rule: staged when the whole B stripe stages in one
  slab, else C-resident.  Under the port's H100 row its routes are pinned,
  and each one that differs from JAX's is cheaper in the port's model and
  faster in a committed record of the card.
- ``tpuspmm_torch.cli`` on the CPU gives the same (format, kernel number,
  name, correct) records as ``tpuspmm.cli``, the vendor's name aside.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpuspmm.cli as jcli
from tpuspmm.config import default_config as jdefault_config
from tpuspmm.engine import registry as jregistry
from tpuspmm.formats import convert as jconvert
from tpuspmm.kernels import bsr_spmm as jk6
from tpuspmm.kernels import cres_spmm as jk5
from tpuspmm.kernels import csr_vmem as jk4
from tpuspmm.kernels import dispatch as jdispatch
from tpuspmm.kernels import pair_spmm as jpair
from tpuspmm.kernels import panel_spmm as jpanel
from tpuspmm.kernels import tile_spmm as jk3
from tpuspmm.ops import exact as jexact
from tpuspmm_torch import cli
from tpuspmm_torch.config import Config
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.engine import registry, runner
from tpuspmm_torch.formats import convert
from tpuspmm_torch.kernels import dispatch
from tpuspmm_torch.utils.compare import allclose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRS = sorted(d for d in os.listdir(os.path.join(REPO, "data"))
              if not d.endswith(".md"))
_LOADED = {}


def load(name, fmt="csr"):
    """(JAX container, port container), loaded once per module."""
    if (name, fmt) not in _LOADED:
        d = data_dir(name)
        _LOADED[name, fmt] = (jconvert.load_sparse(d, fmt),
                              convert.load_sparse(d, fmt))
    return _LOADED[name, fmt]


@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "ell"])
def test_registry_matches_jax(fmt):
    mine = registry.get_engine(fmt)
    theirs = jregistry.get_engine(fmt)
    assert [(v.number, v.name, v.verified_only) for v in mine.variants] == \
        [(v.number, v.name, v.verified_only) for v in theirs.variants]
    assert [v.admissible is None for v in mine.variants] == \
        [v.admissible is None for v in theirs.variants]
    assert mine.num_kernels == theirs.num_kernels
    assert mine.supports_vendor and theirs.supports_vendor


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_later_engines_raise(fmt):
    """The BSR and ELL engines, a later slice before, are built now, with
    JAX's variant counts; only a format no engine serves raises."""
    assert registry.get_engine(fmt).num_kernels == \
        {"bsr": 7, "ell": 8}[fmt] == jregistry.get_engine(fmt).num_kernels
    assert fmt in registry.FORMATS
    with pytest.raises(KeyError):
        registry.get_engine("dia")


SHARED = ("_gather_ok", "_densify_ok", "_panel_ok", "_pair_ok",
          "_compensated_ok")


@pytest.mark.parametrize("name", ["small_32x32", "medium_2048",
                                  "medium_2880", "large_25605"])
def test_shared_admission_agrees(name):
    a_j, a_t = load(name)
    jconfig = jdefault_config()
    for n in (256, 600_000):  # the second breaches the gather cap
        b_j = np.empty((a_j.shape[1] if n == 256 else 1, n), np.float32)
        b_t = torch.empty(b_j.shape)
        for pred in SHARED:
            if n != 256 and pred in ("_panel_ok", "_pair_ok"):
                continue  # a plan search at that width is not the point
            assert getattr(registry, pred)(a_t, b_t, Config()) == \
                getattr(jregistry, pred)(a_j, b_j, jconfig), (pred, n)


class _Served(Exception):
    pass


@pytest.fixture
def jax_route(monkeypatch):
    """The path tpuspmm's spmm_pallas takes, recorded at the call that
    would serve it (nothing is computed)."""
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


@pytest.fixture
def jax_constants(monkeypatch):
    """Both dispatchers price with the JAX package's cost constants (the
    port's row replaced, so that a served handle built under the H100 row
    is built again)."""
    row = dict(jdispatch.thresholds())
    monkeypatch.setattr(dispatch, "H100_FIT", row)
    return row


@pytest.mark.parametrize("name", DIRS)
def test_routes_match_jax(name, jax_route, jax_constants):
    for fmt in ("csr", "coo"):
        a_j, a_t = load(name, fmt)
        assert dispatch.route(a_t, torch.zeros(a_t.shape[1], 256)) == \
            jax_route(a_j, 256), fmt


# the port's route on every data/ dir at w256 under its H100 row, CSR and
# COO: the routes JAX's rules admit, priced by the serve-time model
H100_ROUTES = {
    "large_15120": "cres", "large_20000": "exact", "large_21074": "cres",
    "large_25605": "cres", "medium_1484": "exact", "medium_2048": "cres",
    "medium_2880": "exact", "medium_4000": "panel", "medium_4096": "cres",
    "small_10x10": "densify", "small_210": "densify",
    "small_32x32": "densify",
}


def committed_routes(operand, width, b_dtype="f32"):
    """The routes record of one operand in tools/routing_h100.jsonl: every
    admitted route served through spmm on the card, gated and timed."""
    from tpuspmm_torch.tools import fit_routing as fr

    recs = [r for r in fr.route_records(fr.read_records([os.path.join(
        os.path.dirname(fr.__file__), "routing_h100.jsonl")]))
        if (r["operand"], r["width"], r["b_dtype"]) == (operand, width,
                                                        b_dtype)]
    assert len(recs) == 1, (operand, width, b_dtype)
    return {kind: fr.served_ms(side) for kind, side in recs[0]["routes"]
            .items()}


@pytest.mark.parametrize("name", DIRS)
def test_routes_match_jax_under_the_h100_fit(name, jax_route, monkeypatch):
    """JAX's dispatcher fed the port's fitted H100 row
    (``dispatch.H100_FIT``; its serve-time keys are the port's own) and
    the port's on every dir, CSR and COO: the port's route is pinned
    (H100_ROUTES); where it is not JAX's route, the port's is the cheaper
    in the model (``dispatch.route_costs``) and a committed record of the
    card (the routes record at w256, f32 B) shows it served faster.
    Fresh containers: the geometries cached on them were priced
    otherwise."""
    row = dict(jdispatch.thresholds(), **dispatch.thresholds("cpu"))
    monkeypatch.setattr(jdispatch, "thresholds", lambda: row)
    d = data_dir(name)
    for fmt in ("csr", "coo"):
        a_j, a_t = jconvert.load_sparse(d, fmt), convert.load_sparse(d, fmt)
        b = torch.zeros(a_t.shape[1], 256)
        mine, theirs = dispatch.route(a_t, b), jax_route(a_j, 256)
        assert mine == H100_ROUTES[name], fmt
        if mine != theirs:
            costs = dispatch.route_costs(a_t, b)
            assert costs[mine] < costs[theirs], fmt
            measured = committed_routes(name, 256)
            assert measured[mine] < measured[theirs], fmt


TILE_FAMILY = ("staged", "cres", "tile")


@pytest.mark.parametrize("name", DIRS)
def test_tile_fallthrough_under_lowered_cap(name, jax_route, jax_constants,
                                            monkeypatch):
    """No panel or pair plan fits: both packages fall through alike; the
    port's tile-family member is the card's residency rule's."""
    # one row, the cap in it, read by both dispatchers
    monkeypatch.setitem(jax_constants, "panel_max_plan_bytes", 1)
    monkeypatch.setattr(jdispatch, "thresholds", lambda: jax_constants)
    a_j, a_t = load(name)
    theirs = jax_route(a_j, 256)
    mine = dispatch.route(a_t, torch.zeros(a_t.shape[1], 256))
    assert theirs not in ("panel", "pair")
    if theirs in TILE_FAMILY:
        k_pad = -(-a_t.shape[1] // 128) * 128
        assert mine == ("staged" if k_pad <= 768 else "cres")
    else:
        assert mine == theirs


def test_tile_family_serves_at_the_gate(monkeypatch):
    """The fall-through really serves: C-resident, then tile when the
    accumulator rule is refused, each at the gate against the oracle."""
    from tpuspmm_torch.kernels import cres_spmm
    from tpuspmm_torch.ops import oracle

    # no panel or pair plan, and no densify (medium_2048 is above the
    # row's density floor)
    monkeypatch.setitem(dispatch.H100_FIT, "panel_max_plan_bytes", 1)
    monkeypatch.setitem(dispatch.H100_FIT, "densify_min_density",
                        float("inf"))
    _, a = load("medium_2048")
    b = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2048, 64)).astype(np.float32))
    ref = oracle.spmm_scipy_oracle(a, b.numpy())
    assert dispatch.route(a, b) == "cres"
    assert allclose(dispatch.spmm_pallas(a, b), ref)
    monkeypatch.setattr(cres_spmm, "fits_card_out", lambda tm, dev: False)
    # a fresh container: the route is cached on the one above
    a = convert.load_sparse(data_dir("medium_2048"), "csr")
    assert dispatch.route(a, b) == "tile"
    assert allclose(dispatch.spmm_pallas(a, b), ref)


def records(lines):
    out = []
    for line in lines.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            out.append((r["format"], r["kernelType"],
                        "vendor" if r["kernelType"] == "-1"
                        else r["kernelName"], r["correct"],
                        r.get("skipped", "")))
    return out


def test_cli_matches_jax_cli(capsys, small32_dir):
    args = ["--csr", "--coo", "-d", small32_dir, "--repeats", "1"]
    assert jcli.main(args) == 0
    theirs = records(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    mine_out = capsys.readouterr().out
    assert records(mine_out) == theirs
    assert len(theirs) == 2 + 11 + 7 + 2
    recs = [json.loads(x) for x in mine_out.splitlines()]
    assert {r["device"] for r in recs} == {"cpu"}
    assert all("gflops" not in r for r in recs)  # no CPU device metrics
    vendor = [r for r in recs if r["kernelType"] == "-1"]
    assert {r["kernelName"] for r in vendor} == {"torch_sparse_csr"}


@pytest.mark.parametrize("flag", ["--bsr", "--ell", "--auto", "--tuned",
                                  "--trace=out"])
def test_cli_later_flags_exit_2(flag, capsys, small32_dir, tmp_path,
                                monkeypatch):
    """Every flag of the JAX package's CLI is ported and runs (here on the
    CPU), passing the gate: --bsr, --ell and --auto run their engines,
    --tuned prints one record with the winner and its ranking, --trace
    writes a profiler trace into its directory."""
    monkeypatch.chdir(tmp_path)  # --trace=out writes under tmp_path
    args = ["--csr", "-d", small32_dir, flag]
    assert cli.main(args + ["--device", "cpu", "--repeats", "1",
                            "--no-vendor"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    fmts = {"--bsr": {"csr", "bsr"}, "--ell": {"csr", "ell"},
            "--auto": {"csr"}, "--tuned": {"csr"},
            "--trace=out": {"csr"}}[flag]
    assert {r["format"] for r in recs} == fmts
    assert all(r["correct"] == "1" for r in recs)
    if flag == "--tuned":
        assert len(recs) == 1 and recs[0]["tuned"] == "1"
        assert recs[0]["kernelName"] == recs[0]["ranking"][0]["kernel"]
    if flag == "--trace=out":
        assert (tmp_path / "out" / "trace.json").stat().st_size > 0


def test_cli_needs_its_device(monkeypatch, capsys, small32_dir):
    """With no CUDA device the default --device cuda exits non-zero and
    does not move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--csr", "-d", small32_dir]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA" in captured.err
    assert cli.main(["--csr", "-d", small32_dir, "--device", "meta"]) == 2
    assert cli.main(["--csr", "-d", "no_such_dir", "--device", "cpu"]) == 2


def test_cli_exit_status_follows_the_gate(monkeypatch, capsys, small32_dir):
    """A failing variant that is not verified-only makes the status 1; a
    failing verified-only one does not."""
    engine = registry.get_engine("csr")
    bad = lambda a, b, config: torch.zeros(a.shape[0], b.shape[1])  # noqa
    monkeypatch.setattr(engine.variant(6), "fn", bad)
    args = ["--csr", "-d", small32_dir, "--device", "cpu", "--repeats", "1",
            "--no-vendor", "--skip-seq"]
    assert cli.main(args) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["kernelType"], r["correct"], r.get("verifiedOnly"))
            for r in recs if r["correct"] == "0"] == [("6", "0", "1")]
    monkeypatch.setattr(engine.variant(2), "fn", bad)
    assert cli.main(args) == 1


def test_runner_record_policy(monkeypatch, small32_dir):
    """Inadmissible variants are skipped with a record, a raising variant
    gets an error record and the sweep goes on, and bf16 B is served in
    its dtype and checked against the oracle of its values."""
    engine = registry.get_engine("coo")
    a = convert.load_sparse(small32_dir, "coo")
    b = torch.from_numpy(convert.load_dense(small32_dir).data).to(
        torch.bfloat16)

    def boom(a, b, config):
        raise RuntimeError("no")

    monkeypatch.setattr(engine.variant(3), "admissible", lambda *x: False)
    monkeypatch.setattr(engine.variant(4), "fn", boom)
    recs = runner.run_engine(engine, a, b, testcase="t", repeats=1,
                             emit=False, device="cpu")
    by = {r["kernelType"]: r for r in recs}
    assert list(by) == ["0", "1", "2", "3", "4", "5", "6", "7", "-1"]
    assert by["3"]["skipped"] == "inadmissible" and by["3"]["correct"] == ""
    assert by["4"]["error"] == "RuntimeError: no" and by["4"]["correct"] == ""
    assert all(by[k]["correct"] == "1" for k in ("0", "1", "2", "5", "6",
                                                 "7", "-1"))
    assert {r["bDtype"] for r in recs} == {"bf16"}
    assert by["5"]["geometry"]["family"] == "pair"
    with pytest.raises(RuntimeError, match="CUDA"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        runner.run_engine(engine, a, b, emit=False, device="cuda")


def test_run_kernel_numbering(small32_dir):
    engine = registry.get_engine("csr")
    a = convert.load_sparse(small32_dir, "csr")
    b = torch.from_numpy(convert.load_dense(small32_dir).data)
    ref = engine.run_kernel(0, a, b)
    assert isinstance(ref, torch.Tensor) and ref.dtype == torch.float32
    for number in (-1, *range(1, engine.num_kernels + 1)):
        assert allclose(engine.run_kernel(number, a, b), ref), number
    with pytest.raises(KeyError):
        engine.run_kernel(12, a, b)


def test_python_m_cli_runs_one_kernel():
    res = subprocess.run(
        [sys.executable, "-m", "tpuspmm_torch.cli", "--csr", "-d",
         "small_10x10", "--device", "cpu", "--kernel", "5"],
        capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr
    (rec,) = [json.loads(x) for x in res.stdout.splitlines()]
    assert (rec["kernelType"], rec["kernelName"], rec["correct"]) == \
        ("5", "pallas_c_resident", "1")


# ---------------------------------------------------------------------------
# the BSR and ELL engines, their routes and format selection
# ---------------------------------------------------------------------------

BSR_SHARED = SHARED + ("_bsr_gather_ok",)


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
@pytest.mark.parametrize("name", ["small_32x32", "small_210", "medium_2048",
                                  "medium_4096"])
def test_bsr_ell_admission_agrees(name, fmt):
    a_j, a_t = load(name, fmt)
    jconfig = jdefault_config()
    for n in (256, 600_000):
        b_j = np.empty((a_j.shape[1] if n == 256 else 1, n), np.float32)
        b_t = torch.empty(b_j.shape)
        for pred in (BSR_SHARED if fmt == "bsr" else SHARED):
            if n != 256 and pred in ("_panel_ok", "_pair_ok"):
                continue
            assert getattr(registry, pred)(a_t, b_t, Config()) == \
                getattr(jregistry, pred)(a_j, b_j, jconfig), (pred, n)


def _engine_cases(fmt):
    """(JAX container, port container) pairs: small_32x32 and a random
    BSR in (8, 128) blocks with empty block rows (its ELL conversion for
    the ELL engine)."""
    from tpuspmm.formats import BSR as JBSR
    from tpuspmm_torch.formats import BSR

    args = (48, 256, (8, 128), 0.3, 4)
    blocks = (JBSR.random_blocks(*args), BSR.random_blocks(*args))
    if fmt == "ell":
        blocks = (jconvert.to_format(blocks[0], "ell"),
                  convert.to_format(blocks[1], "ell"))
    return [load("small_32x32", fmt), blocks]


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_bsr_ell_variants_match_jax(fmt):
    """Every variant of the port's engine against the JAX variant of the
    same number on the same operands, within f32 summation order
    (1e-5·max|C|), and at the gate; admission agrees."""
    from tpuspmm_torch.ops import oracle

    mine, theirs = registry.get_engine(fmt), jregistry.get_engine(fmt)
    jconfig = jdefault_config()
    for a_j, a_t in _engine_cases(fmt):
        b = np.random.default_rng(21).uniform(
            -1, 1, (a_t.shape[1], 40)).astype(np.float32)
        tb = torch.from_numpy(b)
        ref = oracle.spmm_oracle(a_t, b)
        for v in mine.variants:
            jv = theirs.variant(v.number)
            ok = v.admissible is None or v.admissible(a_t, tb, Config())
            assert ok == (jv.admissible is None
                          or jv.admissible(a_j, b, jconfig)), v.name
            if not ok:
                continue
            got = v.fn(a_t, tb, Config()).numpy()
            want = np.asarray(jv.fn(a_j, b, jconfig))
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got - want).max() <= 1e-5 * scale, v.name
            assert allclose(got, ref), v.name


def test_cli_bsr_ell_matches_jax_cli(capsys, small32_dir):
    args = ["--bsr", "--ell", "-d", small32_dir, "--repeats", "1"]
    assert jcli.main(args) == 0
    theirs = records(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert records(mine) == theirs
    assert len(theirs) == 2 + 7 + 8 + 2
    recs = [json.loads(x) for x in mine.splitlines()]
    bsr = [r for r in recs if r["format"] == "bsr"]
    # records carry the BSR's stored-entry sparsity, as JAX's do
    assert {r["sparsity"] for r in bsr} == {jconvert.load_sparse(
        small32_dir, "bsr").sparsity}
    (stream,) = [r for r in bsr if r["kernelName"] == "pallas_block_stream"]
    assert stream["blockStream"] == "tile"  # 4 x 4 blocks, packing refused


@pytest.mark.parametrize("name", DIRS)
def test_bsr_ell_routes_match_jax(name, jax_route, jax_constants):
    """The dispatcher's route on the BSR ((4, 4) blocks, halved where the
    shape needs it) and ELL containers of every data/ dir is the path
    JAX's dispatcher takes; a 4 x 4 BSR never reaches K6 (packing is
    refused: see the block-stream tests)."""
    for fmt in ("bsr", "ell"):
        a_j, a_t = load(name, fmt)
        mine = dispatch.route(a_t, torch.zeros(a_t.shape[1], 256))
        assert mine == jax_route(a_j, 256), fmt
        assert mine != "bsr_stream"


@pytest.mark.parametrize("args,packed", [
    ((64, 512, (8, 128), 0.4, 0), False), ((256, 256, (4, 4), 0.3, 5), True),
    ((256, 256, (4, 4), 0.002, 7), False)])
def test_bsr_stream_route_matches_jax(args, packed, jax_route,
                                      jax_constants):
    """K6 serves a BSR whose blocks it admits, and a 4 x 4 BSR through its
    packed copy; where packing is refused the route goes on as JAX's."""
    from tpuspmm.formats import BSR as JBSR
    from tpuspmm_torch.formats import BSR
    from tpuspmm_torch.kernels import bsr_spmm

    a_t, a_j = BSR.random_blocks(*args), JBSR.random_blocks(*args)
    kind, served = dispatch._resolve(a_t, torch.zeros(a_t.shape[1], 64))
    assert kind == jax_route(a_j, 64)
    if args[2] == (8, 128) or packed:
        assert kind == "bsr_stream"
        assert served is (bsr_spmm.pack_blocks(a_t) if packed else a_t)
    else:
        assert kind != "bsr_stream"


def test_select_format_matches_jax_except_residency(monkeypatch):
    """select_format agrees with JAX's, both reading the port's row (the
    densify floor and cap are per chip), on every data/ dir but where
    JAX's 8 MiB VMEM rule refuses the whole C: there JAX selects the tile
    kernel and the port, whose rule is one accumulator in shared memory,
    C-resident.  Only large_20000 differs at width 256."""
    from tpuspmm.engine import select as jselect
    from tpuspmm_torch.engine import select

    monkeypatch.setattr(jdispatch, "thresholds",
                        lambda: dispatch.thresholds("cpu"))

    differ = {}
    for name in DIRS:
        a_j, a_t = load(name, "coo")
        mine, theirs = select.select_format(a_t), jselect.select_format(a_j)
        assert vars(select.analyze(a_t)) == vars(jselect.analyze(a_j))
        if mine != theirs:
            differ[name] = (mine, theirs)
    assert differ == {"large_20000": (("csr", "pallas_c_resident"),
                                      ("csr", "pallas_tile_mxu"))}


def test_select_and_auto_spmm_match_jax():
    """Dense blocks select BSR block streaming in both packages; auto_spmm
    runs the selected variant (K6's plain version here) and equals JAX's
    result."""
    from tpuspmm.engine import select as jselect
    from tpuspmm.formats import BSR as JBSR
    from tpuspmm_torch.engine import select
    from tpuspmm_torch.formats import BSR

    args = (64, 512, (8, 128), 0.4, 0)
    cases = [(JBSR.random_blocks(*args), BSR.random_blocks(*args)),
             load("small_32x32", "csr")]
    for a_j, a_t in cases:
        stats_t, stats_j = select.analyze(a_t), jselect.analyze(a_j)
        assert vars(stats_t) == vars(stats_j)
        b = np.random.default_rng(22).uniform(-1, 1, (a_t.shape[1], 16)) \
            .astype(np.float32)
        got, fmt, name = select.auto_spmm(a_t, torch.from_numpy(b))
        want, jfmt, jname = jselect.auto_spmm(a_j, b)
        assert (fmt, name) == (jfmt, jname)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * np.abs(want).max())
    assert select.select_format(cases[0][1]) == \
        ("bsr", "pallas_block_stream")


def test_cli_auto_on_a_bsr_only_dir(tmp_path, capsys):
    """--auto reads a directory with only a `.bsr` and `dense.in` (the
    JAX CLI needs a `.coo` or `.mtx`), selects BSR for 128 x 128 blocks and
    runs the BSR engine, whose block-stream record is K6's."""
    from tpuspmm_torch.formats import BSR
    from tpuspmm_torch.formats import io as fio

    a = BSR.random_blocks(256, 256, (128, 128), 0.5, seed=2)
    a.save(str(tmp_path / "w.bsr"))
    fio.write_dense_text(str(tmp_path / "dense.in"),
                         np.random.default_rng(23).standard_normal(
                             (256, 24)).astype(np.float32))
    assert cli.main(["--auto", "-d", str(tmp_path), "--device", "cpu",
                     "--repeats", "1"]) == 0
    out = capsys.readouterr()
    assert "auto-selected format=bsr kernel=pallas_block_stream" in out.err
    recs = [json.loads(x) for x in out.out.splitlines()]
    assert {r["format"] for r in recs} == {"bsr"}
    assert all(r["correct"] == "1" for r in recs if "skipped" not in r)
    (stream,) = [r for r in recs if r["kernelName"] == "pallas_block_stream"]
    assert stream["blockStream"] == "k6"
    assert stream["sparsity"] == a.sparsity == a.nblocks / 4
