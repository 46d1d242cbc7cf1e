"""tpuspmm_torch's engine (registry, runner, CLI) and dispatcher against
tpuspmm's.

- The registries carry the JAX package's numbers, names and
  ``verified_only`` flags, and the admission predicates they share agree.
- The dispatcher takes the JAX package's route on every ``data/`` dir when
  both price with the same cost constants (the JAX package's; the card's
  step and strip costs are not fitted yet), and under a lowered plan-bytes
  cap both fall through to the tile family or the gather path alike.
  Inside the tile family the port's member follows the card's residency
  rule: staged when the whole B stripe stages in one slab, else
  C-resident.
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
from tpuspmm_torch.kernels import dispatch, panel_spmm
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


@pytest.mark.parametrize("fmt", ["csr", "coo"])
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_engine(fmt)


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
    """Both dispatchers price with the JAX package's cost constants."""
    row = dict(jdispatch.thresholds())
    monkeypatch.setattr(dispatch, "thresholds", lambda device="cpu": row)
    return row


@pytest.mark.parametrize("name", DIRS)
def test_routes_match_jax(name, jax_route, jax_constants):
    for fmt in ("csr", "coo"):
        a_j, a_t = load(name, fmt)
        assert dispatch.route(a_t, torch.zeros(a_t.shape[1], 256)) == \
            jax_route(a_j, 256), fmt


TILE_FAMILY = ("staged", "cres", "tile")


@pytest.mark.parametrize("name", DIRS)
def test_tile_fallthrough_under_lowered_cap(name, jax_route, jax_constants,
                                            monkeypatch):
    """No panel or pair plan fits: both packages fall through alike; the
    port's tile-family member is the card's residency rule's."""
    monkeypatch.setitem(jax_constants, "panel_max_plan_bytes", 1)
    monkeypatch.setattr(jdispatch, "thresholds", lambda: jax_constants)
    monkeypatch.setattr(panel_spmm, "PLAN_BYTES_CAP", 1)
    from tpuspmm_torch.kernels import pair_spmm

    monkeypatch.setattr(pair_spmm, "PLAN_BYTES_CAP", 1)
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
    from tpuspmm_torch.kernels import cres_spmm, pair_spmm
    from tpuspmm_torch.ops import oracle

    monkeypatch.setattr(panel_spmm, "PLAN_BYTES_CAP", 1)
    monkeypatch.setattr(pair_spmm, "PLAN_BYTES_CAP", 1)
    _, a = load("medium_2048")
    b = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2048, 64)).astype(np.float32))
    ref = oracle.spmm_scipy_oracle(a, b.numpy())
    assert dispatch.route(a, b) == "cres"
    assert allclose(dispatch.spmm_pallas(a, b), ref)
    monkeypatch.setattr(cres_spmm, "fits_card_out", lambda tm, dev: False)
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
def test_cli_later_flags_exit_2(flag, capsys, small32_dir):
    assert cli.main(["--csr", "-d", small32_dir, flag]) == 2
    assert "ROADMAP" in capsys.readouterr().err


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
