"""The readers of the program's spans (``source: program_span``): each on a
synthetic table of spans, nothing without one, and a traced run of the
tiny cells on the CPU that reports each where it is meant to."""

import json
import os
import subprocess
import sys
import types

import pytest

from spmm_bench import harness, spec

from conftest import ROOT

MODULE = "tpuspmm_torch.utils.profiling"
# the metrics that read the program's table of spans
SPANS = ("plans.decide_s", "plans.bind_s", "plans.term_planes_s",
         "plans.builds_per_operand", "api.served_us_per_call",
         "api.served_us_per_call.decode", "api.launch_us_per_call",
         "api.launch_us_per_call.decode")
TABLE = {"tpuspmm_torch.served.build": (4, 9.0),
         "tpuspmm_torch.served.decide": (4, 2.5),
         "tpuspmm_torch.served.bind": (4, 6.0),
         "tpuspmm_torch.bsr.term_planes": (2, 5.0),
         "tpuspmm_torch.spmm": (10, 300e-6),
         "tpuspmm_torch.served": (10, 40e-6),
         "tpuspmm_torch.launch.bsr_stream": (6, 120e-6),
         "tpuspmm_torch.launch.cres": (4, 80e-6)}


def ctx(**kw):
    base = dict(calls=8, call_host_s=80e-6, first_serve_s=[0.5, 0.25, 1.0,
                                                          2.0],
                segment=None, least_s=None)
    base.update(kw)
    return harness.Context(**base)


def read(name, c=None):
    return spec.reader(name)(c or ctx())


@pytest.fixture
def table(monkeypatch):
    """The program's profiling module as a reader finds it, holding
    ``TABLE`` (a dict the test may change)."""
    spans = dict(TABLE)
    monkeypatch.setitem(sys.modules, MODULE,
                        types.SimpleNamespace(snapshot=lambda: dict(spans)))
    return spans


def test_every_reader_on_a_table(table):
    assert read("plans.decide_s") == pytest.approx(2.5)
    assert read("plans.bind_s") == pytest.approx(6.0)
    assert read("plans.term_planes_s") == pytest.approx(5.0)
    # four builds over four operands
    assert read("plans.builds_per_operand") == pytest.approx(1.0)
    assert read("plans.builds_per_operand",
                ctx(first_serve_s=[0.5, 0.5])) == pytest.approx(2.0)
    for name in ("api.served_us_per_call", "api.served_us_per_call.decode"):
        assert read(name) == pytest.approx(4.0)
    # every route's launches together: 200 µs over 10 calls
    for name in ("api.launch_us_per_call", "api.launch_us_per_call.decode"):
        assert read(name) == pytest.approx(20.0)


@pytest.mark.parametrize("name", SPANS)
def test_nothing_without_the_span(table, name):
    assert read(name) is not None
    table.clear()
    assert read(name) is None


@pytest.mark.parametrize("name", SPANS)
def test_nothing_without_the_programs_table(monkeypatch, name):
    # the program not loaded (the control), or loaded without a table of
    # spans (a program that records none)
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert read(name) is None
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace())
    assert read(name) is None


def test_builds_per_operand_needs_the_operands(table):
    assert read("plans.builds_per_operand", ctx(first_serve_s=[])) is None


# the cells of the tiny root standing for the real ones, for the metrics'
# ``workloads`` lists
STANDS_FOR = {"n4c6_b13": "tiny_mtx.w32", "olmo_ffn_b128": "tiny_ffn.w16"}


def test_a_traced_run_reports_the_span_metrics(tiny_root, tmp_path):
    """Each tiny cell traced on the CPU in a fresh process (the table is
    the process's): every span metric meant for the cell is reported,
    but K6's term planes, which only a launch on the card builds."""
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    meant = {}
    for metric in bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = sorted({STANDS_FOR[w.split(".")[0]]
                                          for w in metric["workloads"]})
        for cell in metric.get("workloads", STANDS_FOR.values()):
            if metric["name"] in SPANS:
                meant.setdefault(cell, set()).add(metric["name"])
    with open(path, "w") as f:
        json.dump(bench, f)
    assert meant["tiny_ffn.w16"] == set(SPANS)
    for cell in sorted(meant):
        code = (
            "import json\n"
            "from spmm_bench import harness, spec\n"
            "from spmm_bench.system import Program\n"
            f"cell = spec.load_cell({cell!r}, {tiny_root!r})\n"
            "r = harness.run_cell(cell, 2**31 + 9, 0.2, True, 'cpu', "
            f"Program(), {tiny_root!r}, 0.0, {str(tmp_path)!r})\n"
            "print(json.dumps({'correct': r['correct'], 'metrics': {k: "
            "v['value'] for k, v in r['metrics'].items()}}))\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr
        out = json.loads(res.stdout.strip().splitlines()[-1])
        got = out["metrics"]
        assert out["correct"]
        want = meant[cell] - {"plans.term_planes_s"}
        assert want <= set(got), (cell, sorted(want - set(got)))
        assert "plans.term_planes_s" not in got
        assert got["plans.builds_per_operand"] == 1.0
        assert got["plans.decide_s"] + got["plans.bind_s"] <= \
            got["plans.first_serve_s"]
        for name in want - {"plans.builds_per_operand"}:
            assert got[name] > 0, name
