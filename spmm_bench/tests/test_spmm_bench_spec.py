"""Cells, configurations, mixes and readers found by their names."""

import json
import os

import pytest

from spmm_bench import harness, operands, spec, traffic
from spmm_bench.system import Program

from conftest import write_root


def test_every_cell_of_the_benchmark_loads():
    bench = spec.benchmark()
    for work in bench["workloads"]:
        cell = spec.load_cell(work["name"])
        assert cell.chips == work["chips"]
        assert cell.config["name"] == work["config"]
        assert set(traffic.KEYS) <= set(cell.traffic)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        # every metric has its reader
        for metric in cell.per_layer:
            assert callable(spec.reader(metric["name"]))


def test_configurations_state_what_they_were_cut_from():
    bench = spec.benchmark()
    for conf in bench["configs"]:
        with open(os.path.join(spec.ROOT, conf["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == conf["reduced"]
        assert os.path.isfile(operands.generator_path(
            data["operands"]["kind"], spec.ROOT))
        assert data["max_rel_err"] > 0


def test_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("nope.none", tiny_root)


def test_a_cell_added_by_files_alone_runs(tmp_path):
    """A new mix, a new reader and a new BENCHMARK.json entry, and no other
    edit: the harness finds all three by name."""
    root = write_root(str(tmp_path))
    bench_dir = os.path.join(root, "spmm_bench")
    with open(os.path.join(bench_dir, "traffic", "w8.json"), "w") as f:
        json.dump({"b_width": 8, "b_dtype": "float32", "pool": 1,
                   "calls_per_step": 1, "warmup_steps": 1}, f)
    with open(os.path.join(bench_dir, "metrics", "api.calls.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.calls)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny_mtx.w8", "config": "tiny_mtx",
                               "traffic": "w8", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "api.calls", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "API and served handle",
                               "moves": "gflops",
                               "workloads": ["tiny_mtx.w8"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("tiny_mtx.w8", root)
    assert cell.traffic["b_width"] == 8
    assert "api.calls" in [m["name"] for m in cell.per_layer]
    assert "api.calls" not in [m["name"] for m in
                               spec.load_cell("tiny_mtx.w32",
                                              root).per_layer]
    result = harness.run_cell(cell, 11, 0.2, True, "cpu", Program(), root,
                              0.0, str(tmp_path))
    assert result["correct"]
    assert result["metrics"]["api.calls"]["value"] == result["attempted"]


def test_every_cell_reports_what_its_metrics_move():
    for work in spec.benchmark()["workloads"]:
        cell = spec.load_cell(work["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, work["name"]
        for metric in cell.per_layer:
            assert metric["moves"] in e2e, (work["name"], metric["name"])


def test_an_operand_kind_added_by_a_file_alone_runs(tmp_path):
    """A generator of a new kind under ``generators/``, a configuration
    that names it and a cell: the harness finds the generator by name."""
    root = write_root(str(tmp_path))
    bench_dir = os.path.join(root, "spmm_bench")
    with open(os.path.join(bench_dir, "generators", "diagonal.py"),
              "w") as f:
        f.write(
            "import torch\n"
            "from spmm_bench.operands import Operand, generator\n"
            "def build(config, seed, device, root):\n"
            "    n = config['rows']\n"
            "    g = generator(seed, 'diagonal', device)\n"
            "    return [Operand('diag', (n, n),\n"
            "        torch.arange(n + 1, device=device),\n"
            "        torch.arange(n, device=device),\n"
            "        torch.randn(n, generator=g, device=device))]\n")
    with open(os.path.join(bench_dir, "configs", "tiny_diag.json"),
              "w") as f:
        json.dump({"rows": 40, "operands": {"kind": "diagonal"},
                   "b_values": {"dist": "uniform", "low": -1.0,
                                "high": 1.0},
                   "max_rel_err": 1e-5}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_diag", "source": "test",
                             "file": "spmm_bench/configs/tiny_diag.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_diag.w32",
                               "config": "tiny_diag", "traffic": "w32",
                               "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("tiny_diag.w32", root)
    (op,) = operands.build(cell.config, 3, "cpu", root)
    assert op.shape == (40, 40) and op.values.shape == (40,)
    result = harness.run_cell(cell, 3, 0.2, False, "cpu", Program(), root,
                              0.0, str(tmp_path))
    assert result["correct"], result["checks"]


def test_an_unknown_operand_kind_is_refused(tiny_root):
    with pytest.raises(ValueError, match="unknown operand kind"):
        operands.build({"operands": {"kind": "nope"}}, 1, "cpu", tiny_root)
