"""The ``pruned_moe`` operands and the DeepSeek-V3 cell
(``dsv3_ep32_b128.prefill_w4096``)."""

import json
import os

import torch

from spmm_bench import harness, operands, spec
from spmm_bench.generators import pruned_moe
from spmm_bench.system import Program

from conftest import write_root

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)
CELL = "dsv3_ep32_b128.prefill_w4096"


def moe_config():
    """One dense layer, then two MoE layers of two held experts and the
    shared expert."""
    return {"hidden_size": 256, "intermediate_size": 384,
            "moe_intermediate_size": 128, "first_k_dense_replace": 1,
            "num_hidden_layers": 3, "n_routed_experts": 2,
            "n_shared_experts": 1,
            "operands": {"kind": "pruned_moe", "block": [128, 128],
                         "block_sparsity": 0.5},
            "b_values": {"dist": "normal", "std": 0.05},
            "max_rel_err": 1e-5}


def arrays(ops):
    return [(op.name, op.shape, op.indptr, op.indices, op.values)
            for op in ops]


def same(x, y):
    return all(a[:2] == b[:2] and all(torch.equal(p, q)
                                      for p, q in zip(a[2:], b[2:]))
               for a, b in zip(x, y))


def test_pruned_moe_repeats_for_a_seed_and_differs_across_seeds():
    runs = {s: arrays(operands.build(moe_config(), s, "cpu", spec.ROOT))
            for s in SEEDS}
    for s in SEEDS:
        assert same(runs[s], arrays(operands.build(moe_config(), s, "cpu",
                                                   spec.ROOT)))
    for s, t in zip(SEEDS, SEEDS[1:]):
        assert not same(runs[s], runs[t])


def test_pruned_moe_does_the_same_work_on_every_seed():
    """Names, shapes, kept blocks a weight and the blocks of each block
    row (in another order) do not depend on the seed."""
    work = {s: [(op.name, op.shape, op.values.shape,
                 sorted(torch.diff(op.indptr).tolist()))
                for op in operands.build(moe_config(), s, "cpu", spec.ROOT)]
            for s in SEEDS}
    assert all(work[s] == work[SEEDS[0]] for s in SEEDS)


def test_pruned_moe_serves_dense_layers_then_experts_then_shared():
    ops = operands.build(moe_config(), 3, "cpu", spec.ROOT)
    want = []
    for layer, owners, width in ((0, [""], 384),
                                 (1, ["expert0.", "expert1.", "shared."],
                                  128),
                                 (2, ["expert0.", "expert1.", "shared."],
                                  128)):
        for owner in owners:
            want += [(f"layer{layer}.{owner}gate", (width, 256)),
                     (f"layer{layer}.{owner}up", (width, 256)),
                     (f"layer{layer}.{owner}down", (256, width))]
    assert [(op.name, op.shape) for op in ops] == want
    assert pruned_moe.layout(moe_config()) == want
    for op in ops:
        nbr, nbc = op.shape[0] // 128, op.shape[1] // 128
        assert op.values.shape[0] == round(0.5 * nbr * nbc)
        assert int(op.indptr[-1]) == op.values.shape[0]


def test_the_configuration_file_gives_225_weights_of_26694_blocks():
    """The cell's operands from its file, counted from the layout alone:
    3 dense layers, then 8 MoE layers of 8 held experts and the shared
    one, 128 x 128 blocks at 90%."""
    cell = spec.load_cell(CELL)
    config = cell.config
    names = pruned_moe.layout(config)
    assert len(names) == 3 * 3 + 8 * 9 * 3 == cell.traffic["calls_per_step"]
    hidden, width = config["hidden_size"], config["moe_intermediate_size"]
    dense = [s for n, s in names if ".expert" not in n and ".shared" not in n]
    assert dense == [(18432, 7168), (18432, 7168), (7168, 18432)] * 3
    assert sum(s == (width, hidden) for _, s in names) == 2 * 8 * 9
    assert sum(s == (hidden, width) for _, s in names) == 8 * 9
    blocks = sum(round(0.1 * (r // 128) * (c // 128)) for _, (r, c) in names)
    assert blocks == 26694
    assert config["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert config["published"] == {"num_hidden_layers": 61,
                                   "n_routed_experts": 256}
    assert set(config["assumed"]) >= {"block", "block_sparsity",
                                      "chunk_tokens", "expert_load",
                                      "values", "activations"}


def test_the_cell_loads_and_reports_what_its_metrics_move():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic["b_width"] == 4096
    assert cell.traffic["b_dtype"] == "bfloat16"
    assert cell.traffic["warmup_steps"] >= 10
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"gflops", "step_ms_p95", "peak_mem_gb", "setup_s"}
    layers = {m["name"] for m in cell.per_layer}
    assert layers >= {"spmm_roofline", "device.idle_frac",
                      "plans.term_planes_s", "api.launch_us_per_call"}
    for metric in cell.per_layer:
        assert metric["moves"] in e2e, metric["name"]
        assert callable(spec.reader(metric["name"]))


def test_a_pruned_moe_cell_runs_on_the_cpu(tmp_path):
    root = write_root(str(tmp_path))
    bench_dir = os.path.join(root, "spmm_bench")
    with open(os.path.join(bench_dir, "configs", "tiny_moe.json"), "w") as f:
        json.dump(moe_config(), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_moe", "source": "test",
                             "file": "spmm_bench/configs/tiny_moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_moe.w16", "config": "tiny_moe",
                               "traffic": "w16", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("tiny_moe.w16", root)
    result = harness.run_cell(cell, 2**33 + 1, 1.0, False, "cpu", Program(),
                              root, 0.0, str(tmp_path))
    assert result["correct"], result["checks"]
