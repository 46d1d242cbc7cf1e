"""Fixtures of the benchmark's own tests: a checkout root in a temporary
directory holding tiny cells (``tiny_root``), and the ``card`` marker for
tests that need a CUDA card (they skip inside the ``cuda_card`` fixture
without one)."""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.io
import scipy.sparse

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


TINY_CELLS = {
    "tiny_mtx.w32": ("tiny_mtx", "w32"),
    "tiny_ffn.w16": ("tiny_ffn", "w16"),
}


def copy_code(root: str) -> None:
    """The benchmark's operand generators and metric readers, under
    ``root`` as in a checkout."""
    for sub in ("generators", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub),
                        os.path.join(root, "spmm_bench", sub),
                        dirs_exist_ok=True)


def write_root(root: str) -> str:
    """A checkout root with BENCHMARK.json, two tiny configurations (a
    Matrix Market CSR and pruned FFN weights), two mixes and the real
    operand generators and metric readers."""
    bench = os.path.join(root, "spmm_bench")
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    copy_code(root)
    rng = np.random.default_rng(5)
    m = scipy.sparse.random(48, 80, density=0.1, format="coo",
                            random_state=rng,
                            data_rvs=lambda k: rng.integers(-3, 4, k))
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    scipy.io.mmwrite(os.path.join(root, "data", "tiny.mtx"), m)
    configs = {
        "tiny_mtx": {"operands": {"kind": "matrix_market",
                                  "path": "data/tiny.mtx"},
                     "b_values": {"dist": "uniform", "low": -1.0,
                                  "high": 1.0},
                     "max_rel_err": 1e-5},
        "tiny_ffn": {"hidden_size": 256, "intermediate_size": 384,
                     "num_hidden_layers": 2,
                     "operands": {"kind": "pruned_ffn", "block": [128, 128],
                                  "block_sparsity": 0.5},
                     "b_values": {"dist": "normal", "std": 0.05},
                     "max_rel_err": 1e-5},
    }
    mixes = {
        "w32": {"b_width": 32, "b_dtype": "float32", "pool": 3,
                "calls_per_step": 2, "warmup_steps": 2},
        "w16": {"b_width": 16, "b_dtype": "bfloat16", "pool": 2,
                "calls_per_step": 6, "warmup_steps": 2},
    }
    for name, conf in configs.items():
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump(conf, f)
    for name, mix in mixes.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    real["configs"] = [{"name": n, "source": "test", "reduced": [],
                        "file": f"spmm_bench/configs/{n}.json", "why": "test"}
                       for n in configs]
    real["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1,
                          "why": "test"}
                         for w, (c, t) in TINY_CELLS.items()]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(real, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(str(tmp_path))
