"""The run's guard against JAX and the JAX package, and the yardstick's
independence from the program."""

import os
import subprocess
import sys

from spmm_bench.run import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_are_compared_whole():
    loaded = ["tpuspmm_torch", "tpuspmm_torch.kernels.dispatch", "torch",
              "jaxtyping", "benchmark_x", "numpy"]
    assert forbidden_modules(loaded) == []
    assert forbidden_modules(loaded + ["tpuspmm.formats", "jax.numpy",
                                       "jaxlib", "bench.tpu_session"]) == [
        "bench.tpu_session", "jax.numpy", "jaxlib", "tpuspmm.formats"]


def test_yardstick_imports_nothing_of_the_program():
    """The reference, counts, operands, traffic, trace and the readers load
    in a fresh process without the program, JAX or the JAX package."""
    code = (
        "import sys\n"
        "from spmm_bench import counts, operands, reference, spec, trace, "
        "traffic\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tpuspmm_torch', 'tpuspmm', 'jax', 'jaxlib', 'flax', 'bench'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_a_cell_run_loads_no_jax(tiny_root, tmp_path):
    """A whole run of a tiny cell on the CPU, in a fresh process: the
    program loads, JAX and the JAX package do not."""
    code = (
        "import sys\n"
        "from spmm_bench import harness, spec, run\n"
        "from spmm_bench.system import Program\n"
        f"cell = spec.load_cell('tiny_ffn.w16', {tiny_root!r})\n"
        "r = harness.run_cell(cell, 1, 0.2, False, 'cpu', Program(), "
        f"{tiny_root!r}, 0.0, {str(tmp_path)!r})\n"
        "assert r['correct'], r\n"
        "assert 'tpuspmm_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n"
        "sys.exit(1 if run.forbidden_modules() else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
