"""``correct`` on a whole run: true for the program, false for the control
(one precision step below the serve's) in its place and for each fault
planted under the timed path.

The runs skip the harness's look for a card (``run_cell`` on the CPU, at
the tiny cells of ``conftest.write_root``); the program serves its plain
versions there.  The card test runs the real cells' control and program
through the same path.
"""

import pytest
import torch

from spmm_bench import harness, spec
from spmm_bench.system import Control, Program

CELLS = ("tiny_mtx.w32", "tiny_ffn.w16")
SEEDS = (4, 2**31 + 99, 2**45 + 1)


class Stale(Program):
    """A call answers with the output of the call before it: a serve that
    returns its state unchanged."""

    def spmm(self, handle, b):
        out = super().spmm(handle, b)
        prev, self.prev = getattr(self, "prev", None), out
        return out if prev is None else prev


class Memo(Program):
    """A repeat of an operand and a B storage answered with the output it
    gave before: a serve that keeps its state unchanged across calls."""

    def spmm(self, handle, b):
        memo = self.__dict__.setdefault("memo", {})
        key = (id(handle), b.data_ptr())
        if key not in memo:
            memo[key] = super().spmm(handle, b)
        return memo[key]


class Half(Program):
    """Half of the batch left out: B's second half of columns unserved."""

    def spmm(self, handle, b):
        out = super().spmm(handle, b).clone()
        out[:, b.shape[1] // 2:] = 0
        return out


class Altered(Program):
    """One answer altered where it is produced: one entry of C."""

    def spmm(self, handle, b):
        out = super().spmm(handle, b).clone()
        out[0, 0] += 1e-3 * out.abs().max()
        return out


class Raises(Program):
    def spmm(self, handle, b):
        if getattr(self, "warm", 0) >= 20:
            raise RuntimeError("planted launch failure")
        self.warm = getattr(self, "warm", 0) + 1
        return super().spmm(handle, b)


def run(root, tmp_path, name, seed, system, traced=False):
    cell = spec.load_cell(name, root)
    return harness.run_cell(cell, seed, 0.2, traced, "cpu", system, root,
                            0.0, str(tmp_path))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_is_correct(tiny_root, tmp_path, name, seed):
    r = run(tiny_root, tmp_path, name, seed, Program())
    assert r["correct"], r["checks"]
    assert r["checks"]["answers"]["value"] >= r["checks"]["answers"]["limit"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(tiny_root, tmp_path, name, seed):
    r = run(tiny_root, tmp_path, name, seed, Control())
    assert not r["correct"]
    assert r["checks"]["max_rel_err"]["value"] > \
        3 * r["checks"]["max_rel_err"]["limit"]


@pytest.mark.parametrize("fault", [Stale, Memo, Half, Altered, Raises])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, tmp_path, name, fault):
    r = run(tiny_root, tmp_path, name, SEEDS[1], fault())
    assert not r["correct"], (fault.__name__, r["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_judges_the_same(tiny_root, tmp_path, name):
    assert run(tiny_root, tmp_path, name, 8, Program(), traced=True)[
        "correct"]
    assert not run(tiny_root, tmp_path, name, 8, Altered(),
                   traced=True)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cells_on_the_card(cuda_card, tmp_path, name):
    """Each real cell, 2 s on the card: the program correct, the control
    not (``python -m pytest spmm_bench/tests -m card`` on the card)."""
    cell = spec.load_cell(name)
    for system, want in ((Program(), True), (Control(), False)):
        r = harness.run_cell(cell, 2**31 + 7, 2.0, False, cuda_card, system,
                             spec.ROOT, 0.0, str(tmp_path))
        assert r["correct"] is want, (system.name, r["checks"])
        torch.cuda.empty_cache()


@pytest.mark.parametrize("seed", SEEDS)
def test_compared_calls_keep_the_same_sizes_on_every_seed(seed):
    """Three steps drawn in the bands of the window, and about
    ``COMPARED_CALLS`` calls of each drawn in proportion to each output
    shape: the kept outputs take the same memory whatever the seed."""
    shapes = [(11008, 512)] * 64 + [(3840, 512)] * 32
    drawn = harness._drawn(seed, 1000, lambda s: shapes)
    steps = sorted(drawn)
    assert len(steps) == 3 and steps[0] < 100 and steps[-1] < 800
    for picks in drawn.values():
        assert len(set(picks)) == len(picks) == harness.COMPARED_CALLS
        assert sum(shapes[i] == (3840, 512) for i in picks) == 5
    assert harness._drawn(seed, 1000, lambda s: shapes) == drawn
    assert list(harness._drawn(seed, 1, lambda s: shapes[:8])) == [0]
