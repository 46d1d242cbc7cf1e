"""tpuspmm_torch.entry against __graft_entry__ on the same inputs.

``entry()``: the port's panel plan (kt, st, offs, a_dense) equals JAX's
array for array, and its ``fn`` (on the CPU, the plain version in the
card kernel's trash-free layout) agrees with JAX's raw ``_panel_spmm``
in interpret mode after the slab drop, within TOL·max|C| (both sum f32
products in different orders, as ``test_torch_panel.py`` holds them);
both pass the gate against the f64 oracle.

``dryrun_multichip(4)``: four gloo ranks, one process each, on a 2 x 2
mesh; 16 of 16 schedule x local combos at the gate, and the training
step's loss equal to JAX's ``lsq_train_step`` on a 2 x 2 mesh of the
test's virtual devices within LOSS_TOL (a sum of f32 squares, reduced in
another order).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tpuspmm.formats import CSR as JCSR
from tpuspmm import parallel as jpar
from tpuspmm_torch import entry as tentry
from tpuspmm_torch.formats import CSR
from tpuspmm_torch.ops import oracle
from tpuspmm_torch.utils.compare import allclose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as jentry  # noqa: E402

TOL = 1e-5
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def both():
    jfn, jargs = jentry.entry()
    tfn, targs = tentry.entry(device="cpu")
    return jfn, jargs, tfn, targs


def test_entry_plan_arrays_equal_jax(both):
    _, jargs, tfn, targs = both
    for name, j, t in zip(("kt", "st", "offs", "a_dense"), jargs[:4],
                          targs[:4]):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(j, t, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jargs[4]), targs[4].numpy())
    plan = tfn.plan
    assert plan.row_perm is None  # natural order: fn has no epilogue
    assert (plan.shape, plan.n_supertiles) == ((1024, 1024), 1)


def test_entry_fn_matches_jax_after_the_slab_drop(both):
    jfn, jargs, tfn, targs = both
    plan = tfn.plan
    j_out = np.asarray(jfn(*jargs))
    n_st, sm, tm = plan.n_supertiles, plan.sm, plan.tm
    assert j_out.shape == (n_st * (sm + tm), 256)  # the slab layout
    j_out = j_out.reshape(n_st, sm + tm, -1)[:, :sm].reshape(n_st * sm, -1)
    launches = tentry.PanelLaunch.launches
    got = tfn(*targs)
    assert tentry.PanelLaunch.launches == launches  # the CPU: no launch
    assert got.shape == (n_st * sm, 256) and got.dtype == torch.float32
    scale = float(np.abs(j_out).max())
    assert float(np.abs(got.numpy() - j_out).max()) <= TOL * scale
    b = np.random.default_rng(1).standard_normal((1024, 256)).astype(
        np.float32)
    ref = oracle.spmm_oracle(CSR.random(1024, 1024, 0.10, seed=0), b)
    assert allclose(got, ref) and allclose(j_out, ref)


def test_entry_cli_needs_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tentry.main([]) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    assert tentry.main(["--device", "cpu"]) == 0
    assert "entry OK: (1024, 256) torch.float32" in capsys.readouterr().out


def test_mesh_shape_is_jaxs():
    assert [tentry.mesh_shape(n) for n in (1, 2, 4, 6, 8, 16)] == [
        (1, 1), (2, 1), (2, 2), (3, 2), (2, 4), (4, 4)]


def test_dryrun_multichip_four_gloo_ranks(capsys):
    rec = tentry.dryrun_multichip(4)
    assert rec["mesh"] == [2, 2]
    assert len(rec["combos"]) == 16 and all(rec["combos"].values()), rec
    assert ("dryrun_multichip(4): mesh 2x2 OK, 16/16 schedule x local "
            "combos green") in capsys.readouterr().out

    a = JCSR.random(192, 256, density=0.08, seed=3)
    mesh = jpar.make_mesh((2, 2), devices=jax.devices()[:4])
    state = jpar.make_train_state(a, n=64, mesh=mesh, seed=0)
    _, loss = jpar.lsq_train_step(state, mesh, lr=1e-8)
    assert rec["loss"] == pytest.approx(float(loss), rel=LOSS_TOL)
