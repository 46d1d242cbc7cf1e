"""tpuspmm_torch's pair kernel (K2) against tpuspmm's.

Same structure as test_torch_panel.py: equal plan arrays (bf16 plans bit
for bit), equal geometry choices under equal constants, and the port's
plain version against the JAX kernel in Pallas interpret mode on the same
plan, within |Δ| ≤ 1e-5·max|C_ref| (f32 sums in different orders), both
passing the gate against the f64 oracle.
"""

import numpy as np
import pytest
import torch

from tpuspmm.formats import COO as JCOO
from tpuspmm.kernels import pair_spmm as jq
from tpuspmm.ops import oracle as joracle
from tpuspmm_torch import interop
from tpuspmm_torch.formats import COO
from tpuspmm_torch.kernels import pair_spmm as tq
from tpuspmm_torch.kernels.dispatch import thresholds
from tpuspmm_torch.utils.compare import allclose
from test_torch_panel import as_u16, signature_perm, strip_walk, triplets


def to_port(plan):
    return interop.pair_plan_from_arrays(
        plan.kt, plan.st, plan.start, plan.count, plan.offs,
        as_u16(plan.a_dense), plan.shape, plan.tm, plan.tk,
        plan.chunk_strips, plan.sm, plan.row_perm)


GEOMETRIES = [
    # (tm, tk, CH, sm, reorder, lossless_bf16, empty_rows)
    (8, 128, 8, None, False, False, None),
    (16, 128, 32, None, True, False, None),
    (32, 256, 8, None, False, True, None),
    (8, 256, 32, 64, False, False, None),
    (16, 128, 8, 96, True, True, None),
    (32, 128, 32, 64, False, False, (64, 192)),
    (8, 128, 8, 40, False, True, (0, 120)),
]


@pytest.mark.parametrize("tm,tk,CH,sm,reorder,bf16,empty", GEOMETRIES)
def test_plan_arrays_match(tm, tk, CH, sm, reorder, bf16, empty):
    m, k = 250, 600
    r, c, v = triplets(m, k, 0.03, seed=tm + tk + CH, lossless_bf16=bf16,
                       empty_rows=empty)
    perm = signature_perm(r, c, m, tk) if reorder else None
    kw = dict(tm=tm, tk=tk, chunk_strips=CH, sm=sm, row_perm=perm)
    ref = jq.build_pair_plan(r, c, v, (m, k), **kw)
    got = tq.build_pair_plan(r, c, v, (m, k), **kw)
    for f in ("kt", "st", "start", "count", "offs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.a_dense.dtype == (np.uint16 if bf16 else np.float32)
    np.testing.assert_array_equal(got.a_dense, as_u16(ref.a_dense))
    for x, y in zip(got.chunk_arrays(), ref.chunk_arrays()):
        np.testing.assert_array_equal(x, y)
    if empty is not None and sm is not None:
        assert (got.count == 0).any()  # an empty supertile's filler pair


@pytest.mark.parametrize("bf16", [False, True])
def test_pair_search_matches(bf16):
    m, k, n_pad = 400, 900, 256
    r, c, v = triplets(m, k, 0.02, seed=9, lossless_bf16=bf16)
    th = dict(thresholds("cpu"), panel_step_us=0.0965,
              panel_strip_us=0.00247)
    jcoo = JCOO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
                shape=(m, k))
    tcoo = COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
               shape=(m, k))
    for tm, tk in [(8, 128), (16, 256)]:
        jin = jq._pair_model_inputs(jcoo, jcoo, r, c, m, k, n_pad, tm, tk,
                                    True, th)
        tin = tq._pair_model_inputs(tcoo, tcoo, r, c, m, k, n_pad, tm, tk,
                                    True, th)
        for ch in (None, 16):
            ref, _ = jq._pair_search(*jin, None, 4 * 1024 * 1024, ch)
            got = tq._pair_search(*tin, 4 * 1024 * 1024, ch)
            # JAX: (cost, perm, plan_bytes, sm, ch, tile_n, order_kind)
            assert got[2:] == ref[2:5] + ref[6:]
            assert got[0] == pytest.approx(ref[0], rel=1e-12)
            assert (got[1] is None) == (ref[1] is None)
            if ref[1] is not None:
                np.testing.assert_array_equal(got[1], ref[1])


def test_resolver_matches(monkeypatch):
    from tpuspmm.kernels import dispatch as jdispatch

    th = thresholds("cpu")
    monkeypatch.setattr(jdispatch, "thresholds", lambda: dict(th))
    m, k = 500, 1200
    r, c, v = triplets(m, k, 0.01, seed=13)
    jcoo = JCOO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
                shape=(m, k))
    tcoo = COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
               shape=(m, k))
    for ch in (None, 8):
        ref = jq.resolve_pair_geometry(jcoo, 256, chunk_strips=ch,
                                       plan_bytes_cap=tq.PLAN_BYTES_CAP)
        got = tq.resolve_pair_geometry(tcoo, 256, chunk_strips=ch,
                                       plan_bytes_cap=tq.PLAN_BYTES_CAP)
        assert (got.sm, got.chunk_strips, got.plan_bytes, got.order_kind) == (
            ref.sm, ref.chunk_strips, ref.plan_bytes, ref.order_kind)
        assert ref.tile_n == 256
        assert got.cost_us == pytest.approx(ref.cost_us, rel=1e-12)


OUTPUT_CASES = [
    # (tm, tk, CH, sm, reorder, lossless_bf16, b dtype)
    (8, 128, 8, None, True, False, torch.float32),
    (16, 256, 32, 64, False, True, torch.float32),
    (32, 128, 8, None, False, False, torch.bfloat16),
    (8, 128, 32, 48, True, True, torch.bfloat16),
]


@pytest.mark.parametrize("tm,tk,CH,sm,reorder,bf16,b_dtype", OUTPUT_CASES)
def test_plain_matches_jax_interpret(tm, tk, CH, sm, reorder, bf16, b_dtype):
    m, k, n = 300, 700, 200
    r, c, v = triplets(m, k, 0.02, seed=tm * CH, lossless_bf16=bf16)
    perm = signature_perm(r, c, m, tk) if reorder else None
    jplan = jq.build_pair_plan(r, c, v, (m, k), tm=tm, tk=tk,
                               chunk_strips=CH, sm=sm, row_perm=perm)
    b = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, (k, n)).astype(np.float32)).to(b_dtype)
    b_np = b.float().numpy()
    import jax.numpy as jnp

    jb = jnp.asarray(b_np).astype(
        jnp.bfloat16 if b_dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jq.spmm_pair(jplan, jb, interpret=True))
    got = tq.spmm_pair(to_port(jplan), b)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * float(np.abs(ref).max())
    exact = joracle.spmm_scipy_oracle(
        JCOO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
             shape=(m, k)), b_np)
    assert allclose(got, exact) and allclose(ref, exact)


@pytest.mark.parametrize("sm,reorder", [(None, False), (40, True)])
def test_strip_index_walk_reproduces_plain(sm, reorder):
    """The index leaves out the zero tail and every strip a chunk reads
    past its pair; walking it reproduces the plain version."""
    m, k, n = 200, 500, 64
    r, c, v = triplets(m, k, 0.03, seed=6, empty_rows=(40, 80))
    perm = signature_perm(r, c, m, 128) if reorder else None
    plan = tq.build_pair_plan(r, c, v, (m, k), tm=8, tk=128,
                              chunk_strips=8, sm=sm, row_perm=perm)
    strip_ptr, src_slot, _ = plan.strip_index()
    assert strip_ptr[-1] == plan.n_strips == len(src_slot)
    assert src_slot.max() < plan.n_strips
    b = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (k, n)).astype(np.float32))
    walk = strip_walk(plan, b).float()
    got = tq.finish_panel_output(walk, plan, plan.device_arrays("cpu"), n)
    plain = tq.pair_spmm_plain(plan, b)
    assert torch.allclose(got, plain, rtol=0, atol=1e-5)


def test_non_cpu_tensor_never_takes_the_plain_version():
    m, k = 100, 300
    r, c, v = triplets(m, k, 0.05, seed=14)
    plan = tq.build_pair_plan(r, c, v, (m, k), tm=8, chunk_strips=8)
    meta = torch.empty(k, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tq.spmm_pair(plan, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tq.spmm_pair(plan, meta, mode="split2")
    with pytest.raises(ValueError, match="K=300"):
        tq.spmm_pair(plan, torch.zeros(k - 1, 64))
    assert tq.spmm_pair.launches == 0


def test_container_entry_matches_oracle():
    m, k, n = 333, 777, 130
    r, c, v = triplets(m, k, 0.015, seed=22)
    a = COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
            shape=(m, k))
    b = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (k, n)).astype(np.float32))
    from tpuspmm_torch.ops import oracle

    out = tq.spmm_pair(a, b)
    assert allclose(out, oracle.spmm_oracle(a, b.numpy()))
    assert tq.spmm_pair.launches == 0  # CPU tensors never launch
