"""tpuspmm_torch's panel kernel (K1) against tpuspmm's.

The same seeded triplets go through both packages: plan arrays must be
equal (a bf16 plan bit for bit, compared as uint16), the geometry search
must pick the same geometry under the same constants, and the port's plain
version must agree with the JAX kernel in Pallas interpret mode on the same
plan, carried across by ``tpuspmm_torch.interop``.  Output tolerance:
|Δ| ≤ 1e-5·max|C_ref|, since both sides sum f32 products in different
orders; both also pass the rel 1e-2 / abs 1e-3 gate against the f64
oracle.
"""

import os

import numpy as np
import pytest
import scipy.sparse
import torch

from tpuspmm.formats import COO as JCOO
from tpuspmm.kernels import panel_spmm as jp
from tpuspmm.ops import oracle as joracle
from tpuspmm_torch import interop
from tpuspmm_torch.formats import COO
from tpuspmm_torch.kernels import panel_spmm as tp
from tpuspmm_torch.kernels.dispatch import thresholds
from tpuspmm_torch.utils.compare import allclose


def triplets(m, k, density, seed, lossless_bf16=False, empty_rows=None):
    """Seeded (rows, cols, vals); ``lossless_bf16`` draws small integers
    (every value round-trips bf16); ``empty_rows`` = (lo, hi) is a row
    band left empty (an empty supertile)."""
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="coo",
                             random_state=rng)
    r, c = sp.row.astype(np.int64), sp.col.astype(np.int64)
    if empty_rows is not None:
        keep = (r < empty_rows[0]) | (r >= empty_rows[1])
        r, c = r[keep], c[keep]
    if lossless_bf16:
        v = rng.integers(-8, 9, len(r)).astype(np.float32)
    else:
        v = rng.uniform(-1, 1, len(r)).astype(np.float32)
    return r, c, v


def as_u16(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def to_port(plan):
    return interop.panel_plan_from_arrays(
        plan.kt, plan.st, plan.offs, as_u16(plan.a_dense), plan.shape,
        plan.tm, plan.tk, plan.panel_strips, plan.sm, plan.row_perm)


def signature_perm(r, c, m, tk):
    return tp._order_perm(r, c, m, c // tk, "signature")


GEOMETRIES = [
    # (tm, tk, P, sm, reorder, lossless_bf16, empty_rows)
    (8, 128, 4, None, False, False, None),
    (16, 128, 16, None, True, False, None),
    (32, 256, 4, None, False, True, None),
    (8, 256, 16, 64, False, False, None),
    (16, 128, 4, 96, True, True, None),
    (32, 128, 16, 64, False, False, (64, 192)),
    (8, 256, 4, 32, False, True, (0, 120)),
]


@pytest.mark.parametrize("tm,tk,P,sm,reorder,bf16,empty", GEOMETRIES)
def test_plan_arrays_match(tm, tk, P, sm, reorder, bf16, empty):
    m, k = 250, 600
    r, c, v = triplets(m, k, 0.03, seed=tm + tk + P, lossless_bf16=bf16,
                       empty_rows=empty)
    perm = signature_perm(r, c, m, tk) if reorder else None
    kw = dict(tm=tm, tk=tk, panel_strips=P, sm=sm, row_perm=perm)
    ref = jp.build_panel_plan(r, c, v, (m, k), **kw)
    got = tp.build_panel_plan(r, c, v, (m, k), **kw)
    for f in ("kt", "st", "offs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.a_dense.dtype == (np.uint16 if bf16 else np.float32)
    np.testing.assert_array_equal(got.a_dense, as_u16(ref.a_dense))
    assert (got.sm, got.tm, got.tk, got.panel_strips) == (
        ref.sm, ref.tm, ref.tk, ref.panel_strips)
    if empty is not None and sm is not None:
        assert got.n_supertiles > 1


def test_empty_matrix_plan_matches():
    e = np.zeros(0, np.int64)
    ref = jp.build_panel_plan(e, e, np.zeros(0, np.float32), (40, 300),
                              tm=8, panel_strips=4, sm=16)
    got = tp.build_panel_plan(e, e, np.zeros(0, np.float32), (40, 300),
                              tm=8, panel_strips=4, sm=16)
    for f in ("kt", "st", "offs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    np.testing.assert_array_equal(got.a_dense, as_u16(ref.a_dense))


@pytest.mark.parametrize("bf16", [False, True])
def test_geometry_search_matches(bf16):
    m, k = 400, 900
    r, c, v = triplets(m, k, 0.02, seed=7, lossless_bf16=bf16)
    th = thresholds("cpu")
    kw = dict(step_us=0.0965, strip_us=0.00247, hbm_gbps=th["panel_hbm_gbps"],
              perm_us=0.5, plan_bytes_cap=2 * 1024 * 1024,
              val_bytes=2 if bf16 else 4)
    for tm, tk in [(jp.TM_CANDIDATES, jp.TK_CANDIDATES), (8, 128)]:
        ref = jp._geometry_search(r, c, m, k, tm, tk, jp.STRIP_CANDIDATES,
                                  **kw)
        got = tp._geometry_search(r, c, m, k, tm, tk, tp.STRIP_CANDIDATES,
                                  **kw)
        assert got[0] == ref[0] and got[2:7] == ref[2:7]
        assert got[7] == pytest.approx(ref[7], rel=1e-12)
        if ref[1] is None:
            assert got[1] is None
        else:
            np.testing.assert_array_equal(got[1], ref[1])
    assert tp.choose_panel_geometry(r, c, m, k)[0] == jp.choose_panel_geometry(
        r, c, m, k, step_us=0.0, strip_us=0.0,
        hbm_gbps=th["panel_hbm_gbps"])[0]


def test_resolver_matches(monkeypatch):
    """Both resolvers under the port's "cpu" constants (patched into the
    JAX dispatcher's thresholds)."""
    from tpuspmm.kernels import dispatch as jdispatch

    th = thresholds("cpu")
    monkeypatch.setattr(jdispatch, "thresholds", lambda: dict(th))
    m, k = 500, 1200
    r, c, v = triplets(m, k, 0.01, seed=11)
    jcoo = JCOO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
                shape=(m, k))
    tcoo = COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
               shape=(m, k))
    for P in (None, 16):
        ref = jp.resolve_panel_geometry(jcoo, 256, panel_strips=P,
                                        plan_bytes_cap=tp.PLAN_BYTES_CAP)
        got = tp.resolve_panel_geometry(tcoo, 256, panel_strips=P,
                                        plan_bytes_cap=tp.PLAN_BYTES_CAP)
        assert (got.panel_strips, got.sm, got.plan_bytes, got.tm,
                got.order_kind, got.tk) == (
            ref.panel_strips, ref.sm, ref.plan_bytes, ref.tm,
            ref.order_kind, ref.tk)
        assert got.cost_us == pytest.approx(ref.cost_us, rel=1e-12)


OUTPUT_CASES = [
    # (tm, tk, P, sm, reorder, lossless_bf16, b dtype)
    (8, 128, 16, None, True, False, torch.float32),
    (16, 256, 4, 64, False, True, torch.float32),
    (32, 128, 4, None, False, False, torch.bfloat16),
    (8, 128, 4, 48, True, True, torch.bfloat16),
]


@pytest.mark.parametrize("tm,tk,P,sm,reorder,bf16,b_dtype", OUTPUT_CASES)
def test_plain_matches_jax_interpret(tm, tk, P, sm, reorder, bf16, b_dtype):
    m, k, n = 300, 700, 200
    r, c, v = triplets(m, k, 0.02, seed=tm * P, lossless_bf16=bf16)
    perm = signature_perm(r, c, m, tk) if reorder else None
    jplan = jp.build_panel_plan(r, c, v, (m, k), tm=tm, tk=tk,
                                panel_strips=P, sm=sm, row_perm=perm)
    b = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (k, n)).astype(np.float32)).to(b_dtype)
    b_np = b.float().numpy()
    import jax.numpy as jnp

    jb = jnp.asarray(b_np).astype(
        jnp.bfloat16 if b_dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jp.spmm_panel(jplan, jb, interpret=True))
    got = tp.spmm_panel(to_port(jplan), b)
    assert got.shape == (m, n) and got.dtype == torch.float32
    scale = float(np.abs(ref).max())
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
    exact = joracle.spmm_scipy_oracle(
        JCOO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
             shape=(m, k)), b_np)
    assert allclose(got, exact) and allclose(ref, exact)


def strip_walk(plan, b):
    """Pure-torch walk of the strip-owner index: what the CUDA kernel
    computes, one output strip at a time, in f64."""
    strip_ptr, src_slot, src_kt = plan.strip_index()
    tm, tk = plan.tm, plan.tk
    a = tp.plan_tensor(plan.a_dense).double()
    bp = torch.zeros(plan.num_k_tiles * tk, b.shape[1], dtype=torch.float64)
    bp[:b.shape[0]] = b.double()
    out = torch.zeros(plan.n_out_strips * tm, b.shape[1],
                      dtype=torch.float64)
    for g in range(plan.n_out_strips):
        for e in range(strip_ptr[g], strip_ptr[g + 1]):
            s, kt = int(src_slot[e]), int(src_kt[e])
            out[g * tm:(g + 1) * tm] += (a[s * tm:(s + 1) * tm]
                                         @ bp[kt * tk:(kt + 1) * tk])
    return out


@pytest.mark.parametrize("sm,reorder", [(None, False), (40, True)])
def test_strip_index_walk_reproduces_plain(sm, reorder):
    m, k, n = 200, 500, 64
    r, c, v = triplets(m, k, 0.03, seed=5, empty_rows=(40, 80))
    perm = signature_perm(r, c, m, 128) if reorder else None
    plan = tp.build_panel_plan(r, c, v, (m, k), tm=8, tk=128,
                               panel_strips=16, sm=sm, row_perm=perm)
    assert (plan.offs == plan.sm).any()  # padding slots are left out
    strip_ptr, src_slot, _ = plan.strip_index()
    assert strip_ptr[-1] == (plan.offs != plan.sm).sum() == len(src_slot)
    b = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (k, n)).astype(np.float32))
    walk = strip_walk(plan, b).float()
    got = tp.finish_panel_output(walk, plan, plan.device_arrays("cpu"), n)
    plain = tp.panel_spmm_plain(plan, b)
    assert torch.allclose(got, plain, rtol=0, atol=1e-5)


def group_walk(plan, b, G):
    """Pure-torch walk of the group index: what each block of the CUDA
    kernel computes, G output strips and one B tile per (group, k-tile)
    entry, in f64."""
    group_ptr, group_kt, group_slot = plan.group_index(G)
    tm, tk = plan.tm, plan.tk
    a = tp.plan_tensor(plan.a_dense).double()
    bp = torch.zeros(plan.num_k_tiles * tk, b.shape[1], dtype=torch.float64)
    bp[:b.shape[0]] = b.double()
    n_groups = len(group_ptr) - 1
    out = torch.zeros(n_groups * G * tm, b.shape[1], dtype=torch.float64)
    for g in range(n_groups):
        for e in range(group_ptr[g], group_ptr[g + 1]):
            tile = bp[int(group_kt[e]) * tk:(int(group_kt[e]) + 1) * tk]
            for j, s in enumerate(group_slot[e]):
                if s >= 0:
                    row = (g * G + j) * tm
                    out[row:row + tm] += a[s * tm:(s + 1) * tm] @ tile
    return out[:plan.n_out_strips * tm]


def check_group_index(plan, G):
    """Each group's entries are in ascending k-tile and hold exactly the
    strip index's (output strip, k-tile, slot) triples of its strips."""
    strip_ptr, src_slot, src_kt = plan.strip_index()
    group_ptr, group_kt, group_slot = plan.group_index(G)
    assert len(group_ptr) == -(-plan.n_out_strips // G) + 1
    assert group_slot.shape == (len(group_kt), G)
    want = {(g, int(kt), int(s)) for g in range(plan.n_out_strips)
            for s, kt in zip(src_slot[strip_ptr[g]:strip_ptr[g + 1]],
                             src_kt[strip_ptr[g]:strip_ptr[g + 1]])}
    got = set()
    for grp in range(len(group_ptr) - 1):
        kts = group_kt[group_ptr[grp]:group_ptr[grp + 1]]
        assert (np.diff(kts) > 0).all()
        for e in range(group_ptr[grp], group_ptr[grp + 1]):
            assert (group_slot[e] >= 0).any()  # no empty entry
            got |= {(grp * G + j, int(group_kt[e]), int(s))
                    for j, s in enumerate(group_slot[e]) if s >= 0}
    assert got == want


GROUP_CASES = [
    # (tm, tk, sm, reorder, empty_rows, nnz): 64-row groups
    (8, 128, None, False, None, True),
    (16, 256, None, True, None, True),
    (32, 128, None, False, (40, 80), True),
    (8, 256, 40, True, (40, 80), True),
    (16, 128, 48, False, (0, 64), True),
    (32, 256, 64, True, None, True),
    (8, 128, 40, False, None, False),
]


@pytest.mark.parametrize("tm,tk,sm,reorder,empty,nnz", GROUP_CASES)
def test_group_index_walk_reproduces_plain(tm, tk, sm, reorder, empty, nnz):
    m, k, n = 200, 500, 48
    r, c, v = triplets(m, k, 0.03 if nnz else 0.0, seed=tm + tk,
                       empty_rows=empty)
    perm = signature_perm(r, c, m, tk) if reorder and nnz else None
    plan = tp.build_panel_plan(r, c, v, (m, k), tm=tm, tk=tk,
                               panel_strips=4, sm=sm, row_perm=perm)
    G = tp.GROUP_ROWS // tm
    check_group_index(plan, G)
    b = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (k, n)).astype(np.float32))
    walk = group_walk(plan, b, G).float()
    got = tp.finish_panel_output(walk, plan, plan.device_arrays("cpu"), n)
    plain = tp.panel_spmm_plain(plan, b)
    assert torch.allclose(got, plain, rtol=0, atol=1e-5)
    if not nnz:
        assert not got.any() and plan.group_index(G)[0][-1] == 0


def test_group_index_counts_on_large_25605():
    """The figure behind the strip kernel's B traffic: at the dispatcher's
    geometry under the fitted H100 constants (tm 16, tk 128, P 8) 3,797
    real strips make 1,412 (group, k-tile) entries in 64-row groups, each
    one B tile load a column tile: as many as tm 8's 6,893 strips made."""
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert

    a = convert.load_sparse(data_dir("large_25605"), "csr")
    geom = tp.resolve_panel_geometry(a, 256,
                                     plan_bytes_cap=tp.PLAN_BYTES_CAP)
    plan = tp.panel_plan_from_geometry(a, geom)
    assert (plan.tm, plan.tk, plan.panel_strips) == (16, 128, 8)
    assert len(plan.offs.reshape(-1)) == 4584
    assert len(plan.strip_index()[1]) == 3797
    group_ptr, group_kt, _ = plan.group_index(tp.GROUP_ROWS // plan.tm)
    assert len(group_ptr) - 1 == 99 and group_ptr[-1] == len(group_kt) == 1412
    check_group_index(plan, tp.GROUP_ROWS // plan.tm)


def test_group_rows_is_the_kernels_constant():
    """The group index's rows (strip_cuda.GROUP_ROWS, which the wrapper
    checks) are the rows the kernel is compiled for."""
    import re

    from tpuspmm_torch.kernels import strip_cuda

    with open(strip_cuda.SOURCE) as f:
        rows = re.findall(r"^constexpr int GROUP_ROWS = (\d+);", f.read(),
                          re.M)
    assert rows == [str(strip_cuda.GROUP_ROWS)]
    assert tp.GROUP_ROWS == strip_cuda.GROUP_ROWS


def test_library_path_covers_included_headers(tmp_path):
    """An edited csrc header rebuilds every library that includes it; a
    file the source does not include changes nothing."""
    import shutil

    from tpuspmm_torch.kernels import cuda_build, strip_cuda

    for name in ("strip_spmm.cu", "tensor_core.cuh"):
        shutil.copy(os.path.join(cuda_build.CSRC, name), tmp_path / name)
    (tmp_path / "other.cuh").write_text("// not included\n")
    lib = cuda_build.CudaLibrary(str(tmp_path / "strip_spmm.cu"), None)
    assert sorted(map(os.path.basename, lib.sources())) == [
        "strip_spmm.cu", "tensor_core.cuh"]
    before = lib.library_path()
    assert os.path.basename(before) == os.path.basename(
        strip_cuda.library_path())
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert lib.library_path() == before
    with open(tmp_path / "tensor_core.cuh", "a") as f:
        f.write("// edited\n")
    assert lib.library_path() != before


def test_container_entry_matches_oracle():
    m, k, n = 333, 777, 130
    r, c, v = triplets(m, k, 0.015, seed=21)
    a = COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
            shape=(m, k))
    b = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (k, n)).astype(np.float32))
    from tpuspmm_torch.ops import oracle

    out = tp.spmm_panel(a, b)
    assert allclose(out, oracle.spmm_oracle(a, b.numpy()))
    assert tp.spmm_panel.launches == 0  # CPU tensors never launch


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor runs the plain version: any other device goes to
    the CUDA launcher, which refuses what it cannot launch."""
    m, k = 100, 300
    r, c, v = triplets(m, k, 0.05, seed=12)
    plan = tp.build_panel_plan(r, c, v, (m, k), tm=8, panel_strips=4)
    meta = torch.empty(k, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tp.spmm_panel(plan, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tp.spmm_panel(plan, meta, mode="split2")
    with pytest.raises(ValueError, match="K=300"):
        tp.spmm_panel(plan, torch.zeros(k + 1, 64))
    assert tp.spmm_panel.launches == 0


def test_split2_plain_tier_matches_jax():
    m, k, n = 120, 300, 64
    r, c, v = triplets(m, k, 0.05, seed=4)
    jplan = jp.build_panel_plan(r, c, v, (m, k), tm=8, panel_strips=4)
    b = np.random.default_rng(6).uniform(-1, 1, (k, n)).astype(np.float32)
    ref = np.asarray(jp.spmm_panel(jplan, b, interpret=True, mode="split2"))
    got = tp.spmm_panel(to_port(jplan), torch.from_numpy(b), mode="split2")
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    with pytest.raises(ValueError):
        tp.normalize_panel_mode("split")
