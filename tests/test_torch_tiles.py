"""tpuspmm_torch's tile plan and tile-plan kernels (K3 tile, K4 staged, K5a
and K5b C-resident) against tpuspmm's.

The same seeded triplets go through both packages.  Plan arrays and the
kernels' layouts (``chunk_ranges``, ``_slab_arrays``, ``_kmajor_blocks``,
``_kmajor_loop``) must be equal.  Outputs: the port's plain versions
against the JAX kernels in Pallas interpret mode, on the same plan, for
f32 and bf16 B in every tier each kernel takes, within TOL·max|C| with
TOL = 2^-20.  That is below the 2-term tier's own error (~2^-17·max|C|),
so a port that computed plain f32 products at "split2" would fail; the
test shows it does.
"""

import numpy as np
import pytest
import scipy.sparse
import torch
import jax.numpy as jnp

from tpuspmm.formats import CSR as JCSR
from tpuspmm.formats import tiles as jtiles
from tpuspmm.kernels import cres_spmm as jk5
from tpuspmm.kernels import csr_vmem as jk4
from tpuspmm.kernels import tile_spmm as jk3
from tpuspmm_torch import interop
from tpuspmm_torch.formats import tiles
from tpuspmm_torch.kernels import cres_spmm, csr_vmem, tile_spmm

TOL = 2.0 ** -20


def triplets(m, k, density, seed, empty_rows=None, duplicates=0):
    """Seeded (rows, cols, vals); ``empty_rows`` = (lo, hi) is a row band
    left empty; ``duplicates`` repeats that many coordinates."""
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="coo",
                             random_state=rng)
    r, c = sp.row.astype(np.int64), sp.col.astype(np.int64)
    if empty_rows is not None:
        keep = (r < empty_rows[0]) | (r >= empty_rows[1])
        r, c = r[keep], c[keep]
    if duplicates:
        r = np.concatenate([r, r[:duplicates]])
        c = np.concatenate([c, c[:duplicates]])
    v = rng.uniform(-1, 1, len(r)).astype(np.float32)
    return r, c, v


# (m, k): neither a multiple of 128; an empty row tile; COO duplicates;
# a matrix with no nonzero
CASES = {
    "ragged_empty_tile": dict(m=300, k=700, density=0.03, seed=1,
                              empty_rows=(128, 256)),
    "duplicates": dict(m=260, k=390, density=0.04, seed=2, duplicates=60),
    "one_tile": dict(m=100, k=90, density=0.2, seed=3),
}


def plans(case):
    if case == "empty":
        r = c = np.zeros(0, np.int64)
        v = np.zeros(0, np.float32)
        shape = (200, 300)
    else:
        kw = CASES[case]
        r, c, v = triplets(**kw)
        shape = (kw["m"], kw["k"])
    return (jtiles.build_tile_plan(r, c, v, shape),
            tiles.build_tile_plan(r, c, v, shape))


FIELDS = ("rt", "kt", "first", "rows", "cols", "vals")


@pytest.mark.parametrize("case", [*CASES, "empty"])
def test_plan_arrays_equal(case):
    jp, tp = plans(case)
    for f in FIELDS:
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
        assert getattr(jp, f).dtype == getattr(tp, f).dtype, f
    assert (jp.shape, jp.num_chunks, jp.padded_shape) == \
        (tp.shape, tp.num_chunks, tp.padded_shape)
    for x, y in zip(jp.chunk_ranges(), tp.chunk_ranges()):
        assert np.array_equal(x, y)
    # every row tile has a chunk; padding chunks are all sentinel
    start, end = tp.chunk_ranges()
    assert np.all(end > start)


@pytest.mark.parametrize("case", [*CASES, "empty"])
def test_kernel_layouts_equal(case):
    jp, tp = plans(case)
    for num_slabs, kps in ((1, tp.num_k_tiles), (2, 2), (3, 1)):
        if num_slabs * kps < tp.num_k_tiles:
            continue
        jarr = jk4._slab_arrays(jp, num_slabs, kps)
        tarr = csr_vmem._slab_arrays(tp, num_slabs, kps)
        for key, x in zip(("kt", "start", "end", "rows", "cols", "vals"),
                          jarr):
            assert np.array_equal(np.asarray(x), tarr[key]), key
    jb = jk5._kmajor_blocks(jp)
    tb = cres_spmm._kmajor_blocks(tp)
    for key, x in zip(("rt8", "kt8", "rows", "cols", "vals"), jb[:5]):
        assert np.array_equal(np.asarray(x), tb[key]), key
    assert jb[5] == len(tb["kt8"])
    jl = jk5._kmajor_loop(jp)
    tl = cres_spmm._kmajor_loop(tp)
    for key, x in zip(("start", "end", "rt", "rows", "cols", "vals"), jl):
        assert np.array_equal(np.asarray(x), tl[key]), key


def test_plan_from_container_and_interop():
    r, c, v = triplets(**CASES["ragged_empty_tile"])
    sp = scipy.sparse.coo_matrix((v, (r, c)), shape=(300, 700)).tocsr()
    a_t = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape)
    jp = jtiles.plan_from_container(JCSR.from_scipy(sp))
    tp = tiles.plan_from_container(a_t)
    assert tiles.plan_from_container(a_t) is tp  # cached on the container
    there = jtiles.TilePlan(**interop.tile_plan_arrays(tp))
    back = interop.tile_plan_from_arrays(*(getattr(jp, f) for f in FIELDS),
                                         jp.shape, jp.tile_m, jp.tile_k,
                                         jp.chunk)
    for f in FIELDS:
        assert np.array_equal(getattr(jp, f), getattr(tp, f))
        assert np.array_equal(getattr(there, f), getattr(jp, f))
        assert np.array_equal(getattr(back, f), getattr(tp, f))


def b_pair(k, n, seed, bf16):
    """The same B for both packages: f32, or bf16 values (a jnp bf16
    array there, a torch bf16 tensor here)."""
    b = np.random.default_rng(seed).uniform(-1, 1, (k, n)).astype(np.float32)
    if not bf16:
        return b, torch.from_numpy(b)
    jb = jnp.asarray(b, dtype=jnp.bfloat16)
    return jb, torch.from_numpy(np.array(jb.astype(jnp.float32))).to(
        torch.bfloat16)


def close(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= TOL * np.abs(ref).max(), err
    return err


KERNELS = {
    # name: (JAX call, port call, tiers)
    "tile": (lambda p, b, m: jk3.spmm_tiles(p, b, mode=m, interpret=True),
             lambda p, b, m: tile_spmm.spmm_tiles(p, b, mode=m),
             ("split", "split2", "highest")),
    "staged": (lambda p, b, m: jk4.spmm_staged(p, b, mode=m, interpret=True),
               lambda p, b, m: csr_vmem.spmm_staged(p, b, mode=m),
               ("split", "split2", "highest")),
    "cres": (lambda p, b, m: jk5.spmm_cres(p, b, mode=m, interpret=True),
             lambda p, b, m: cres_spmm.spmm_cres(p, b, mode=m),
             ("split", "split2", "highest")),
    "cres_kloop": (
        lambda p, b, m: jk5.spmm_cres(p, b, mode=m, schedule="kloop",
                                      interpret=True),
        lambda p, b, m: cres_spmm.spmm_cres(p, b, mode=m, schedule="kloop"),
        ("split", "split2")),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_kernel_matches_jax(kernel, bf16):
    jrun, trun, modes = KERNELS[kernel]
    jp, tp = plans("ragged_empty_tile")
    jb, tb = b_pair(700, 200, seed=5, bf16=bf16)
    before = (tile_spmm.spmm_tiles.launches, csr_vmem.spmm_staged.launches,
              cres_spmm.spmm_cres.launches,
              cres_spmm.spmm_cres_kloop.launches)
    for mode in modes:
        got = trun(tp, tb, mode)
        close(got, jrun(jp, jb, mode))
        assert float(got[128:256].abs().max()) == 0.0  # the empty row tile
    assert before == (tile_spmm.spmm_tiles.launches,
                      csr_vmem.spmm_staged.launches,
                      cres_spmm.spmm_cres.launches,
                      cres_spmm.spmm_cres_kloop.launches)


def test_tolerance_rejects_plain_f32_at_split2():
    """At "split2" the JAX result differs from plain f32 products by more
    than TOL·max|C|: the tolerance tests the tier, not just the sum."""
    jp, tp = plans("ragged_empty_tile")
    jb, tb = b_pair(700, 200, seed=6, bf16=False)
    ref = np.asarray(jk5.spmm_cres(jp, jb, mode="split2", interpret=True))
    plain_f32 = cres_spmm.spmm_cres(tp, tb, mode="highest").numpy()
    assert np.abs(plain_f32 - ref).max() > TOL * np.abs(ref).max()


def test_duplicates_and_container_entries_match_jax():
    r, c, v = triplets(**CASES["duplicates"])
    sp = scipy.sparse.coo_matrix((v, (r, c)), shape=(260, 390))
    from tpuspmm.formats import COO as JCOO
    from tpuspmm_torch.formats import COO

    a_j = JCOO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
               shape=(260, 390))
    a_t = COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
              shape=(260, 390))
    jb, tb = b_pair(390, 70, seed=7, bf16=False)
    close(tile_spmm.spmm_tile_sparse(a_t, tb),
          jk3.spmm_tile_sparse(a_j, jb, interpret=True))
    close(csr_vmem.spmm_staged(a_t, tb), jk4.spmm_staged(a_j, jb,
                                                         interpret=True))
    close(cres_spmm.spmm_cres(a_t, tb), jk5.spmm_cres(a_j, jb,
                                                      interpret=True))
    f64 = sp.toarray().astype(np.float64) @ jb.astype(np.float64)
    got = tile_spmm.spmm_tile_sparse(a_t, tb).numpy()
    assert np.abs(got - f64).max() <= 1e-5 * np.abs(f64).max()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_staged_slabbed_matches_jax(monkeypatch, bf16):
    """K4 with B staged in slabs: JAX's budget picks (num_slabs, slab_k);
    the card's rule is handed the shared memory that gives the same
    slab_k, and both the entry and the plain version agree with JAX."""
    r, c, v = triplets(m=300, k=1100, density=0.02, seed=8)
    jp = jtiles.build_tile_plan(r, c, v, (300, 1100))
    tp = tiles.build_tile_plan(r, c, v, (300, 1100))
    jb, tb = b_pair(1100, 130, seed=9, bf16=bf16)
    budget = 1 << 20
    k_pad, n_pad = tp.num_k_tiles * 128, 256
    chunk_bytes = tp.num_chunks * tp.chunk * 12
    assert not jk4.fits_vmem(k_pad, n_pad, 128, budget, chunk_bytes)
    slab_k = jk4.max_slab_k(k_pad, n_pad, 128, 128, budget, chunk_bytes)
    num_slabs = -(-k_pad // slab_k)
    assert num_slabs > 1
    monkeypatch.setattr(csr_vmem, "smem_optin", lambda dev: (
        128 + slab_k) * csr_vmem.COLUMN_TILE * 4)
    assert csr_vmem.slab_geometry(tp, "cpu") == (num_slabs, slab_k)
    for mode in ("split", "split2", "highest"):
        ref = jk4.spmm_staged(jp, jb, mode=mode, budget_bytes=budget,
                              interpret=True)
        close(csr_vmem.spmm_staged(tp, tb, mode=mode), ref)
        close(csr_vmem.staged_spmm_plain(tp, tb, num_slabs, slab_k, mode),
              ref)


def test_plain_batches_change_nothing(monkeypatch):
    jp, tp = plans("ragged_empty_tile")
    _, tb = b_pair(700, 64, seed=10, bf16=False)
    whole = tile_spmm.tile_spmm_plain(tp, tb, "split")
    monkeypatch.setattr(tile_spmm, "PLAIN_BATCH_BYTES", 1)
    assert torch.equal(tile_spmm.tile_spmm_plain(tp, tb, "split"), whole)


def owner_walk(plan, b):
    """Pure-torch walk of what the owner-walk kernel (K3, K5a and K5b on
    the card) reads: row tile r's chunks [tile_ptr[r], tile_ptr[r+1]) of
    the row-major plan, padding slots (row -1) skipped, in f64."""
    arrs = tile_spmm.owner_arrays(plan, "cpu")
    ptr = arrs["tile_ptr"].tolist()
    tm, tk = plan.tile_m, plan.tile_k
    bp = torch.zeros(plan.num_k_tiles * tk, b.shape[1], dtype=torch.float64)
    bp[:b.shape[0]] = b.double()
    out = torch.zeros(plan.num_row_tiles * tm, b.shape[1],
                      dtype=torch.float64)
    for r in range(plan.num_row_tiles):
        for c in range(ptr[r], ptr[r + 1]):
            keep = arrs["rows"][c] >= 0
            rows = arrs["rows"][c][keep].long() + r * tm
            krows = int(arrs["kt"][c]) * tk + arrs["cols"][c][keep].long()
            out.index_add_(0, rows, arrs["vals"][c][keep].double()
                           .unsqueeze(-1) * bp[krows])
    return out[:plan.shape[0]]


@pytest.mark.parametrize("case", [*CASES, "empty"])
def test_owner_walk_reproduces_every_plain_layout(case):
    """The card walks the row-major plan for K3, K5a and K5b: every chunk
    once, each row tile's in ascending k tile.  That walk equals the plain
    versions over the row-major, block8 and kloop layouts."""
    _, tp = plans(case)
    ptr = tile_spmm.owner_arrays(tp, "cpu")["tile_ptr"]
    assert ptr[0] == 0 and ptr[-1] == tp.num_chunks
    assert bool((ptr[1:] > ptr[:-1]).all())  # every row tile has a chunk
    _, b = b_pair(tp.shape[1], 40, seed=12, bf16=False)
    walk = owner_walk(tp, b).float()
    scale = max(float(walk.abs().max()), 1.0)
    for plain in (tile_spmm.tile_spmm_plain(tp, b, "highest"),
                  cres_spmm.cres_spmm_plain(tp, b, "highest", "block8"),
                  cres_spmm.cres_spmm_plain(tp, b, "split", "kloop")):
        assert float((plain - walk).abs().max()) <= TOL * scale


def test_card_residency_rules():
    """The admission rules on the card, with the H100's 232,448 bytes of
    opt-in shared memory per block (a CPU tensor reads the H100's)."""
    assert csr_vmem.smem_optin("cpu") == 232448
    assert csr_vmem.max_slab_k(25728, 128, 128, 232448) == 768
    assert csr_vmem.max_slab_k(512, 128, 128, 232448) == 512
    assert csr_vmem.max_slab_k(1024, 128, 128, 128 * 64 * 4 + 100) == 0
    assert csr_vmem.fits_whole_b(768, 128, 128, "cpu")
    assert not csr_vmem.fits_whole_b(896, 128, 128, "cpu")
    r, c, v = triplets(m=2048, k=2048, density=0.002, seed=11)
    assert csr_vmem.slab_geometry(tiles.build_tile_plan(
        r, c, v, (2048, 2048)), "cpu") == (3, 768)
    assert cres_spmm.fits_card_out(128, "cpu")
    assert not cres_spmm.fits_card_out(1024, "cpu")  # 256 KiB accumulator
    with pytest.raises(ValueError):
        csr_vmem.smem_optin("meta")


def test_entry_refusals():
    jp, tp = plans("one_tile")
    b = torch.zeros(90, 16)
    with pytest.raises(ValueError, match="kloop"):  # as the JAX package
        cres_spmm.spmm_cres(tp, b, mode="highest", schedule="kloop")
    with pytest.raises(ValueError, match="kloop"):
        jk5.spmm_cres(jp, np.zeros((90, 16), np.float32), mode="highest",
                      schedule="kloop", interpret=True)
    with pytest.raises(ValueError, match="schedule"):
        cres_spmm.spmm_cres(tp, b, schedule="other")
    for fn in (tile_spmm.spmm_tiles, csr_vmem.spmm_staged,
               cres_spmm.spmm_cres):
        with pytest.raises(ValueError, match="mode"):
            fn(tp, b, mode="fast")
        with pytest.raises(ValueError, match="K=90"):
            fn(tp, torch.zeros(91, 16))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor runs a plain version: any other device goes to
    the CUDA launcher, which refuses what it cannot launch."""
    _, tp = plans("one_tile")
    meta = torch.empty(90, 16, device="meta")
    counts = (tile_spmm.spmm_tiles.launches, csr_vmem.spmm_staged.launches,
              cres_spmm.spmm_cres.launches,
              cres_spmm.spmm_cres_kloop.launches)
    calls = (lambda: tile_spmm.spmm_tiles(tp, meta),
             lambda: csr_vmem.spmm_staged(tp, meta),
             lambda: cres_spmm.spmm_cres(tp, meta),
             lambda: cres_spmm.spmm_cres_kloop(tp, meta, mode="split2"))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert counts == (tile_spmm.spmm_tiles.launches,
                      csr_vmem.spmm_staged.launches,
                      cres_spmm.spmm_cres.launches,
                      cres_spmm.spmm_cres_kloop.launches)
