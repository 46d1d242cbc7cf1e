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

import re
import types

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
from tpuspmm_torch.kernels import chunk_cuda, cres_spmm, csr_vmem, tile_spmm

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


def index_of(plan, min_dense):
    """The tile index that K3, K4, K5a and K5b read on the card."""
    return tile_spmm.host_index(plan, min_dense)


def slab_walk(plan, num_slabs, kts_per_slab):
    """K4's slab layout as a chunk walk: (rt, kt, rows, cols, vals) per
    chunk, in (row tile, slab) range order."""
    arrs = csr_vmem._slab_arrays(plan, num_slabs, kts_per_slab)
    lengths = arrs["end"] - arrs["start"]
    rt = np.repeat(np.arange(lengths.size) // num_slabs, lengths)
    return rt, arrs["kt"], arrs["rows"], arrs["cols"], arrs["vals"]


def owner_walk(plan, b, min_dense):
    """Pure-torch replay of what the tile-owner routine (K3, K4, K5a, K5b
    on the card) reads, in f64: per row tile its dense tiles' A @ B panel,
    then per output row its sparse nonzeros in index order."""
    ix = index_of(plan, min_dense)
    tm, tk = plan.tile_m, plan.tile_k
    bp = torch.zeros(plan.num_k_tiles * tk, b.shape[1], dtype=torch.float64)
    bp[:b.shape[0]] = b.double()
    out = torch.zeros(plan.num_row_tiles * tm, b.shape[1],
                      dtype=torch.float64)
    d_a = torch.from_numpy(ix["d_a"]).double()
    for r in range(plan.num_row_tiles):
        for t in range(ix["d_ptr"][r], ix["d_ptr"][r + 1]):
            k0 = int(ix["d_kt"][t]) * tk
            out[r * tm:(r + 1) * tm] += d_a[t, :tm] @ bp[k0:k0 + tk]
    rows = torch.from_numpy(np.repeat(np.arange(len(ix["row_ptr"]) - 1),
                                      np.diff(ix["row_ptr"])))
    vals = torch.from_numpy(ix["g_val"]).double().unsqueeze(-1)
    out.index_add_(0, rows, vals * bp[torch.from_numpy(ix["g_col"]).long()])
    return out[:plan.shape[0]]


# thresholds of the dense path at tile_k 128: the routine's default
# (DENSE_PER_TILE_K·tile_k), one nonzero per k row, every tile dense,
# every tile gathered ("split2")
THRESHOLDS = {"default": 1024.0, "one_per_k": 128.0, "all_dense": 0.0,
              "all_sparse": float("inf")}


@pytest.mark.parametrize("threshold", list(THRESHOLDS))
@pytest.mark.parametrize("case", [*CASES, "empty"])
def test_owner_walk_reproduces_every_plain_layout(case, threshold):
    """The card walks one tile index for K3, K4, K5a and K5b: every
    nonzero once, dense tiles on the tensor cores, the rest gathered.  Its
    replay equals the plain versions over the row-major, slab, block8 and
    kloop layouts."""
    _, tp = plans(case)
    _, b = b_pair(tp.shape[1], 40, seed=12, bf16=False)
    min_dense = THRESHOLDS[threshold]
    walk = owner_walk(tp, b, min_dense).float()
    slabs = (-(-tp.num_k_tiles // 2), 2)
    scale = max(float(walk.abs().max()), 1.0)
    for plain in (tile_spmm.tile_spmm_plain(tp, b, "highest"),
                  csr_vmem.staged_spmm_plain(tp, b, slabs[0], 256, "split"),
                  cres_spmm.cres_spmm_plain(tp, b, "highest", "block8"),
                  cres_spmm.cres_spmm_plain(tp, b, "split", "kloop")):
        assert float((plain - walk).abs().max()) <= TOL * scale


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_owner_walk_matches_jax(bf16):
    """The replay of the index against the JAX kernels in interpret mode,
    on the same plan (the duplicates case), at a threshold of one nonzero
    per k row, so that some of its tiles are dense."""
    jp, tp = plans("duplicates")
    jb, tb = b_pair(tp.shape[1], 72, seed=13, bf16=bf16)
    walk = owner_walk(tp, tb, THRESHOLDS["one_per_k"]).float()
    assert index_of(tp, THRESHOLDS["one_per_k"])["tile_dense"].any()
    for ref in (jk3.spmm_tiles(jp, jb, mode="split", interpret=True),
                jk4.spmm_staged(jp, jb, mode="split", interpret=True),
                jk5.spmm_cres(jp, jb, mode="highest", interpret=True)):
        close(walk, ref)


@pytest.mark.parametrize("threshold", list(THRESHOLDS))
@pytest.mark.parametrize("case", [*CASES, "empty"])
def test_tile_index_lists_every_nonzero_once(case, threshold):
    """Every real nonzero of the plan sits once in the index, in its own
    (rt, kt) tile: dense tiles hold it in A (duplicates added), the rest in
    its output row's list, in ascending k-tile; a tile is dense from the
    threshold on."""
    _, tp = plans(case)
    tm, tk = tp.tile_m, tp.tile_k
    ix = index_of(tp, THRESHOLDS[threshold])
    real = tp.rows >= 0
    c_idx, slot = np.nonzero(real)
    grow = tp.rt[c_idx].astype(np.int64) * tm + tp.rows[c_idx, slot]
    gk = tp.kt[c_idx].astype(np.int64) * tk + tp.cols[c_idx, slot]
    val = tp.vals[c_idx, slot]
    key = (grow // tm) * tp.num_k_tiles + gk // tk
    tiles_key = ix["tile_rt"] * tp.num_k_tiles + ix["tile_kt"]
    assert np.array_equal(tiles_key, np.unique(key))
    assert np.array_equal(ix["tile_nnz"],
                          np.unique(key, return_counts=True)[1])
    assert np.array_equal(ix["tile_dense"],
                          ix["tile_nnz"] >= THRESHOLDS[threshold])
    for t, (c0, c1) in enumerate(zip(ix["tile_c0"], ix["tile_c1"])):
        assert tp.rt[c0] == tp.rt[c1 - 1] == ix["tile_rt"][t]
        assert tp.kt[c0] == tp.kt[c1 - 1] == ix["tile_kt"][t]
    dense = np.isin(key, tiles_key[ix["tile_dense"]])
    # sparse: each output row's nonzeros in walk order (ascending k-tile)
    rows = np.repeat(np.arange(len(ix["row_ptr"]) - 1),
                     np.diff(ix["row_ptr"]))
    order = np.argsort(grow[~dense], kind="stable")
    assert np.array_equal(rows, grow[~dense][order])
    assert np.array_equal(ix["g_col"], gk[~dense][order])
    assert np.array_equal(ix["g_val"], val[~dense][order])
    for r in range(len(ix["row_ptr"]) - 1):
        kts = ix["g_col"][ix["row_ptr"][r]:ix["row_ptr"][r + 1]] // tk
        assert np.all(np.diff(kts) >= 0)
    # dense: A tiles, rows padded to the warp's 16, duplicates added
    dkeys = tiles_key[ix["tile_dense"]]
    want = np.zeros((len(dkeys), -(-tm // 16) * 16, tk), np.float64)
    np.add.at(want, (np.searchsorted(dkeys, key[dense]), grow[dense] % tm,
                     gk[dense] % tk), val[dense])
    assert np.allclose(ix["d_a"], want, rtol=1e-6, atol=0)
    assert np.array_equal(ix["d_kt"], dkeys % tp.num_k_tiles)
    assert np.array_equal(ix["d_ptr"], np.searchsorted(
        dkeys // tp.num_k_tiles, np.arange(tp.num_row_tiles + 1)))
    nnz_rt = np.bincount(grow // tm, minlength=tp.num_row_tiles)
    assert sorted(ix["order"]) == list(range(tp.num_row_tiles))
    assert np.all(np.diff(nnz_rt[ix["order"]]) <= 0)  # most work first


@pytest.mark.parametrize("slabs", [(1, None), (2, 2), (3, 1)],
                         ids=["one_slab", "two_kt_slabs", "one_kt_slabs"])
@pytest.mark.parametrize("case", [*CASES, "empty"])
def test_slab_layout_lists_the_plans_chunks(case, slabs):
    """K4 reads K3's tile index on the card: its slab layout lists the
    plan's chunks, each in its own (row tile, slab) range and each row
    tile's in ascending k-tile, so an index built from the slab walk is
    K3's, array for array."""
    _, tp = plans(case)
    num_slabs, kps = slabs[0], slabs[1] or tp.num_k_tiles
    if num_slabs * kps < tp.num_k_tiles:
        kps = -(-tp.num_k_tiles // num_slabs)
    rt, kt, rows, cols, vals = slab_walk(tp, num_slabs, kps)
    arrs = csr_vmem._slab_arrays(tp, num_slabs, kps)
    for g, (c0, c1) in enumerate(zip(arrs["start"], arrs["end"])):
        assert np.all(rt[c0:c1] == g // num_slabs)
        assert np.all(np.minimum(kt[c0:c1] // kps, num_slabs - 1)
                      == g % num_slabs)
    real = (rows >= 0).any(axis=1)
    for r in range(tp.num_row_tiles):
        assert np.all(np.diff(kt[(rt == r) & real]) >= 0)

    def chunks(*a):
        return sorted(zip(*(np.asarray(x).reshape(len(a[0]), -1).tolist()
                            for x in a)))

    assert chunks(rt, kt, rows, cols, vals) == chunks(
        tp.rt, tp.kt, tp.rows, tp.cols, tp.vals)
    for threshold in THRESHOLDS.values():
        walked = tile_spmm.build_tile_index(
            rt, kt, rows, cols, vals, tp.num_row_tiles, tp.tile_m,
            tp.tile_k, threshold)
        ix = index_of(tp, threshold)
        for name in chunk_cuda.INDEX:
            assert np.array_equal(walked[name], ix[name]), name


def test_dense_path_rules():
    """The dense path: from DENSE_PER_TILE_K·tile_k nonzeros on (the
    tests' default threshold), never at "split2" or when tile_k is not a
    multiple of the routine's k-chunk."""
    assert tile_spmm.dense_min(128, False) == THRESHOLDS["default"] == 1024
    assert tile_spmm.dense_min(256, False) == 2048
    assert tile_spmm.dense_min(128, True) == float("inf")
    assert tile_spmm.dense_min(100, False) == float("inf")


def test_routine_constants_match_source():
    """The geometry the wrappers and the index assume is the one compiled
    into csrc/chunk_spmm.cu."""
    with open(chunk_cuda.SOURCE) as f:
        text = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))

    assert const("WARP_ROWS") == chunk_cuda.WARP_ROWS
    assert const("MAX_ROWS") == chunk_cuda.MAX_ROWS
    assert const("KC") == chunk_cuda.KC
    assert (const("NARROW_TN"), const("WIDE_TN")) == chunk_cuda.COLUMN_TILES
    for name in chunk_cuda.INDEX:  # the C interface's index arrays
        assert re.search(rf"const (int|float)\* {name}[,;)]", text), name
    # the gather build's limits, and the shape the binding picks inside them
    assert const("GATHER_WARPS_MAX") == chunk_cuda.GATHER_WARPS_MAX
    assert const("GATHER_MAX_ROWS") == chunk_cuda.GATHER_MAX_ROWS
    assert const("GATHER_SM_WARPS") == chunk_cuda.GATHER_SM_WARPS
    assert 1 <= chunk_cuda.GATHER_WARPS <= chunk_cuda.GATHER_WARPS_MAX
    assert 1 <= chunk_cuda.GATHER_ROWS <= chunk_cuda.GATHER_MAX_ROWS
    assert chunk_cuda.GATHER_F32_PASSES in (1, 2)
    assert chunk_cuda.GATHER_PASS_BYTES == 32 * 16
    assert c_params(chunk_cuda.SOURCE, "gather_spmm")[:3] == list(
        chunk_cuda.GATHER_INDEX)


def c_params(source: str, entry: str) -> list:
    """The parameter names of the C entry ``entry`` of ``source``."""
    with open(source) as f:
        text = f.read()
    params = re.search(rf"\b{entry}\(([^)]*)\)\s*{{", text).group(1)
    return [p.split()[-1].lstrip("*") for p in params.split(",")]


def launched_args(launch, b, monkeypatch) -> dict:
    """The arguments that ``launch(b)`` (a ``cuda_build.Launch``) hands its
    C entry, by the entry's parameter names, captured by a stand-in
    library; the current device and stream are stood in for, so a CPU
    tensor takes the place of B."""
    seen = []
    lib = types.SimpleNamespace(
        **{launch.name: lambda *args: seen.append(args) or 0})
    monkeypatch.setattr(launch.module, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: launch.index)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    launch(b)
    return dict(zip(c_params(launch.module.SOURCE, launch.name), seen[-1]))


def test_bindings_match_the_c_interface():
    """Each C entry's ctypes argument list is as long as its C parameter
    list (a short one would pass the stream where the column tile
    goes)."""
    from types import SimpleNamespace

    with open(chunk_cuda.SOURCE) as f:
        text = f.read()
    names = ("tile_owner_spmm", "cres_cluster_spmm", "gather_spmm",
             "chunk_spmm_blocks_per_sm", "cres_cluster_max_active",
             "gather_blocks_per_sm", "chunk_spmm_error_string")
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in names})
    chunk_cuda._bind(lib)
    for name in names:
        params = re.search(rf"\b{name}\(([^)]*)\)\s*{{", text).group(1)
        assert len(getattr(lib, name).argtypes) == len(params.split(",")), \
            name


@pytest.mark.parametrize("cluster", [False, True], ids=["owner", "cluster"])
@pytest.mark.parametrize("n,sms", [(256, 132), (256, 6), (256, 7), (77, 1)])
def test_bound_launch_passes_the_column_tile(n, sms, cluster, monkeypatch):
    """The column tile that a bound owner-routine or cluster launch hands
    its C entry, captured by a stand-in library, is ``column_tile`` over
    the index's real row tiles (3 here; the cluster launch's 2 clusters of
    2 do not count), as the binding records it: 64 at (256, 132) and
    (256, 7), 128 at (256, 6) and (77, 1)."""
    from tpuspmm_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: sms)
    _, tp = plans("ragged_empty_tile")
    md = THRESHOLDS["one_per_k"]
    idx = tile_spmm.index_arrays(tp, "cpu", md)
    sched = cres_spmm.schedule_arrays(tp, "cpu", md) if cluster else None
    b = torch.zeros(tp.shape[1], n)
    launch = chunk_cuda.bind("tile_chunk_spmm", idx, b, tp.shape[0],
                             tp.tile_m, tp.tile_k, False, sched)
    got = launched_args(launch, b, monkeypatch)
    want = chunk_cuda.column_tile(tp.num_row_tiles, n, sms)
    assert got["tn"] == launch.shape["column_tile"] == want
    assert want == (64 if (n, sms) in ((256, 132), (256, 7)) else 128)


def bound_on_stand_in(threshold, cluster, n, dtype, split2, monkeypatch):
    """(launch, its tile index, B) for ragged_empty_tile's plan at
    ``threshold``, bound by ``chunk_cuda.bind`` as K3 (or, with
    ``cluster``, as K5a over its cluster schedule) for a (k, n) B of
    ``dtype`` on the CPU, the card's checks and SM count (132) stood in
    for."""
    from tpuspmm_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 132)
    _, tp = plans("ragged_empty_tile")
    idx = tile_spmm.index_arrays(tp, "cpu", threshold)
    sched = (cres_spmm.schedule_arrays(tp, "cpu", threshold) if cluster
             else None)
    b = torch.zeros(tp.shape[1], n, dtype=dtype)
    entry = "cres_chunk_spmm" if cluster else "tile_chunk_spmm"
    launch = chunk_cuda.bind(entry, idx, b, tp.shape[0], tp.tile_m,
                             tp.tile_k, split2, sched)
    return launch, idx, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [16, 77, 256, 512])
@pytest.mark.parametrize("cluster", [False, True], ids=["owner", "cluster"])
def test_index_with_no_dense_tile_binds_the_gather_build(cluster, n, dtype,
                                                         monkeypatch):
    """An index with no dense tile, bound by the owner entry (K3) or the
    cluster entry (K5a), launches ``gather_spmm`` over the index's CSR in
    the shape ``gather_shape`` gives (132 SMs), as the binding records it
    on ``Launch.shape``; the arguments, captured by a stand-in library,
    are the C entry's parameters one for one."""
    launch, idx, b = bound_on_stand_in(THRESHOLDS["all_sparse"], cluster, n,
                                       dtype, False, monkeypatch)
    m, k = 300, 700
    bf16 = dtype == torch.bfloat16
    want = chunk_cuda.gather_shape(m, n, bf16, 132)
    assert launch.name == "gather_spmm" and launch.shape == want
    assert want["build"] == "gather"
    got = launched_args(launch, b, monkeypatch)
    assert list(got) == c_params(chunk_cuda.SOURCE, "gather_spmm")
    assert [got[name] for name in chunk_cuda.GATHER_INDEX] == [
        idx[name].data_ptr() for name in chunk_cuda.GATHER_INDEX]
    assert (got["m"], got["k"], got["n"], got["b_bf16"]) == (m, k, n, bf16)
    assert (got["rows_per_warp"], got["warps"], got["passes"],
            [got["grid_x"], got["grid_y"]]) == (
        want["rows_per_warp"], want["warps"], want["passes"], want["grid"])


@pytest.mark.parametrize("split2", [False, True], ids=["dense", "split2"])
@pytest.mark.parametrize("cluster", [False, True], ids=["owner", "cluster"])
def test_dense_index_and_split2_bind_the_routine(cluster, split2,
                                                 monkeypatch):
    """An index with a dense tile (one nonzero per k row makes a tile
    dense here), and any index at "split2" (which has none), bind the
    owner routine (``tile_owner_spmm``) or the cluster launch
    (``cres_cluster_spmm``) with the arguments the parent commit passed:
    the index's tiles and dense tiles, the tier and the column tile."""
    threshold = (tile_spmm.dense_min(128, True) if split2
                 else THRESHOLDS["one_per_k"])
    launch, idx, b = bound_on_stand_in(threshold, cluster, 256,
                                       torch.float32, split2, monkeypatch)
    name = "cres_cluster_spmm" if cluster else "tile_owner_spmm"
    tn = chunk_cuda.column_tile(3, 256, 132)
    assert launch.name == name
    assert launch.shape == {"build": "cluster" if cluster else "owner",
                            "column_tile": tn}
    got = launched_args(launch, b, monkeypatch)
    assert len(got) == len(c_params(chunk_cuda.SOURCE, name))
    assert [got[key] for key in chunk_cuda.INDEX] == [
        idx[key].data_ptr() for key in chunk_cuda.INDEX]
    n_dense = idx["d_kt"].numel()
    assert (n_dense > 0) is not split2
    assert (got["num_tiles"], got["m"], got["k"], got["n"], got["tm"],
            got["tk"], got["n_dense"], got["split2"], got["tn"]) == (
        3, 300, 700, 256, 128, 128, n_dense, int(split2), tn)


# (m, n, B dtype): the gather build's shape on 132 SMs, worked by hand
GATHER_SHAPES = {(6300, 256, "f32"): (2, 2, [394, 1]),
                 (6300, 256, "bf16"): (2, 1, [394, 1]),
                 (6300, 512, "f32"): (2, 2, [394, 2]),
                 (6300, 512, "bf16"): (2, 1, [394, 2]),
                 (6300, 16, "f32"): (2, 1, [394, 1]),
                 (6300, 128, "f32"): (2, 1, [394, 1]),
                 (28, 77, "f32"): (1, 1, [4, 1]),
                 (28, 512, "bf16"): (1, 1, [4, 2]),
                 (1, 16, "bf16"): (1, 1, [1, 1])}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [16, 77, 128, 256, 512])
@pytest.mark.parametrize("m", [1, 28, 6300])
def test_gather_grid_rule(m, n, dtype):
    """The gather build's launch shape: a pass covers 128 f32 or 256 bf16
    columns, two passes a warp over f32 B wider than one; the grid covers
    the m rows and n columns with no block or column span to spare; one
    row a warp where a warp a row and span fits 132 SMs in one wave
    (GATHER_SM_WARPS an SM), else GATHER_ROWS; GATHER_WARPS a block.
    The shapes of GATHER_SHAPES are worked by hand."""
    shape = chunk_cuda.gather_shape(m, n, dtype == "bf16", 132)
    rows, warps, passes = (shape["rows_per_warp"], shape["warps"],
                           shape["passes"])
    grid_x, grid_y = shape["grid"]
    cols = passes * (256 if dtype == "bf16" else 128)
    assert warps == chunk_cuda.GATHER_WARPS
    assert passes == (2 if dtype == "f32" and n > 128 else 1)
    assert (grid_x - 1) * warps * rows < m <= grid_x * warps * rows
    assert (grid_y - 1) * cols < n <= grid_y * cols
    assert rows == (1 if m * grid_y <= 132 * chunk_cuda.GATHER_SM_WARPS
                    else chunk_cuda.GATHER_ROWS)
    if (m, n, dtype) in GATHER_SHAPES:
        assert (rows, passes, shape["grid"]) == GATHER_SHAPES[m, n, dtype]


def test_tile_shapes_the_routine_runs_or_refuses():
    """Row tiles of 1 to 128 rows run (ceil(tm / 16) warps; the index pads
    dense A to whole warps; here a tile is dense from one nonzero per k
    row); a larger one is refused before any launch, by name."""
    for tm in (16, 64, 100, 128):
        chunk_cuda.check_shape(tm)
    r, c, v = triplets(m=300, k=700, density=0.03, seed=14)
    for tm, tk, dense in ((64, 256, True), (100, 100, False)):
        tp = tiles.build_tile_plan(r, c, v, (300, 700), tile_m=tm,
                                   tile_k=tk, chunk=64)
        _, b = b_pair(700, 24, seed=15, bf16=False)
        min_dense = (tile_spmm.dense_min(tk, False)
                     / tile_spmm.DENSE_PER_TILE_K)
        ix = index_of(tp, min_dense)
        assert ix["d_a"].shape[1:] == (-(-tm // 16) * 16, tk)
        assert bool(ix["tile_dense"].any()) == dense
        walk = owner_walk(tp, b, min_dense).float()
        plain = tile_spmm.tile_spmm_plain(tp, b, "highest")
        assert float((plain - walk).abs().max()) <= TOL * float(
            plain.abs().max())
    big = tiles.build_tile_plan(r, c, v, (300, 700), tile_m=256)
    meta = torch.empty(700, 16, device="meta")
    before = tile_spmm.spmm_tiles.launches
    with pytest.raises(ValueError, match="tile_m=256"):
        chunk_cuda.check_shape(256)
    with pytest.raises(ValueError, match="tile_m=256"):
        tile_spmm.spmm_tiles(big, meta)
    assert tile_spmm.spmm_tiles.launches == before


def test_residency_rules_do_not_read_the_kernel_column_tile(monkeypatch):
    """The staging and C-resident rules plan with a 64-column tile of
    their own: the routine's column tiles do not move a route."""
    r, c, v = triplets(m=2048, k=2048, density=0.002, seed=11)
    tp = tiles.build_tile_plan(r, c, v, (2048, 2048))
    monkeypatch.setattr(chunk_cuda, "COLUMN_TILES", (128, 256))
    assert csr_vmem.COLUMN_TILE == 64
    assert csr_vmem.slab_geometry(tp, "cpu") == (3, 768)
    assert cres_spmm.residency(tp, "cpu")["accumulator_bytes"] == 128 * 64 * 4


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


# the dispatcher's route on every data/ dir at B width 256 under the H100
# row (kernels/dispatch.H100_FIT: the routes JAX's rules admit, priced by
# the serve-time model), at the row's plan-bytes cap and with no panel or
# pair plan admitted: the tile-owner routine must not move them, and the
# row moves them only with its records (tools/routing_h100.jsonl)
ROUTES_ON_DATA = {
    "large_15120": ("cres", "cres"), "large_20000": ("exact", "exact"),
    "large_21074": ("cres", "cres"), "large_25605": ("cres", "cres"),
    "medium_1484": ("exact", "exact"), "medium_2048": ("cres", "cres"),
    "medium_2880": ("exact", "exact"), "medium_4000": ("panel", "cres"),
    "medium_4096": ("cres", "cres"), "small_10x10": ("densify", "densify"),
    "small_210": ("densify", "densify"),
    "small_32x32": ("densify", "densify"),
}


@pytest.mark.parametrize("name", sorted(ROUTES_ON_DATA))
def test_routes_on_data_dirs_are_pinned(name, monkeypatch):
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import dispatch

    a = convert.load_sparse(data_dir(name), "csr")
    b = torch.zeros(a.shape[1], 256)
    default, capped = ROUTES_ON_DATA[name]
    assert dispatch.route(a, b) == default
    # the dispatcher reads its plan cap from the row, as JAX's does
    monkeypatch.setitem(dispatch.H100_FIT, "panel_max_plan_bytes", 1)
    a = convert.load_sparse(data_dir(name), "csr")  # no cached geometry
    assert dispatch.route(a, b) == capped


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
    min_dense = tile_spmm.dense_min(tp.tile_k, False)
    calls = (lambda: tile_spmm.spmm_tiles(tp, meta),
             lambda: csr_vmem.spmm_staged(tp, meta),
             lambda: cres_spmm.spmm_cres(tp, meta),
             lambda: cres_spmm.spmm_cres_kloop(tp, meta, mode="split2"),
             # the cluster launch itself, as K5a and K5b enter it
             lambda: chunk_cuda.launch_cluster(
                 "cres_chunk_spmm", tile_spmm.index_arrays(tp, "meta",
                                                           min_dense),
                 cres_spmm.schedule_arrays(tp, "meta", min_dense), meta,
                 tp.shape[0], tp.tile_m, tp.tile_k, False))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert counts == (tile_spmm.spmm_tiles.launches,
                      csr_vmem.spmm_staged.launches,
                      cres_spmm.spmm_cres.launches,
                      cres_spmm.spmm_cres_kloop.launches)
