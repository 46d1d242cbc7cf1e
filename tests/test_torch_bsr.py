"""K6, the block-streaming BSR kernel: tpuspmm_torch against tpuspmm.

- ``prep_bsr`` equals JAX's ``_prep_bsr`` (empty block rows included),
  ``pack_blocks`` equals JAX's and is None in the same cases,
  ``mxu_friendly`` agrees.
- ``spmm_bsr_stream`` (the plain version on the CPU) matches JAX's
  ``spmm_bsr_stream`` in Pallas interpret mode, in f32 and bf16 B, within
  1e-5·max|C| (both are f32 sums, in another order), and the oracle at the
  gate.
- The kernel's host prep: the term planes are ``split_bf16``'s terms of
  the blocks in the kernel's swizzled layout and re-sum to the blocks; the
  block-row order is a stable heaviest-first permutation.  A plain-torch
  replay of the kernel's arithmetic (the ladder's bf16 products over the
  planes and B's terms, each step's products summed apart, in the
  kernel's order) matches JAX's ``spmm_bsr_stream`` in interpret mode
  within K6_TOL (2e-6·max|C|, K6's limit on the card) and the oracle at
  the gate; with f32 B the ladder cut to three products misses that limit.
- The gather paths ``spmm_bsr_xla`` and ``spmm_ell_xla`` match JAX's.
- The wrapper takes the plain version only for a CPU tensor; the CUDA
  launcher refuses a CPU tensor and what the kernel does not take; its
  constants and C argument types equal the source's.
"""

import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuspmm.formats as jformats
from tpuspmm.formats import convert as jconvert
from tpuspmm.kernels import bsr_spmm as jk6
from tpuspmm.ops import xla as jxla
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.formats import BSR, convert
from tpuspmm_torch.kernels import bsr_cuda, bsr_spmm
from tpuspmm_torch.kernels.common import pad_b, round_up, split_bf16
from tpuspmm_torch.ops import oracle, xla
from tpuspmm_torch.utils.compare import allclose
from test_torch_tiles import c_params, launched_args

# (rows, cols, block, block density, seed): (8, 128) blocks at 0.4 and at
# 0.15 (empty block rows), (128, 128) blocks, and a 4 × 4 matrix that packs
STREAM_CASES = {
    "b8x128_d40": (64, 512, (8, 128), 0.4, 0),
    "b8x128_d15": (96, 384, (8, 128), 0.15, 3),
    "b128x128": (256, 384, (128, 128), 0.5, 1),
    "b4x4_packable": (256, 256, (4, 4), 0.3, 5),
}


def pair_of(case):
    args = STREAM_CASES[case]
    return BSR.random_blocks(*args), jformats.BSR.random_blocks(*args)


def operand(k, n, seed, dtype):
    b = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 0.05
    jb = jnp.asarray(b, dtype=dtype)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32)))
    return jb, (tb.to(torch.bfloat16) if dtype == jnp.bfloat16 else tb)


def as_jax_bsr(a):
    return jformats.BSR(indptr=a.indptr, indices=a.indices, blocks=a.blocks,
                        shape=a.shape, block_size=a.block_size, nnz=a.nnz)


@pytest.mark.parametrize("case", list(STREAM_CASES) + ["medium_4096"])
def test_prep_bsr_matches_jax(case):
    if case == "medium_4096":
        d = data_dir(case)
        a, ja = convert.load_sparse(d, "bsr"), jconvert.load_sparse(d, "bsr")
    else:
        a, ja = pair_of(case)
    mine = bsr_spmm.prep_bsr(a)
    theirs = [np.asarray(x) for x in jk6._prep_bsr(ja)]
    for key, want in zip(("rt", "kt", "first", "blocks"), theirs):
        assert mine[key].dtype == want.dtype, key
        np.testing.assert_array_equal(mine[key], want, err_msg=key)
    assert bsr_spmm.prep_bsr(a) is mine  # cached
    if case == "b8x128_d15":
        assert len(mine["rt"]) > a.nblocks  # zero blocks were added


@pytest.mark.parametrize("block", [(8, 128), (128, 128), (16, 256), (4, 4),
                                   (8, 64), (4, 128), (24, 384)])
def test_mxu_friendly_agrees(block):
    assert bsr_spmm.mxu_friendly(block) == jk6.mxu_friendly(block)


@pytest.mark.parametrize("args,packs", [
    ((256, 256, (4, 4), 0.3, 5), True),      # a few 128 x 128 blocks fill
    ((256, 256, (4, 4), 0.002, 7), False),   # storage would grow > 4x
    ((192, 256, (4, 4), 0.3, 5), False),     # 192 rows: not a multiple
])
def test_pack_blocks_matches_jax(args, packs):
    a, ja = BSR.random_blocks(*args), jformats.BSR.random_blocks(*args)
    mine, theirs = bsr_spmm.pack_blocks(a), jk6.pack_blocks(ja)
    assert (mine is not None) == (theirs is not None) == packs
    if packs:
        assert mine.block_size == theirs.block_size == (128, 128)
        for f in ("indptr", "indices", "blocks"):
            np.testing.assert_array_equal(getattr(mine, f),
                                          np.asarray(getattr(theirs, f)))
        assert mine.nnz == theirs.nnz
    assert bsr_spmm.pack_blocks(a) is mine  # cached, None included


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_matches_jax_interpret(case, dtype):
    a, ja = pair_of(case)
    if not bsr_spmm.mxu_friendly(a.block_size):
        a, ja = bsr_spmm.pack_blocks(a), jk6.pack_blocks(ja)
    jb, tb = operand(a.shape[1], 200, 11, dtype)
    ref = np.asarray(jk6.spmm_bsr_stream(ja, jb, interpret=True))
    got = bsr_spmm.spmm_bsr_stream(a, tb)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert allclose(got, oracle.spmm_oracle(a, tb.float().numpy()))
    # on the CPU the entry is the plain version itself
    assert torch.equal(bsr_spmm.bsr_spmm_plain(a, tb), got)


def test_stream_counts_only_kernel_launches():
    """The CPU path runs the plain version and does not count; the entry
    refuses a block size K6 does not take and a B of the wrong height."""
    a, _ = pair_of("b8x128_d40")
    before = bsr_spmm.spmm_bsr_stream.launches
    bsr_spmm.spmm_bsr_stream(a, torch.zeros(512, 8))
    assert bsr_spmm.spmm_bsr_stream.launches == before
    with pytest.raises(ValueError, match="not admitted"):
        bsr_spmm.spmm_bsr_stream(pair_of("b4x4_packable")[0],
                                 torch.zeros(256, 8))
    with pytest.raises(ValueError):
        bsr_spmm.spmm_bsr_stream(a, torch.zeros(511, 8))


def test_cuda_launcher_refuses_what_the_kernel_does_not_take():
    """Checked before anything is built: a CPU B; and the geometry the
    planes are laid out for: 128-, 32- or 8-row sub-tiles (wgmma's N) and
    64-column k-steps.  The ring and its shared memory are the source's:
    a launch that does not fit is refused on the card."""
    a, _ = pair_of("b8x128_d40")
    args = [torch.from_numpy(x) for x in
            (a.indptr, a.indices, bsr_spmm.block_row_order(a),
             bsr_spmm.term_planes(a))]
    with pytest.raises(ValueError, match="CUDA"):
        bsr_cuda.block_spmm(*args, torch.zeros(512, 8), 64, a.block_size)
    assert [bsr_cuda.row_tile(bh) for bh in (8, 16, 24, 32, 64, 128, 256,
                                             512)] == [8, 8, 8, 32, 32, 128,
                                                       128, 128]
    assert bsr_cuda.planes_shape(96, 128, 128) == (96, 1, 2, 3, 128, 64)
    assert bsr_cuda.planes_shape(4, 512, 256) == (4, 4, 4, 3, 128, 64)
    assert bsr_cuda.SOURCE.endswith("csrc/bsr_spmm.cu")


def _stream_operand(case):
    a, ja = pair_of(case)
    if not bsr_spmm.mxu_friendly(a.block_size):
        a, ja = bsr_spmm.pack_blocks(a), jk6.pack_blocks(ja)
    return a, ja


def _terms_of_planes(a):
    """The planes unswizzled, as (term, block, bh, bw) float32."""
    planes = bsr_spmm.swizzle128(bsr_spmm.term_planes(a))
    nb, subs, kq, terms, rt, kc = planes.shape
    bits = planes.transpose(3, 0, 1, 4, 2, 5).reshape(
        terms, nb, subs * rt, kq * kc)
    return torch.from_numpy(np.ascontiguousarray(bits)).view(
        torch.bfloat16).float()


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_term_planes_are_split_bf16_terms(case):
    a, _ = _stream_operand(case)
    planes = bsr_spmm.term_planes(a)
    assert planes.dtype == np.int16
    assert planes.shape == bsr_cuda.planes_shape(*a.blocks.shape)
    blocks = torch.from_numpy(a.blocks)
    terms = _terms_of_planes(a)
    for got, want in zip(terms, split_bf16(blocks, 3)):
        assert torch.equal(got, want.float())
    resum = (terms[0].double() + terms[1].double() + terms[2].double())
    err = (resum - blocks.double()).abs()
    assert bool((err <= 2.0 ** -24 * blocks.double().abs()).all())
    # the swizzle puts row r's 16-byte chunk c at chunk c ^ (r % 8), and
    # is its own inverse
    x = np.arange(16 * 64).reshape(16, 64)
    sw = bsr_spmm.swizzle128(x)
    for r, c in ((0, 0), (3, 2), (11, 7), (15, 5)):
        d = c ^ (r % 8)
        assert np.array_equal(sw[r, 8 * d:8 * d + 8], x[r, 8 * c:8 * c + 8])
    assert np.array_equal(bsr_spmm.swizzle128(sw), x)


@pytest.mark.parametrize("counts", [[3, 0, 1, 3, 2, 0, 3],
                                    [0, 0, 0], [5], [1, 2, 3, 4]])
def test_block_row_order_stable_heaviest_first(counts):
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nb = int(indptr[-1])
    a = BSR(indptr=indptr, indices=np.zeros(nb, np.int32),
            blocks=np.zeros((nb, 8, 128), np.float32),
            shape=(8 * len(counts), 128), block_size=(8, 128), nnz=nb * 1024)
    order = bsr_spmm.block_row_order(a)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(len(counts)))
    keyed = [(-counts[r], r) for r in order]
    assert keyed == sorted(keyed)  # most blocks first, ties by index


# K6's limit against its plain version on the card (chip_smoke.K6_TOL):
# f32 sums in another order; the three-product ladder misses it
K6_TOL = 2e-6
LADDERS = {"f32": ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)),
           "bf16": ((0, 0), (1, 0), (2, 0)),
           "f32_products3": ((0, 0), (0, 1), (1, 0))}


def ladder_replay(a, b: torch.Tensor, ladder=None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: per stored block, per
    K_CHUNK-deep step, the step's bf16 products (A term i from the planes,
    B term j: with f32 B (0,0), (0,1), (1,0), (0,2), (1,1), (2,0); with
    bf16 B the three A terms against B), 16 deep each, summed in f32 into
    the step's own sum, which is then added into its block row's sums,
    blocks in stored order."""
    terms = _terms_of_planes(a)
    bh, bw = a.block_size
    b_pad = pad_b(b, round_up(a.shape[1], bw), int(b.shape[1]))
    if b.dtype == torch.float32:
        b_terms = [p.float() for p in split_bf16(b_pad, 3)]
    else:
        b_terms = [b_pad.float()]
    if ladder is None:
        ladder = LADDERS["f32" if b.dtype == torch.float32 else "bf16"]
    rows = np.repeat(np.arange(a.num_block_rows), np.diff(a.indptr))
    kt = torch.from_numpy(a.indices.astype(np.int64))
    panels = [bt.reshape(-1, bw, bt.shape[1])[kt] for bt in b_terms]
    out = torch.zeros(a.num_block_rows, bh, int(b.shape[1]))
    steps = []
    for s0 in range(0, bw, bsr_cuda.K_CHUNK):
        part = torch.zeros(a.nblocks, bh, int(b.shape[1]))
        for k0 in range(s0, s0 + bsr_cuda.K_CHUNK, 16):
            for i, j in ladder:
                part += torch.bmm(terms[i][:, :, k0:k0 + 16],
                                  panels[j][:, k0:k0 + 16])
        steps.append(part)
    for blk in range(a.nblocks):
        for part in steps:
            out[rows[blk]] += part[blk]
    return out.reshape(-1, int(b.shape[1]))[:a.shape[0]]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_ladder_replay_matches_jax_interpret(case, dtype):
    a, ja = _stream_operand(case)
    jb, tb = operand(a.shape[1], 200, 11, dtype)
    ref = np.asarray(jk6.spmm_bsr_stream(ja, jb, interpret=True))
    got = ladder_replay(a, tb)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= K6_TOL * np.abs(ref).max()
    assert allclose(got, oracle.spmm_oracle(a, tb.float().numpy()))


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_three_product_ladder_misses_k6_limit(case):
    """The control of K6's limit: with f32 B, the ladder cut to its three
    largest products, (0,0), (0,1) and (1,0), is further than K6_TOL from
    JAX's result, and the six products are within it."""
    a, ja = _stream_operand(case)
    jb, tb = operand(a.shape[1], 200, 11, jnp.float32)
    ref = np.asarray(jk6.spmm_bsr_stream(ja, jb, interpret=True))
    got = ladder_replay(a, tb, LADDERS["f32_products3"])
    assert np.abs(got.numpy() - ref).max() > K6_TOL * np.abs(ref).max()


def _source_constants() -> dict:
    with open(bsr_cuda.SOURCE) as f:
        text = f.read()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", text)}
    tiles = re.search(r"constexpr int ROW_TILES\[\] = \{([^}]*)\};", text)
    consts["ROW_TILES"] = tuple(int(x) for x in tiles.group(1).split(","))
    return consts


def test_cuda_constants_equal_the_source():
    src = _source_constants()
    assert src["KC"] == bsr_cuda.K_CHUNK
    assert src["TERMS"] == bsr_cuda.TERMS
    assert src["ROW_TILES"] == bsr_cuda.ROW_TILES
    assert src["COLS"] * src["WARPGROUPS"] == bsr_cuda.COLUMN_TILE
    assert src["F32_PRODUCTS"] == len(LADDERS["f32"])  # ladder_replay's


def test_cuda_argtypes_match_the_c_signature():
    with open(bsr_cuda.SOURCE) as f:
        text = f.read()
    sig = re.search(rf"int {bsr_cuda.ENTRY}\(([^)]*)\)", text).group(1)
    want = [ctypes.c_void_p if "void*" in p else ctypes.c_int
            for p in (x.strip() for x in sig.split(","))]
    assert all("void*" in p or p.startswith("int ")
               for p in (x.strip() for x in sig.split(",")))
    lib = types.SimpleNamespace(
        **{bsr_cuda.ENTRY: types.SimpleNamespace(),
           "bsr_spmm_error_string": types.SimpleNamespace()})
    bsr_cuda._bind(lib)
    assert getattr(lib, bsr_cuda.ENTRY).argtypes == want
    assert getattr(lib, bsr_cuda.ENTRY).restype is ctypes.c_int


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_bsr_xla_matches_jax(dtype):
    for case in ("b8x128_d15", "b4x4_packable"):
        a, ja = pair_of(case)
        jb, tb = operand(a.shape[1], 33, 12, dtype)
        ref = np.asarray(jxla.spmm_bsr_xla(ja, jb))
        got = xla.spmm_bsr_xla(a, tb)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        assert torch.equal(xla.spmm_xla(a, tb), got)


@pytest.mark.parametrize("name", ["small_32x32", "medium_4096"])
def test_ell_xla_matches_jax(name):
    d = data_dir(name)
    a, ja = convert.load_sparse(d, "ell"), jconvert.load_sparse(d, "ell")
    for dtype in (jnp.float32, jnp.bfloat16):
        jb, tb = operand(a.shape[1], 24, 13, dtype)
        ref = np.asarray(jxla.spmm_ell_xla(ja, jb))
        got = xla.spmm_ell_xla(a, tb)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        assert torch.equal(xla.spmm_xla(a, tb), got)


def test_ws_constants_equal_the_source():
    """The warp-specialised build's constants: its producer and consumer
    warpgroups and its ring's depth at most; the waves of its launch
    rules are the binding's alone, not the source's; at 128-row sub-tiles
    a ring of two stages (the step's planes and two unpadded 64 x 64 bf16
    B tiles) fits the opt-in shared memory."""
    src = _source_constants()
    for name in ("PRODUCER_WARPGROUPS", "CONSUMER_WARPGROUPS", "WS_STAGES"):
        assert src[name] == getattr(bsr_cuda, name), name
    with open(bsr_cuda.SOURCE) as f:
        text = f.read()
    for name in ("WS_WAVES", "PERSIST_WAVES", "ws_grid", "sm_count"):
        assert name not in text, name
    assert src["COLS"] == bsr_cuda.COLUMN_TILE
    # at least two stages fit at 128-row sub-tiles with two consumers
    stage = (bsr_cuda.TERMS * 128 * bsr_cuda.K_CHUNK * 2
             + bsr_cuda.CONSUMER_WARPGROUPS * bsr_cuda.K_CHUNK
             * bsr_cuda.COLUMN_TILE * 2)
    assert 1024 + 2 * (stage + 16) <= src["SMEM_LIMIT"]


# (B dtype, width, data aligned to 16 bytes): whether the warp-specialised
# build takes it
BUILD_CHOICE = [(torch.bfloat16, 512, True, True),
                (torch.bfloat16, 16, True, True),
                (torch.bfloat16, 200, True, True),
                (torch.bfloat16, 77, True, False),
                (torch.bfloat16, 130, True, False),
                (torch.bfloat16, 512, False, False),
                (torch.float32, 512, True, False),
                (torch.float32, 16, True, False)]


@pytest.mark.parametrize("dtype,n,aligned,ws", BUILD_CHOICE)
def test_build_choice(dtype, n, aligned, ws):
    assert bsr_cuda.warp_specialised(dtype, n, aligned) is ws


# (row sub-tiles, B width, SMs, consumers): the Olmo-Hybrid-7B gate and
# down weights (86 and 30 block rows of 128) at w512, w1024 and w16 on 132
# SMs, and widths at and past one column tile
CONSUMERS = [(86, 512, 132, 2), (30, 512, 132, 1), (86, 1024, 132, 2),
             (30, 1024, 132, 1), (86, 16, 132, 1), (30, 16, 132, 1),
             (86, 64, 132, 1), (264, 65, 132, 2), (263, 65, 132, 1),
             (65, 512, 132, 1), (66, 512, 132, 2), (1, 128, 1, 1)]


@pytest.mark.parametrize("units,n,sms,want", CONSUMERS)
def test_ws_consumers(units, n, sms, want):
    """Two consumers (a 128-column tile) only where B is wider than one
    64-column tile and the wide tiles fill the SMs WS_WAVES times."""
    assert bsr_cuda.ws_consumers(units, n, sms) == want


@pytest.mark.parametrize("nblocks,bh,bw", [(96, 128, 128), (4, 512, 256),
                                           (7, 8, 128), (3, 24, 384),
                                           (0, 32, 128)])
def test_planes_shape_unchanged(nblocks, bh, bw):
    """The term planes the warp-specialised build reads are the register
    builds': (block, sub-tile, k-step, term, sub-tile row, 64 columns)."""
    rt = bsr_cuda.row_tile(bh)
    assert bsr_cuda.planes_shape(nblocks, bh, bw) == (nblocks, bh // rt,
                                                      bw // 64, 3, rt, 64)


@pytest.mark.parametrize("dtype,n,ws", [(torch.bfloat16, 512, True),
                                        (torch.bfloat16, 16, True),
                                        (torch.bfloat16, 77, False),
                                        (torch.float32, 512, False)])
def test_bind_takes_the_build_and_counts_it(dtype, n, ws, monkeypatch):
    """A binding for a B that takes the warp-specialised build records
    that build in its launch shape, with its consumers; f32 and unaligned
    bf16 B record the register build and pass no consumers.  Each launch
    asks for the cp.async staging (b_vec) only where B's rows and data are
    16-byte aligned, and passes the consumers only then.  The card is
    stood in for: B's device check is the only one that needs it."""
    from tpuspmm_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 132)
    a, _ = pair_of("b128x128")
    arrays = [torch.from_numpy(x) for x in
              (a.indptr, a.indices, bsr_spmm.block_row_order(a),
               bsr_spmm.term_planes(a))]
    b = torch.zeros(a.shape[1], n, dtype=dtype)
    launch = bsr_cuda.bind(*arrays, b, a.shape[0], a.block_size)
    assert launch.shape["build"] == ("warp_specialised" if ws
                                     else "register")
    assert (launch.shape["consumers"] > 0) is ws
    names = c_params(bsr_cuda.SOURCE, bsr_cuda.ENTRY)
    got = dict(zip(names, launch.args(4096, 8192, 0)))
    assert got["b_bf16"] == int(dtype == torch.bfloat16)
    assert got["b_vec"] == int(n * b.element_size() % 16 == 0)
    assert got["consumers"] == launch.shape["consumers"]
    # B's data off 16 bytes: the plain-load build, whatever the binding
    off = dict(zip(names, launch.args(4098, 8192, 0)))
    assert off["b_vec"] == 0 and off["consumers"] == 0


# (row sub-tiles, B width, SMs, row tile): DeepSeek-V3's expert gate and
# down (16 and 56 block rows of 128), dense gate and down (144, 56) at
# w4096 and the expert gate at the routed width 3392 (432 tiles, no
# multiple of 132); Olmo-Hybrid-7B's gate and down (86, 30) at w512 and
# w16; 8-row sub-tiles; and grids of a few tiles on 1-2 SMs
SCHEDULES = [(16, 4096, 132, 128), (56, 4096, 132, 128),
             (144, 4096, 132, 128), (16, 3392, 132, 128),
             (86, 512, 132, 128), (30, 512, 132, 128), (86, 16, 132, 128),
             (30, 16, 132, 128), (512, 512, 132, 8), (3, 300, 2, 128),
             (5, 200, 1, 128), (1, 64, 1, 32)]


@pytest.mark.parametrize("units,n,sms,rt", SCHEDULES)
def test_ws_schedule_owns_each_tile_once(units, n, sms, rt):
    """The warp-specialised grid's schedule (the source's ws_grid and
    ws_tile_index): min(tiles, SMs) blocks where it is persistent, else a
    block a tile; every (unit, column tile) owned by one block; a block's
    r-th tile lies in the r-th round of ``grid`` consecutive tiles (units
    in row_order's order, column tile fastest), the c-th of it on even
    rounds and the c-th from its end on odd ones."""
    tiles = bsr_cuda.ws_tiles(units, n, sms)
    grid = bsr_cuda.ws_grid(units, n, sms, rt)
    ncol = -(-n // (bsr_cuda.COLUMN_TILE
                    * bsr_cuda.ws_consumers(units, n, sms)))
    assert tiles == units * ncol
    assert grid in (tiles, min(tiles, sms))
    walks = bsr_cuda.ws_schedule(units, n, sms, rt)
    assert len(walks) == grid
    owned = sorted(t for walk in walks for t in walk)
    assert owned == [divmod(x, ncol) for x in range(tiles)]
    for c, walk in enumerate(walks):
        xs = [u * ncol + col for u, col in walk]
        for r, x in enumerate(xs):
            assert x // grid == r
            assert x % grid == (grid - 1 - c if r % 2 else c)
    if grid == tiles:
        assert walks == [[divmod(c, ncol)] for c in range(tiles)]


# (row sub-tiles, B width, row tile, persistent) on 132 SMs, the cells'
# shapes: every DeepSeek-V3 call of dsv3_ep32_b128.prefill_w4096 (expert
# gate / up, expert down, dense gate / up, dense down) and the expert gate
# at a routed width; Olmo-Hybrid-7B's gate and down at w512 and w16; an
# 8-row sub-tile grid of 2,048 tiles
ENGAGES = [(16, 4096, 128, True), (56, 4096, 128, True),
           (144, 4096, 128, True), (56, 4096, 128, True),
           (16, 3392, 128, True), (86, 512, 128, False),
           (30, 512, 128, False), (86, 16, 128, False),
           (30, 16, 128, False), (512, 512, 8, False)]
ENGAGE_IDS = ["dsv3_gate", "dsv3_down", "dsv3_dense_gate", "dsv3_dense_down",
              "dsv3_gate_w3392", "olmo_gate_w512", "olmo_down_w512",
              "olmo_gate_w16", "olmo_down_w16", "rt8"]


@pytest.mark.parametrize("units,n,rt,want", ENGAGES, ids=ENGAGE_IDS)
def test_persistent_grid_engages_by_shape(units, n, rt, want):
    """The grid is persistent where its 128-row tiles fill 132 SMs
    PERSIST_WAVES times: every DeepSeek-V3 call of the cell, no Olmo call
    and no decode width."""
    grid = bsr_cuda.ws_grid(units, n, 132, rt)
    assert (grid < bsr_cuda.ws_tiles(units, n, 132)) is want
    if want:
        assert grid == 132


@pytest.mark.parametrize("dtype,n,want", [(torch.bfloat16, 4096, 4),
                                          (torch.bfloat16, 3392, 4),
                                          (torch.bfloat16, 16, 0),
                                          (torch.float32, 4096, 0)])
def test_bind_counts_a_persistent_grid(dtype, n, want, monkeypatch):
    """A binding whose warp-specialised grid is persistent records a grid
    below its tiles, so that its busiest block walks several (16 block
    rows of 128 on 132 SMs: 512 tiles at w4096, 432 at w3392, 4 a block at
    most); a w16 binding (16 tiles, a block each) and an f32-B binding
    (no grid) walk none.  The card is stood in for, as above."""
    from tpuspmm_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 132)
    a = BSR.random_blocks(2048, 256, (128, 128), 0.5, 7)
    arrays = [torch.from_numpy(x) for x in
              (a.indptr, a.indices, bsr_spmm.block_row_order(a),
               bsr_spmm.term_planes(a))]
    b = torch.zeros(a.shape[1], n, dtype=dtype)
    shape = bsr_cuda.bind(*arrays, b, a.shape[0], a.block_size).shape
    tiles, grid = shape["tiles"], shape["grid"]
    assert (-(-tiles // grid) if grid < tiles else 0) == want


@pytest.mark.parametrize(
    "units,n,rt,dtype",
    [(u, n, rt, torch.bfloat16) for u, n, rt, _ in ENGAGES]
    + [(16, 4096, 128, torch.float32)], ids=ENGAGE_IDS + ["f32_b"])
def test_bound_launch_passes_its_shape(units, n, rt, dtype, monkeypatch):
    """The arguments a bound K6 launch hands the C entry, captured by a
    stand-in library: the consumers and grid of ``ws_consumers`` and
    ``ws_grid`` (132 SMs) with a bf16 B whose rows are 16-byte aligned,
    as the binding records them; 0 consumers (the register build) with
    f32 B, and at a call whose bf16 B data is not 16-byte aligned.  One
    stored block a block row of ``rt`` rows, ``units`` block rows."""
    from tpuspmm_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "check_b", lambda entry, b: None)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 132)
    arrays = (torch.arange(units + 1, dtype=torch.int32),
              torch.zeros(units, dtype=torch.int32),
              torch.arange(units, dtype=torch.int32),
              torch.zeros(bsr_cuda.planes_shape(units, rt, 128),
                          dtype=torch.int16))
    b = torch.zeros(128, n, dtype=dtype)
    launch = bsr_cuda.bind(*arrays, b, 1, (rt, 128))
    got = launched_args(launch, b, monkeypatch)
    if dtype == torch.float32:
        assert (got["consumers"], launch.shape["build"]) == (0, "register")
        return
    want = (bsr_cuda.ws_consumers(units, n, 132),
            bsr_cuda.ws_grid(units, n, 132, rt))
    assert (got["consumers"], got["grid"]) == want
    assert (launch.shape["consumers"], launch.shape["grid"]) == want
    assert got["b_vec"] == 1 and got["b_bf16"] == 1
    off = torch.zeros(128 * n + 1, dtype=dtype)[1:].view(128, n)
    assert launched_args(launch, off, monkeypatch)["consumers"] == 0
