"""K6, the block-streaming BSR kernel: tpuspmm_torch against tpuspmm.

- ``prep_bsr`` equals JAX's ``_prep_bsr`` (empty block rows included),
  ``pack_blocks`` equals JAX's and is None in the same cases,
  ``mxu_friendly`` agrees.
- ``spmm_bsr_stream`` (the plain version on the CPU) matches JAX's
  ``spmm_bsr_stream`` in Pallas interpret mode, in f32 and bf16 B, within
  1e-5·max|C| (both are f32 sums, in another order), and the oracle at the
  gate.
- The gather paths ``spmm_bsr_xla`` and ``spmm_ell_xla`` match JAX's.
- The wrapper takes the plain version only for a CPU tensor; the CUDA
  launcher refuses a CPU tensor and what the kernel does not take.
"""

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
from tpuspmm_torch.ops import oracle, xla
from tpuspmm_torch.utils.compare import allclose

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
    """Checked before anything is built: a CPU B, a wrong dtype, a block
    shape outside bh % 8 / bw % 32."""
    a, _ = pair_of("b8x128_d40")
    args = [torch.from_numpy(x) for x in (a.indptr, a.indices, a.blocks)]
    with pytest.raises(ValueError, match="CUDA"):
        bsr_cuda.block_spmm(*args, torch.zeros(512, 8), 64)
    assert bsr_cuda.row_tile(128) == 32 and bsr_cuda.row_tile(8) == 8
    assert bsr_cuda.row_tile(24) == 8
    assert bsr_cuda.smem_bytes(128) == (32 * 33 + 32 * 64) * 4 < 48 * 1024
    assert bsr_cuda.SOURCE.endswith("csrc/bsr_spmm.cu")


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
