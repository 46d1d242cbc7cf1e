"""tpuspmm_torch's BSR, ELL and CSC containers, readers, writers and
conversions against tpuspmm's on the same files and seeded inputs: arrays
identical, written files byte-identical, the f64 oracles equal."""

import os

import numpy as np
import pytest
import scipy.sparse

import tpuspmm.formats as jformats
from tpuspmm.formats import convert as jconvert
from tpuspmm.formats import io as jio
from tpuspmm.ops import oracle as joracle
from tpuspmm.ops import xla as jxla
from tpuspmm_torch import interop
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.formats import BSR, CSC, ELL, convert
from tpuspmm_torch.formats import io as fio
from tpuspmm_torch.ops import oracle
from tpuspmm_torch.ops.xla import coo_view

FIELDS = {"bsr": ("indptr", "indices", "blocks", "shape", "block_size",
                  "nnz"),
          "ell": ("rowind", "values", "shape", "nnz", "max_col_nnz"),
          "csr": ("indptr", "indices", "values", "shape"),
          "csc": ("indptr", "indices", "values", "shape"),
          "coo": ("rows", "cols", "values", "shape")}


def assert_same(mine, theirs, fmt):
    for f in FIELDS[fmt]:
        x, y = getattr(mine, f), getattr(theirs, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
        else:
            assert tuple(x) == tuple(y) if isinstance(x, tuple) else x == y, f


@pytest.mark.parametrize("name,fmt", [
    ("medium_4096", "bsr"), ("medium_4096", "ell"),
    ("small_32x32", "bsr"), ("small_32x32", "ell"),
    ("large_25605", "bsr"), ("small_32x32", "csc")])
def test_readers_match_jax(name, fmt):
    """medium_4096 from its `.bsr` and `.ell` files, small_32x32 and
    large_25605 through `.mtx` (large_25605's odd column count gives (4, 1)
    blocks), small_32x32's `.csc`."""
    d = data_dir(name)
    mine, theirs = convert.load_sparse(d, fmt), jconvert.load_sparse(d, fmt)
    assert_same(mine, theirs, fmt)
    assert mine.sparsity == theirs.sparsity
    if name == "large_25605":
        assert mine.block_size == (4, 1)
    if name == "medium_4096" and fmt == "bsr":
        assert (mine.block_size, mine.nblocks, mine.nnz) == \
            ((4, 4), 12197, 195152)


@pytest.mark.parametrize("args", [
    (64, 512, (8, 128), 0.4, 0), (4096, 4096, (128, 128), 0.1, 0),
    (256, 256, (4, 4), 0.3, 5), (32, 256, (8, 128), 0.0, 2)])
def test_random_blocks_match_jax(args):
    assert_same(BSR.random_blocks(*args), jformats.BSR.random_blocks(*args),
                "bsr")


def test_bsr_coo_view_keeps_explicit_zeros():
    """A 2 × 2 block with one non-zero stores four entries: the COO view
    keeps all four, equal to JAX's ``a.to_csr().to_coo()``."""
    dense = np.zeros((4, 4), np.float32)
    dense[0, 1] = 3.0
    dense[2:, 2:] = [[1.0, 0.0], [0.0, 2.0]]
    mine = BSR.from_dense(dense, (2, 2))
    theirs = jformats.BSR.from_dense(dense, (2, 2))
    assert (mine.nblocks, mine.nnz) == (2, 8)
    coo = mine.to_coo()
    assert coo.nnz == 8
    assert_same(coo, theirs.to_csr().to_coo(), "coo")
    assert_same(coo_view(mine), jxla.coo_view(theirs), "coo")
    np.testing.assert_array_equal(mine.to_dense(), dense)


@pytest.mark.parametrize("name", ["small_32x32", "medium_4096"])
def test_ell_views_match_jax(name):
    d = data_dir(name)
    mine, theirs = convert.load_sparse(d, "ell"), jconvert.load_sparse(d,
                                                                       "ell")
    assert_same(mine.to_coo(), theirs.to_coo(), "coo")
    np.testing.assert_array_equal(mine.to_dense(), theirs.to_dense())
    np.testing.assert_array_equal(mine.to_scipy().toarray(),
                                  theirs.to_scipy().toarray())


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "bsr", "ell"])
def test_to_format_matches_jax(fmt):
    sp = scipy.sparse.random(48, 40, density=0.1, format="csr",
                             random_state=np.random.default_rng(3))
    for src in (sp, sp.toarray()):
        assert_same(convert.to_format(src, fmt, block_size=(8, 8)),
                    jconvert.to_format(src, fmt, block_size=(8, 8)), fmt)
    bsr = convert.to_format(sp, "bsr", block_size=(8, 8))
    jbsr = jconvert.to_format(sp, "bsr", block_size=(8, 8))
    assert_same(convert.to_format(bsr, fmt), jconvert.to_format(jbsr, fmt),
                fmt)
    with pytest.raises(ValueError):
        convert.to_format(sp, "dia")


def _read_all(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_write_all_formats_byte_identical(tmp_path):
    a = convert.load_sparse(data_dir("small_32x32"), "coo")
    ja = jconvert.load_sparse(data_dir("small_32x32"), "coo")
    for bs in (4, 3):
        mine, theirs = tmp_path / f"mine{bs}", tmp_path / f"theirs{bs}"
        mine.mkdir()
        theirs.mkdir()
        written = convert.write_all_formats(a, str(mine), "m", block_size=bs)
        jconvert.write_all_formats(ja, str(theirs), "m", block_size=bs)
        assert sorted(os.path.basename(p) for p in written) == \
            sorted(os.listdir(mine))
        assert _read_all(mine) == _read_all(theirs)
        for fmt in ("csr", "coo", "bsr", "ell"):
            assert_same(convert.load_sparse(str(mine), fmt),
                        jconvert.load_sparse(str(theirs), fmt), fmt)


def test_writers_round_trip_and_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    bsr = BSR.random_blocks(32, 48, (8, 16), 0.3, seed=6)
    bsr.save(str(tmp_path / "a.bsr"))
    assert_same(BSR.from_file(str(tmp_path / "a.bsr")), bsr, "bsr")
    ell = ELL.from_scipy(scipy.sparse.random(30, 20, density=0.2,
                                             random_state=rng))
    ell.save(str(tmp_path / "a_rowind.ell"),
             str(tmp_path / "a_values_colmajor.ell"))
    assert_same(ELL.from_file(str(tmp_path / "a_rowind.ell"),
                              str(tmp_path / "a_values_colmajor.ell")),
                ell, "ell")
    csc = CSC.from_scipy(ell.to_scipy())
    csc.save(str(tmp_path / "a.csc"))
    assert_same(CSC.from_file(str(tmp_path / "a.csc")), csc, "csc")
    dense = rng.uniform(-1, 1, (7, 5)).astype(np.float32)
    dense[0, 0] = 0.0
    fio.write_dense_text(str(tmp_path / "m.in"), dense)
    jio.write_dense_text(str(tmp_path / "j.in"), dense)
    np.testing.assert_array_equal(fio.read_dense_text(str(tmp_path /
                                                          "m.in")), dense)
    colind = rng.integers(-1, 5, (7, 3)).astype(np.int32)
    vals = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    fio.write_ell_rowmajor_text(str(tmp_path / "m_colind.ell"),
                                str(tmp_path / "m_values.ell"), (7, 5), 12,
                                3, colind, vals)
    jio.write_ell_rowmajor_text(str(tmp_path / "j_colind.ell"),
                                str(tmp_path / "j_values.ell"), (7, 5), 12,
                                3, colind, vals)
    for name in ("%s.in", "%s_colind.ell", "%s_values.ell"):
        assert (tmp_path / (name % "m")).read_bytes() == \
            (tmp_path / (name % "j")).read_bytes()


def test_interop_containers_take_jax_arrays():
    jb = jformats.BSR.random_blocks(64, 256, (8, 128), 0.4, seed=1)
    b = interop.bsr_from_arrays(jb.indptr, jb.indices, jb.blocks, jb.shape,
                                jb.block_size, jb.nnz)
    assert_same(b, jb, "bsr")
    je = jconvert.load_sparse(data_dir("small_32x32"), "ell")
    assert_same(interop.ell_from_arrays(je.rowind, je.values, je.shape,
                                        je.nnz, je.max_col_nnz), je, "ell")
    jc = jconvert.load_sparse(data_dir("small_32x32"), "csc")
    assert_same(interop.csc_from_arrays(jc.indptr, jc.indices, jc.values,
                                        jc.shape), jc, "csc")


@pytest.mark.parametrize("fmt", ["bsr", "ell", "csc"])
def test_oracles_match_jax(fmt):
    d = data_dir("small_32x32")
    mine, theirs = convert.load_sparse(d, fmt), jconvert.load_sparse(d, fmt)
    b = np.random.default_rng(7).uniform(-1, 1, (mine.shape[1], 9)).astype(
        np.float32)
    np.testing.assert_array_equal(oracle.spmm_oracle(mine, b),
                                  joracle.spmm_oracle(theirs, b))
    jb = jformats.BSR.random_blocks(64, 256, (8, 128), 0.3, seed=2)
    b2 = np.random.default_rng(8).uniform(-1, 1, (256, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        oracle.spmm_oracle(BSR.random_blocks(64, 256, (8, 128), 0.3,
                                             seed=2), b2),
        joracle.spmm_oracle(jb, b2))
