"""tpuspmm_torch's containers, readers, loaders and oracle against
tpuspmm's, on every corpus directory."""

import os

import numpy as np
import pytest
import scipy.sparse

from tpuspmm.formats import convert as jconvert
from tpuspmm.formats import io as jio
from tpuspmm.ops import oracle as joracle
from tpuspmm_torch.data import data_dir, data_roots
from tpuspmm_torch.formats import COO, CSR, convert
from tpuspmm_torch.formats import io as tio
from tpuspmm_torch.ops import oracle

DIRS = sorted(d for d in os.listdir(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"))
    if not d.endswith(".md"))
# on-disk dense operands too large to densify in a unit test (20000² and
# 15120×12600): their MatrixMarket triplets are compared instead
LARGE_DENSE = {"large_15120", "large_20000"}


def test_corpus_resolves():
    assert data_roots()
    assert all(data_dir(d) for d in DIRS) and len(DIRS) == 12


@pytest.mark.parametrize("name", DIRS)
def test_load_sparse_csr_matches(name):
    ref = jconvert.load_sparse(data_dir(name), "csr")
    got = convert.load_sparse(data_dir(name), "csr")
    assert isinstance(got, CSR) and got.shape == ref.shape
    for f in ("indptr", "indices", "values"):
        x, y = getattr(got, f), np.asarray(getattr(ref, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("name", DIRS)
def test_load_dense_matches(name):
    d = data_dir(name)
    if name in LARGE_DENSE:
        path = convert.discover(d)["dense_mtx"]
        ref, got = jio.read_mtx(path), tio.read_mtx(path)
        assert got.shape == ref.shape
        ref, got = ref.tocsr(), got.tocsr()
        assert (ref != got).nnz == 0
        return
    ref = jconvert.load_dense(d, width=256)
    got = convert.load_dense(d, width=256)
    assert got.b_source == ref.b_source
    assert got.data.dtype == np.float32
    assert got.data.tobytes() == np.asarray(ref.data).tobytes()


def test_synthesized_b_is_byte_identical():
    d = data_dir("large_25605")
    for width, seed in [(256, 0), (128, 3)]:
        ref = jconvert.load_dense(d, width=width, seed=seed)
        got = convert.load_dense(d, width=width, seed=seed)
        assert got.b_source == "synth" and got.shape == (25605, width)
        assert got.data.tobytes() == np.asarray(ref.data).tobytes()
    forced = convert.load_dense(data_dir("medium_2048"), width=64,
                                force_synthetic=True)
    assert forced.b_source == "synth" and forced.shape == (2048, 64)


@pytest.mark.parametrize("name", ["small_10x10", "small_32x32"])
def test_text_formats_match(name):
    """The reference's .csr / .coo / dense.in text readers."""
    d = data_dir(name)
    found = convert.discover(d)
    assert found == jconvert.discover(d)
    ref = jconvert.load_sparse(d, "coo")
    got = convert.load_sparse(d, "coo")
    assert isinstance(got, COO)
    for f in ("rows", "cols", "values"):
        assert getattr(got, f).tobytes() == np.asarray(
            getattr(ref, f)).tobytes()
    assert got.row_sorted == ref.row_sorted
    assert tio.read_dense_text(found["dense"]).tobytes() == \
        jio.read_dense_text(found["dense"]).tobytes()


@pytest.mark.parametrize("name", ["small_210", "medium_2048", "large_25605"])
def test_conversions_match(name):
    ref = jconvert.load_sparse(data_dir(name), "csr")
    got = convert.load_sparse(data_dir(name), "csr")
    rc, gc = ref.to_coo(), got.to_coo()
    for f in ("rows", "cols", "values"):
        assert getattr(gc, f).tobytes() == np.asarray(getattr(rc, f)).tobytes()
    shuffled = np.random.default_rng(0).permutation(gc.nnz)
    j = type(rc)(rows=rc.rows[shuffled], cols=rc.cols[shuffled],
                 values=rc.values[shuffled], shape=rc.shape).sort_by_row()
    t = COO(rows=gc.rows[shuffled], cols=gc.cols[shuffled],
            values=gc.values[shuffled], shape=gc.shape).sort_by_row()
    assert t.rows.tobytes() == j.rows.tobytes()
    assert t.cols.tobytes() == j.cols.tobytes()
    assert (got.to_scipy() != ref.to_scipy()).nnz == 0
    back = convert.to_format(gc, "csr")
    assert back.indptr.tobytes() == got.indptr.tobytes()


@pytest.mark.parametrize("name", ["small_10x10", "small_32x32", "small_210",
                                  "medium_2048", "medium_2880"])
def test_oracle_matches(name):
    d = data_dir(name)
    jb = jconvert.load_dense(d, width=256)
    b = convert.load_dense(d, width=256).data
    ja, ta = jconvert.load_sparse(d, "csr"), convert.load_sparse(d, "csr")
    for ref, got in [
            (joracle.spmm_oracle(ja, jb.data), oracle.spmm_oracle(ta, b)),
            (joracle.spmm_oracle(ja.to_coo(), jb.data),
             oracle.spmm_oracle(ta.to_coo(), b)),
            (joracle.spmm_scipy_oracle(ja, jb.data),
             oracle.spmm_scipy_oracle(ta, b))]:
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(got.astype(np.float64) - ref).max() <= 1e-12 * scale


def test_coo_duplicates_accumulate_in_oracle():
    rows = np.array([0, 0, 1], np.int32)
    cols = np.array([1, 1, 0], np.int32)
    a = COO(rows=rows, cols=cols, values=np.array([1, 2, 3], np.float32),
            shape=(2, 2))
    b = np.eye(2, dtype=np.float32)
    np.testing.assert_array_equal(oracle.spmm_oracle(a, b), [[0, 3], [3, 0]])
    sp = a.to_csr().to_scipy()
    assert isinstance(sp, scipy.sparse.csr_matrix) and sp.nnz == 2
