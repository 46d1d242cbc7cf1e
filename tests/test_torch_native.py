"""tpuspmm_torch's host libraries (``tpuspmm_torch/native``) against numpy,
scipy and the JAX package's native layer.

- The token stream and MatrixMarket triplets equal numpy's and scipy's
  bit for bit (float64 bits, index arrays, order), and the JAX package's
  ``tpuspmm.native.fastio``, for general, symmetric, pattern and integer
  files and every corpus ``.mtx``; the text readers give the same arrays
  through the library as through numpy.
- The tile-plan builder's arrays equal the port's numpy path and the JAX
  package's ``build_tile_plan``, bit for bit, on matrices of 200,000
  nonzeros and more (where ``build_tile_plan`` takes it) and on the JAX
  test's small cases.
- A library that does not build leaves the numpy path serving, counted in
  ``native.plan_builds``; the build is tried once a process; a library
  that does not load is built again; the flags hold no ``-march``.
Skipped where no g++ exists, as ``tests/test_native.py`` is.
"""

import os
import shutil

import numpy as np
import pytest
import scipy.io
import scipy.sparse

from tpuspmm.formats import tiles as jtiles
from tpuspmm.native import fastio as jfastio
from tpuspmm_torch import native
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.formats import io as fio
from tpuspmm_torch.formats import tiles
from tpuspmm_torch.kernels import cuda_build
from tpuspmm_torch.native import fastio, tileplan
from tpuspmm_torch.native.library import NativeLibrary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRS = sorted(d for d in os.listdir(os.path.join(REPO, "data"))
              if os.path.isdir(os.path.join(REPO, "data", d)))
PLAN_FIELDS = ("rt", "kt", "first", "rows", "cols", "vals")


@pytest.fixture(autouse=True)
def _toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")


def bits_equal(x, y) -> bool:
    x, y = np.asarray(x), np.asarray(y)
    return (x.dtype == y.dtype and x.shape == y.shape
            and x.tobytes() == y.tobytes())


@pytest.mark.parametrize("body", [
    "header to skip\n1 2 3\n4.5 -6e3\n7\n",
    "h\n0.1 0.2 0.3 1e-7 -3.4028235e38 123456789.123456789\n"
    "2.2250738585072014e-308 1e400 -inf 5e-324 0.30000000000000004\n",
])
def test_tokens_bit_equal_numpy_and_jax(tmp_path, body):
    path = str(tmp_path / "body.txt")
    with open(path, "w") as f:
        f.write(body)
    with open(path) as f:
        f.readline()
        ref = np.array(f.read().split(), dtype=np.float64)
    got = fastio.parse_tokens(path, 1)
    assert bits_equal(got, ref)
    assert bits_equal(got, jfastio.parse_tokens(path, 1))
    with open(path, "w") as f:
        f.write(body.split("\n", 1)[1])
    assert bits_equal(fastio.parse_tokens(path, 0), ref)


def test_tokens_of_an_empty_body(tmp_path):
    path = str(tmp_path / "empty.txt")
    with open(path, "w") as f:
        f.write("1 2 3\n")
    got = fastio.parse_tokens(path, 1)
    assert got.dtype == np.float64 and got.shape == (0,)


def _mtx(tmp_path, kind):
    rng = np.random.default_rng(1)
    path = str(tmp_path / f"{kind}.mtx")
    if kind == "pattern":
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate pattern general\n"
                    "% comment\n3 4 3\n1 1\n3 4\n2 2\n")
        return path
    a = scipy.sparse.random(40, 40 if kind == "symmetric" else 30,
                            density=0.2, format="coo", random_state=rng)
    if kind == "symmetric":
        scipy.io.mmwrite(path, (a + a.T).tocoo(), symmetry="symmetric")
    elif kind == "integer":
        a.data = np.round(a.data * 1000)
        scipy.io.mmwrite(path, a.astype(np.int64), field="integer")
    else:
        scipy.io.mmwrite(path, a, precision=17)
    return path


def _same_triplets(path) -> None:
    ref = scipy.io.mmread(path)
    shape, r, c, v = fastio.read_mtx_triplets(path)
    assert shape == ref.shape
    assert bits_equal(r, ref.row.astype(np.int32))
    assert bits_equal(c, ref.col.astype(np.int32))
    assert bits_equal(v, ref.data.astype(np.float64))
    jshape, jr, jc, jv = jfastio.read_mtx_triplets(path)
    assert jshape == shape
    for mine, theirs in ((r, jr), (c, jc), (v, jv)):
        assert bits_equal(mine, theirs)


@pytest.mark.parametrize("kind", ["general", "symmetric", "pattern",
                                  "integer"])
def test_mtx_triplets_bit_equal_scipy_and_jax(tmp_path, kind):
    _same_triplets(_mtx(tmp_path, kind))


@pytest.mark.parametrize("name", DIRS)
def test_corpus_mtx_bit_equal_scipy(name):
    """Every .mtx of the corpus, the dense operands' included, and
    ``io.read_mtx`` equal to ``scipy.io.mmread``."""
    d = data_dir(name)
    files = sorted(f for f in os.listdir(d) if f.endswith(".mtx"))
    assert files
    for f in files:
        path = os.path.join(d, f)
        _same_triplets(path)
        mine, ref = fio.read_mtx(path), scipy.io.mmread(path)
        assert (mine != ref).nnz == 0 and mine.shape == ref.shape


def test_array_and_complex_mtx_go_to_scipy(tmp_path):
    dense = str(tmp_path / "dense.mtx")
    scipy.io.mmwrite(dense, np.arange(6.0).reshape(2, 3))
    cplx = str(tmp_path / "complex.mtx")
    scipy.io.mmwrite(cplx, scipy.sparse.coo_matrix(
        np.array([[1 + 2j, 0], [0, 3 - 1j]])))
    for path in (dense, cplx):
        with pytest.raises(native.NativeUnavailable):
            fastio.read_mtx_triplets(path)
    np.testing.assert_array_equal(fio.read_mtx(dense),
                                  np.arange(6.0).reshape(2, 3))
    assert fio.read_mtx(cplx).dtype == np.complex128


@pytest.mark.parametrize("name", ["small_10x10", "small_210",
                                  "medium_4096"])
def test_text_readers_equal_through_numpy(name, monkeypatch):
    """The text readers give the same arrays through the library as
    through numpy."""
    from tpuspmm_torch.formats import convert

    def readers():
        out = [convert.load_sparse(data_dir(name), fmt)
               for fmt in ("csr", "coo", "bsr", "ell")]
        out.append(convert.load_dense(data_dir(name)))
        return out

    natively = readers()

    def refuse(*args):
        raise native.NativeUnavailable("refused")

    monkeypatch.setattr(fastio, "parse_tokens", refuse)
    monkeypatch.setattr(fastio, "read_mtx_triplets", refuse)
    for a, b in zip(natively, readers()):
        for field in ("indptr", "indices", "values", "rows", "cols",
                      "blocks", "rowind", "data"):
            if hasattr(a, field):
                assert bits_equal(getattr(a, field), getattr(b, field))


def _triplets(m, k, density, seed):
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="coo",
                             random_state=rng,
                             data_rvs=lambda n: rng.uniform(-5, 5, n))
    return sp.row, sp.col, sp.data


@pytest.mark.parametrize("case", [
    (1000, 1000, 0.25, 128, 128, 128),   # 250,000 nonzeros: the cut-off
    (1500, 900, 0.2, 64, 256, 64),
    (300, 511, 0.05, 128, 128, 128),
    (513, 129, 0.0, 128, 128, 128),      # no nonzero
    (900, 100, 0.003, 64, 128, 64),      # row tiles with no nonzero
])
def test_tile_plan_bit_equal_numpy_and_jax(case, monkeypatch):
    m, k, density, tm, tk, e = case
    r, c, v = _triplets(m, k, density, seed=m + k)
    got = tileplan.build_tile_plan_arrays(r, c, v, (m, k), tm, tk, e)
    if len(r) >= tiles.NATIVE_MIN_NNZ:
        before = dict(native.plan_builds)
        plan = tiles.build_tile_plan(r, c, v, (m, k), tm, tk, e)
        assert native.plan_builds["native"] == before["native"] + 1
        for name, x in zip(PLAN_FIELDS, got):
            assert bits_equal(getattr(plan, name), x), name
    monkeypatch.setattr(tiles, "NATIVE_MIN_NNZ", len(r) + 1)
    ref = tiles.build_tile_plan(r, c, v, (m, k), tm, tk, e)
    theirs = jtiles.build_tile_plan(r, c, v, (m, k), tile_m=tm, tile_k=tk,
                                    chunk=e)
    for name, x in zip(PLAN_FIELDS, got):
        assert bits_equal(getattr(ref, name), x), name
        assert bits_equal(getattr(theirs, name), x), name


def test_tile_plan_refuses_indices_outside_the_shape():
    with pytest.raises(ValueError):
        tileplan.build_tile_plan_arrays([0, 5], [0, 1], [1.0, 2.0], (5, 5),
                                        128, 128, 128)


def test_failed_build_falls_back_to_numpy_counted(tmp_path, monkeypatch):
    """No compiler: the numpy path builds the plan, counted; the compiler
    runs once a process; ``available()`` says so."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    broken = NativeLibrary("tileplan.cpp", tileplan._bind)
    runs = []

    def compiler():
        runs.append(1)
        return str(tmp_path / "no-such-compiler")

    broken.compiler = compiler
    monkeypatch.setattr(tileplan, "LIBRARY", broken)
    assert not native.available()
    r, c, v = _triplets(800, 800, 0.32, seed=4)
    assert len(r) >= tiles.NATIVE_MIN_NNZ
    before = dict(native.plan_builds)
    plan = tiles.build_tile_plan(r, c, v, (800, 800))
    assert native.plan_builds == dict(before, numpy=before["numpy"] + 1)
    assert len(runs) == 1 and "no-such-compiler" in broken.error
    theirs = jtiles.build_tile_plan(r, c, v, (800, 800))
    for name in PLAN_FIELDS:
        assert bits_equal(getattr(plan, name), getattr(theirs, name))


def test_unloadable_library_is_built_again(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    lib = NativeLibrary("fastio.cpp", fastio._bind)
    with open(lib.library_path(), "w") as f:
        f.write("not a shared library")
    assert lib.available()
    assert lib.load().tokenize_file is not None


def test_flags_and_name():
    """No -march: build/ travels to other hosts; the name covers the
    flags and the port's own sources (never the JAX package's)."""
    lib = fastio.LIBRARY
    assert not any(f.startswith("-march") for f in lib.flags)
    assert lib.compiler() == "g++"
    assert lib.sources() == [os.path.join(REPO, "tpuspmm_torch", "native",
                                          "fastio.cpp")]
    base = lib.library_path()
    assert os.path.dirname(base) == cuda_build.BUILD_DIR
    other = NativeLibrary("fastio.cpp", fastio._bind)
    other.flags = lib.flags + ["-g"]
    assert other.library_path() != base
