"""tpuspmm_torch's data tools against the JAX package's ``tpuspmm/tools``.

Each tool writes the same bytes as its JAX counterpart for the same inputs
and seed: ``convert_dir``'s five text formats, both ELL pairs and
``dense.in``; ``gen_dir``'s sweep directories; ``gen_matrix``;
``write_expect``'s ``result.expect``; ``make_data``'s medium_4096
stand-in, against the committed ``data/medium_4096`` files (in a copy
under ``tmp_path``: no test writes ``data/``).  ``fetch_suitesparse`` is
held against a ``.tar.gz`` served from ``tmp_path`` through a
monkeypatched ``urllib.request.urlopen``; no test reaches a network.
"""

import contextlib
import filecmp
import io
import json
import os
import shutil
import tarfile
import urllib.error

import pytest

from tpuspmm.tools import convert_mtx as jconvert_mtx
from tpuspmm.tools import gen_matrix as jgen_matrix
from tpuspmm.tools import gen_sparse as jgen_sparse
from tpuspmm.tools import make_data as jmake_data
from tpuspmm.tools import validate as jvalidate
from tpuspmm_torch.data import data_dir
from tpuspmm_torch.tools import (convert_mtx, fetch_suitesparse, gen_matrix,
                                 gen_sparse, make_data, validate)

MTX_DIRS = ["small_10x10", "small_32x32", "small_210", "medium_2048"]


def same_files(a: str, b: str) -> list:
    """The names of two directories' files, asserted equal in name and
    bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    return names


def mtx_copies(tmp_path, name):
    """Two directories holding only ``name``'s .mtx files."""
    out = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        src = data_dir(name)
        for f in os.listdir(src):
            if f.endswith(".mtx"):
                shutil.copy(os.path.join(src, f), d)
        out.append(str(d))
    return out


@pytest.mark.parametrize("name", MTX_DIRS)
def test_convert_dir_bytes_equal_jax(tmp_path, name):
    jdir, tdir = mtx_copies(tmp_path, name)
    theirs = jconvert_mtx.convert_dir(jdir)
    mine = convert_mtx.convert_dir(tdir)
    assert [os.path.basename(p) for p in mine] == \
        [os.path.basename(p) for p in theirs]
    names = same_files(jdir, tdir)
    assert any(n.endswith("_colind.ell") for n in names)


def test_convert_cli_block_size_and_formats(tmp_path):
    jdir, tdir = mtx_copies(tmp_path, "small_210")
    argv = ["--block-size", "3", "--formats", "bsr,ell"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jconvert_mtx.main([jdir, *argv]) == 0
        assert convert_mtx.main([tdir, *argv]) == 0
    assert not any(n.endswith(".csr") for n in same_files(jdir, tdir))
    assert convert_mtx.main([str(tmp_path / "missing")]) == 2


@pytest.mark.parametrize("density", [0.1, 0.5])
def test_gen_dir_bytes_equal_jax(tmp_path, density):
    theirs = jgen_sparse.gen_dir(str(tmp_path / "jax"), density, 64, 48, 16,
                                 seed=3)
    mine = gen_sparse.gen_dir(str(tmp_path / "port"), density, 64, 48, 16,
                              seed=3)
    assert os.path.basename(mine) == os.path.basename(theirs) == \
        f"sp_{density:g}_64x48"
    same_files(theirs, mine)


def test_gen_matrix_bytes_equal_jax(tmp_path):
    argv = ["20", "7", "--seed", "5", "--lo", "-3", "--hi", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        jgen_matrix.main([str(tmp_path / "j.in"), *argv])
        gen_matrix.main([str(tmp_path / "t.in"), *argv])
    assert filecmp.cmp(tmp_path / "j.in", tmp_path / "t.in", shallow=False)


@pytest.mark.parametrize("name", ["small_10x10", "small_32x32",
                                  "small_210"])
def test_write_expect_bytes_equal_jax(tmp_path, name):
    d = tmp_path / name
    shutil.copytree(data_dir(name), d)
    (d / "result.expect").unlink(missing_ok=True)
    theirs = jvalidate.write_expect(str(d), jvalidate.compute_expect(str(d)))
    with open(theirs, "rb") as f:
        ref = f.read()
    mine = validate.write_expect(str(d), validate.compute_expect(str(d)))
    with open(mine, "rb") as f:
        assert f.read() == ref


def test_validate_dir_matches_jax(tmp_path):
    """The reference's committed .out files pass in both; a broken one
    fails in both, with the same report."""
    d = tmp_path / "small_10x10"
    shutil.copytree(data_dir("small_10x10"), d)
    with open(d / "coo.out") as f:
        lines = f.read().splitlines()
    lines[0] = " ".join("999" for _ in lines[0].split())
    (d / "bad.out").write_text("\n".join(lines) + "\n")
    outs = []
    for fn in (jvalidate.validate_dir, validate.validate_dir):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            failures = fn(str(d))
        outs.append((failures, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0] == 1 and "FAIL" in outs[1][1]
    with contextlib.redirect_stdout(io.StringIO()):
        assert validate.main([str(d)]) == 1


def test_make_data_medium_4096_stand_in_bytes_equal_committed(tmp_path):
    """medium_4096's stand-in regenerated with seed 4096 in a copy equals
    the committed files and GENERATED.json byte for byte."""
    committed = data_dir("medium_4096")
    with open(os.path.join(committed, "GENERATED.json")) as f:
        names = json.load(f)["files"] + ["GENERATED.json"]
    with contextlib.redirect_stdout(io.StringIO()):
        make_data.regen_medium_4096(str(tmp_path))
    d = tmp_path / "medium_4096"
    assert sorted(os.listdir(d)) == sorted(names)
    for name in names:
        assert filecmp.cmp(d / name, os.path.join(committed, name),
                           shallow=False), name
    # present already: nothing is rewritten
    stamp = os.path.getmtime(d / "GENERATED.json")
    make_data.regen_medium_4096(str(tmp_path))
    assert os.path.getmtime(d / "GENERATED.json") == stamp


def test_make_data_goldens_and_verify_match_jax(tmp_path):
    """On a copy of two dirs: the same goldens and the same report as the
    JAX tool, through ``main``."""
    roots = []
    for side in ("jax", "port"):
        root = tmp_path / side
        for name in ("small_10x10", "small_210"):
            shutil.copytree(data_dir(name), root / name)
            (root / name / "result.expect").unlink(missing_ok=True)
        (root / "medium_4096").mkdir()
        roots.append(root)
    outs = []
    for fn, root in ((jmake_data, roots[0]), (make_data, roots[1])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            status = fn.main(["--data-root", str(root)])
        outs.append((status, buf.getvalue().replace(str(root), "ROOT")))
    assert outs[0] == outs[1] and outs[1][0] == 0
    for name in ("small_10x10", "small_210", "medium_4096"):
        same_files(roots[0] / name, roots[1] / name)


def _tarball(tmp_path) -> bytes:
    src = tmp_path / "src"
    src.mkdir()
    (src / "Tiny.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n2 2 2\n"
        "1 1 1.5\n2 2 -2\n")
    (src / "README.txt").write_text("not a matrix\n")
    tar = tmp_path / "Tiny.tar.gz"
    with tarfile.open(tar, "w:gz") as t:
        t.add(src / "Tiny.mtx", arcname="Tiny/Tiny.mtx")
        t.add(src / "README.txt", arcname="Tiny/README.txt")
    return tar.read_bytes()


def test_fetch_suitesparse_from_a_local_stub(tmp_path, monkeypatch):
    """The mirror fails, the second source serves the archive: its .mtx
    lands in the out dir (no path inside the archive kept) and converts."""
    payload = _tarball(tmp_path)
    asked = []

    def urlopen(url, timeout=None):
        asked.append(url)
        if url.startswith(fetch_suitesparse.MIRROR_URL):
            raise urllib.error.URLError("no route")
        return io.BytesIO(payload)

    monkeypatch.setattr(fetch_suitesparse.urllib.request, "urlopen",
                        urlopen)
    out = tmp_path / "out"
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        status = fetch_suitesparse.main(["Group/Tiny", "-o", str(out),
                                         "--convert"])
    assert status == 0
    assert asked == [f"{fetch_suitesparse.MIRROR_URL}/Group/Tiny.tar.gz",
                     f"{fetch_suitesparse.BASE_URL}/Group/Tiny.tar.gz"]
    assert "Tiny.mtx" in os.listdir(out)
    assert "README.txt" not in os.listdir(out)
    assert (out / "Tiny.csr").read_text().startswith("2 2 2\n")
    assert str(out) in buf.getvalue()


def test_fetch_suitesparse_offline_exits_3(tmp_path, monkeypatch):
    def urlopen(url, timeout=None):
        raise urllib.error.URLError("offline")

    monkeypatch.setattr(fetch_suitesparse.urllib.request, "urlopen",
                        urlopen)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        assert fetch_suitesparse.main(["G/N", "-o", str(tmp_path)]) == 3
    assert "could not fetch G/N" in err.getvalue()
