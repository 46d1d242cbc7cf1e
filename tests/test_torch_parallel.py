"""tpuspmm_torch.parallel against tpuspmm.parallel on the same inputs.

The port runs WORLD = 4 gloo ranks on the CPU (``torch_parallel_worker.py``,
which imports only the port), one world for the whole module on a file
store under the module's temporary directory: a 1-D mesh of 4 ("rows"),
and 2 x 2 ("rows", "cols") for ``spmm_2d``, the ring's ``cols_axis`` and
training.  JAX runs the same schedule on a mesh of the same shape from the
8 virtual devices of ``tests/conftest.py``, its Pallas locals in interpret
mode.  Each rank's block of C is held against JAX's output at the rows and
columns JAX's own plans give that rank, within TOL·max|C|; each rank's
shard plan equals the unpadded part of JAX's stacked slice for it.
"""

import json
import os
import socket
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse
import torch

from tpuspmm.formats import COO as JCOO
from tpuspmm.formats import CSR as JCSR
from tpuspmm.kernels.common import cdiv, round_up
from tpuspmm import parallel as jpar
from tpuspmm.parallel import shard as jshard
from tpuspmm_torch.ops import oracle
from tpuspmm_torch.parallel import multihost
from tpuspmm_torch.parallel import shard as tshard

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_parallel_worker as worker  # noqa: E402

# a rank's block against JAX's output at its rows and columns: f32 sums
# in another order (and another shard's order of bucket sums)
TOL = 1e-5
WORLD = worker.WORLD


# ---- the port's world: one per module ------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_parallel")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_parallel_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(WORLD), str(out / "store"),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("gloo ranks timed out")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            blocks = dict(z)
        with open(out / f"rank{r}.json") as f:
            ranks.append((blocks, json.load(f)))
    return ranks


# ---- the JAX side --------------------------------------------------------

def jax_container(spec):
    kind, x, y, vals, shape = spec
    if kind == "csr":
        return JCSR.from_scipy(scipy.sparse.csr_matrix((vals, y, x),
                                                       shape=shape))
    return JCOO(shape=shape, rows=x, cols=y, values=vals)


def torch_container(spec):
    return worker.container(spec)


OPERANDS = worker.operands()
CASES = worker.cases()
MESHES = {"1d": ((WORLD,), ("rows",)), "2d": (worker.GRID, ("rows", "cols"))}
JAX_DEFAULT_LOCAL = {"row_sharded": "tile", "ring": "xla", "kshard": "xla",
                     "2d": "tile"}


def jax_prebuilt(extra, a):
    return {
        "panel_sm16": lambda: jshard.shard_rows_panelplan(a, WORLD, sm=16),
        "pair_sm48_ch8": lambda: jshard.shard_rows_pairplan(
            a, WORLD, sm=48, chunk_strips=8),
        "buckets_sm32": lambda: jshard.bucket_panelplans(a, WORLD, WORLD,
                                                         sm=32),
        "kshard_sm64": lambda: jshard.bucket_panelplans(a, 1, WORLD, sm=64,
                                                        m_align=4),
    }[extra]()


def jax_case(name):
    """(JAX's whole C, rows a block, columns a block or None, mesh kind)
    for case ``name``: the block geometry read off JAX's own plans."""
    sched, op, local, dtype, mesh_kind, extra = CASES[name]
    spec, b = OPERANDS[op]
    a = jax_container(spec)
    if dtype == "bf16":
        b = b.astype(ml_dtypes.bfloat16)
    mesh = jpar.make_mesh(*MESHES[mesh_kind])
    local = local or JAX_DEFAULT_LOCAL[sched]
    n = b.shape[1]
    kwargs = {"local": local}
    plan = (None if extra in (None, "cols") else jax_prebuilt(extra, a))
    cols = None
    if sched in ("row_sharded", "2d"):
        n_rows = mesh.shape["rows"]
        if plan is not None:
            kwargs["plan"] = plan
        m_local = (plan or {
            "panel": lambda: jshard.shard_rows_panelplan(a, n_rows),
            "pair": lambda: jshard.shard_rows_pairplan(a, n_rows),
        }.get(local, lambda: jshard.shard_rows_tileplan(a, n_rows))()
        ).m_local
        fn = jpar.spmm_row_sharded if sched == "row_sharded" else jpar.spmm_2d
        if sched == "2d":
            cols = round_up(cdiv(n, mesh.shape["cols"]), 128)
        rows = m_local
    else:
        n_dev = mesh.shape["rows"]
        n_k = 1 if sched == "kshard" else n_dev
        align = {"xla": 8 * n_dev, "tile": n_dev, "panel": n_dev,
                 "pair": n_dev}[local] if sched == "kshard" else 1
        builder = {"xla": lambda: jshard.bucket_triplets(
                       a, n_k, n_dev, m_align=align if sched == "kshard"
                       else 8),
                   "tile": lambda: jshard.bucket_tileplans(
                       a, n_k, n_dev, m_align=align),
                   "panel": lambda: jshard.bucket_panelplans(
                       a, n_k, n_dev, m_align=align),
                   "pair": lambda: jshard.bucket_pairplans(
                       a, n_k, n_dev, m_align=align)}[local]
        src = plan or builder()
        if plan is not None:
            kwargs["plans"] = plan
        if sched == "kshard":
            fn, rows = jpar.spmm_kshard, src.m_local // n_dev
        else:
            fn, rows = jpar.spmm_ring, src.m_local
            if extra == "cols":
                kwargs["cols_axis"] = "cols"
                per = cdiv(n, mesh.shape["cols"])
                cols = per if local == "xla" else round_up(per, 128)
    c = np.asarray(fn(a, b, mesh, **kwargs), dtype=np.float64)
    return c, rows, cols, mesh_kind


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_blocks_match_jax(world, name):
    """Every rank's block of C, and the C ``gather_output`` assembles,
    against JAX's schedule on a mesh of the same shape."""
    c, rows, cols, mesh_kind = jax_case(name)
    limit = TOL * np.abs(c).max()
    m, n = c.shape
    for blocks, meta in world:
        got = blocks[name]
        i, j = ((meta["coords_1d"][0], 0) if mesh_kind == "1d"
                else meta["coords_2d"])
        r0, r1 = min(i * rows, m), min((i + 1) * rows, m)
        c0, c1 = (0, n) if cols is None else (min(j * cols, n),
                                              min((j + 1) * cols, n))
        want = c[r0:r1, c0:c1]
        assert got.shape == want.shape, (meta["rank"], got.shape, want.shape)
        assert np.abs(got - want).max(initial=0.0) <= limit, meta["rank"]
    gathered = world[0][0][name + "__gathered"]
    assert gathered.shape == c.shape
    assert np.abs(gathered - c).max() <= limit


# ---- shard plans against JAX's stacked slices ----------------------------

def _values_pm1():
    """±1 values (bf16-exact) except in rows 160-239, whose 0.1s are not:
    one row shard of four fails bf16 compaction."""
    spec = worker.csr_random(300, 420, 0.05, 3)
    kind, indptr, indices, data, shape = spec
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    vals = np.where(data > 0, 1.0, -1.0).astype(np.float32)
    mixed = np.where((rows >= 160) & (rows < 240), np.float32(0.1), vals)
    return {"pm1": (kind, indptr, indices, vals, shape),
            "mixed": (kind, indptr, indices, mixed.astype(np.float32),
                      shape)}


PLAN_OPERANDS = {"problem": OPERANDS["problem"][0],
                 "skewed": OPERANDS["skewed"][0],
                 "ring_uneven": OPERANDS["ring_uneven"][0], **_values_pm1()}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _tile_arrays(p):
    return {k: getattr(p, k) for k in ("rt", "kt", "first", "rows", "cols",
                                       "vals")}


def _check_tile(mine, theirs_arrays):
    arrs = _tile_arrays(mine)
    c = mine.num_chunks
    for key, v in arrs.items():
        np.testing.assert_array_equal(v, theirs_arrays[key][:c], key)


def _check_panel(mine, kt, st, offs, dense):
    n, P, tm = mine.n_panels, mine.panel_strips, mine.tm
    np.testing.assert_array_equal(mine.kt, kt[:n])
    np.testing.assert_array_equal(mine.st, st[:n])
    np.testing.assert_array_equal(mine.offs, offs[:n])
    np.testing.assert_array_equal(mine.a_dense, _bits(dense)[:n * P * tm])
    assert mine.a_dense.dtype == _bits(dense).dtype


def _check_pair(mine, c_kt, c_st, c_start, c_count, offs, dense):
    kt, st, start, count = mine.chunk_arrays()
    c, t = len(kt), mine.n_strips
    np.testing.assert_array_equal(kt, c_kt[:c])
    np.testing.assert_array_equal(st, c_st[:c])
    np.testing.assert_array_equal(count, c_count[:c])
    live = count > 0  # JAX re-aims fillers at the uniform zero tail
    np.testing.assert_array_equal(start[live], c_start[:c][live])
    np.testing.assert_array_equal(mine.offs[:t], offs[:t])
    np.testing.assert_array_equal(mine.a_dense[:t * mine.tm],
                                  _bits(dense)[:t * mine.tm])
    assert mine.a_dense.dtype == _bits(dense).dtype


@pytest.mark.parametrize("operand", sorted(PLAN_OPERANDS))
def test_row_shard_plans_equal_jax_slices(operand):
    spec = PLAN_OPERANDS[operand]
    ja, ta = jax_container(spec), torch_container(spec)
    jt = jshard.shard_rows_tileplan(ja, WORLD)
    jtt = jshard.shard_rows_tileplan_transposed(ja, WORLD)
    jp = jshard.shard_rows_panelplan(ja, WORLD)
    jq = jshard.shard_rows_pairplan(ja, WORLD, sm=48, chunk_strips=8)
    for r in range(WORLD):
        t = tshard.shard_rows_tileplan(ta, WORLD, r)
        assert t.m_local == jt.m_local and t.local.shape == (jt.m_local,
                                                             jt.shape[1])
        _check_tile(t.local, {k: v[r] for k, v in _tile_arrays(jt).items()})
        tt = tshard.shard_rows_tileplan_transposed(ta, WORLD, r)
        _check_tile(tt.local, {k: v[r] for k, v in _tile_arrays(jtt).items()})
        p = tshard.shard_rows_panelplan(ta, WORLD, r)
        assert p.m_local == jp.m_local and p.local.sm == jp.sm
        sl = slice(r * jp.panels_per_shard, (r + 1) * jp.panels_per_shard)
        rows = jp.panels_per_shard * jp.panel_strips * jp.tm
        _check_panel(p.local, jp.kt[sl], jp.st[sl], jp.offs[sl],
                     jp.a_dense[r * rows:(r + 1) * rows])
        q = tshard.shard_rows_pairplan(ta, WORLD, r, sm=48, chunk_strips=8)
        assert q.local.n_supertiles == jq.n_supertiles
        cs = slice(r * jq.chunks_per_shard, (r + 1) * jq.chunks_per_shard)
        strips = jq.strips_per_shard + jq.chunk_strips
        ss = slice(r * strips, (r + 1) * strips)
        _check_pair(q.local, jq.c_kt[cs], jq.c_st[cs], jq.c_start[cs],
                    jq.c_count[cs], jq.offs[ss],
                    jq.a_dense[r * strips * jq.tm:(r + 1) * strips * jq.tm])


@pytest.mark.parametrize("operand", sorted(PLAN_OPERANDS))
@pytest.mark.parametrize("n_row", [1, WORLD])
def test_bucket_plans_equal_jax_slices(operand, n_row):
    spec = PLAN_OPERANDS[operand]
    ja, ta = jax_container(spec), torch_container(spec)
    align = WORLD if n_row == 1 else 1
    jtri = jshard.bucket_triplets(ja, n_row, WORLD,
                                  m_align=8 * WORLD if n_row == 1 else 8)
    jt = jshard.bucket_tileplans(ja, n_row, WORLD, m_align=align)
    jp = jshard.bucket_panelplans(ja, n_row, WORLD, m_align=align)
    jq = jshard.bucket_pairplans(ja, n_row, WORLD, m_align=align)
    for r in range(n_row):
        tri = tshard.bucket_triplets(ta, n_row, WORLD, r,
                                     m_align=8 * WORLD if n_row == 1 else 8)
        t = tshard.bucket_tileplans(ta, n_row, WORLD, r, m_align=align)
        p = tshard.bucket_panelplans(ta, n_row, WORLD, r, m_align=align)
        q = tshard.bucket_pairplans(ta, n_row, WORLD, r, m_align=align)
        assert (tri.m_local, tri.k_local) == (jtri.m_local, jtri.k_local)
        assert (t.m_local, t.k_local) == (jt.m_local, jt.k_local)
        assert (p.m_local, q.m_local) == (jp.m_local, jq.m_local)
        for s in range(WORLD):
            cnt = len(tri.rows[s])
            assert (jtri.rows[r, s, cnt:] == -1).all()
            np.testing.assert_array_equal(tri.rows[s], jtri.rows[r, s, :cnt])
            np.testing.assert_array_equal(tri.cols[s], jtri.cols[r, s, :cnt])
            np.testing.assert_array_equal(tri.vals[s], jtri.vals[r, s, :cnt])
            _check_tile(t.buckets[s],
                        {k: v[r, s] for k, v in _tile_arrays(jt).items()})
            _check_panel(p.buckets[s], jp.kt[r, s], jp.st[r, s],
                         jp.offs[r, s], jp.a_dense[r, s])
            _check_pair(q.buckets[s], jq.c_kt[r, s], jq.c_st[r, s],
                        jq.c_start[r, s], jq.c_count[r, s], jq.offs[r, s],
                        jq.a_dense[r, s])


def test_one_shard_off_bf16_makes_every_shard_f32():
    ta = torch_container(PLAN_OPERANDS["mixed"])
    for r in range(WORLD):
        assert tshard.shard_rows_panelplan(ta, WORLD, r).local.a_dense.dtype \
            == np.float32
    tb = torch_container(PLAN_OPERANDS["pm1"])
    assert tshard.shard_rows_pairplan(tb, WORLD, 0).local.a_dense.dtype \
        == np.uint16


# ---- refusals, the ring's order, training --------------------------------

@pytest.mark.parametrize("key,fragment", [
    ("ring_tile_buckets", "plans="), ("kshard_tile_buckets", "plans="),
    ("kshard_m_align", "not divisible"), ("kshard_ring_buckets",
                                          "n_row_shards == 1"),
    ("row_sharded_other_shard", "this rank computes shard"),
    ("unknown_local", "local must be")])
def test_argument_refusals(world, key, fragment):
    for _, meta in world:
        assert meta["refusals"][key] is not None, key
        assert fragment in meta["refusals"][key]


def test_ring_posts_before_each_launch_and_waits_after(world):
    """Each step but the last posts the next panel's send and receive,
    launches on the current panel, then waits; the last sends nothing."""
    step = ["post", "launch", "wait", "wait"]
    for _, meta in world:
        assert meta["ring_events"] == step * (WORLD - 1) + ["launch"]


def _jax_train(name):
    spec, n, seed, lr, steps = worker.TRAIN[name]
    a = jax_container(spec)
    mesh = jpar.make_mesh(*MESHES["2d"])
    state = jpar.make_train_state(a, n=n, mesh=mesh, seed=seed)
    b0 = np.asarray(state["b"])
    losses = []
    for _ in range(steps):
        state, loss = jpar.lsq_train_step(state, mesh, lr=lr)
        losses.append(float(loss))
    return (b0, np.asarray(state["c_target"]), np.asarray(state["b"]),
            losses, state["meta"])


def _assemble(world, key, by_rows: bool):
    """The whole array from the 2 x 2 mesh's blocks: columns by "cols"
    coordinate, and rows by "rows" coordinate when ``by_rows`` (else the
    block is the same on every row shard)."""
    grid = {}
    for blocks, meta in world:
        i, j = meta["coords_2d"]
        grid[(i if by_rows else 0, j)] = blocks[key]
    n_i = max(i for i, _ in grid) + 1
    n_j = max(j for _, j in grid) + 1
    return np.concatenate([np.concatenate([grid[i, j] for j in range(n_j)],
                                          axis=1) for i in range(n_i)])


def test_train_state_and_two_steps_match_jax(world):
    b0, c_t, b2, losses, _ = _jax_train("train")
    assert np.array_equal(_assemble(world, "train__b0", False), b0)
    assert np.array_equal(_assemble(world, "train__c_target", True),
                          c_t)
    for _, meta in world:
        np.testing.assert_allclose(meta["train_losses"], losses, rtol=1e-5)
        assert meta["train_losses"][-1] < meta["train_losses"][0]
    got = _assemble(world, "train__b", False)
    assert np.abs(got - b2).max() <= TOL * np.abs(b2).max()


def test_train_grad_matches_autograd(world):
    """dB from the transposed-plan product equals torch autograd of the
    densified loss."""
    spec, n, seed, lr, _ = worker.TRAIN["grad"]
    b0 = _assemble(world, "grad__b0", False)
    c_t = _assemble(world, "grad__c_target", True)
    b1 = _assemble(world, "grad__b", False)
    kind, indptr, indices, data, shape = spec
    a_dense = np.zeros((c_t.shape[0], b0.shape[0]), np.float32)
    a_dense[:shape[0], :shape[1]] = scipy.sparse.csr_matrix(
        (data, indices, indptr), shape=shape).toarray()
    bt = torch.from_numpy(b0).requires_grad_()
    res = torch.from_numpy(a_dense) @ bt - torch.from_numpy(c_t)
    (0.5 * (res * res).sum()).backward()
    np.testing.assert_allclose((b0 - b1) / lr, bt.grad.numpy(), rtol=1e-3,
                               atol=1e-4)


# ---- one process, the launcher, the import boundary ----------------------

@pytest.fixture
def one_rank_group():
    assert multihost.initialize(device="cpu") is False
    try:
        yield
    finally:
        multihost.shutdown()


def test_multihost_single_process_degrades(one_rank_group):
    info = multihost.process_info()
    assert info["process_count"] == 1 and info["global_devices"] == 1
    mesh = multihost.pod_mesh(("rows",), device="cpu")
    assert tuple(mesh.shape) == (1,) and mesh.mesh_dim_names == ("rows",)
    mesh2 = multihost.pod_mesh(("rows", "cols"), shape=(1, 1), device="cpu")
    assert mesh2.mesh_dim_names == ("rows", "cols")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        multihost.pod_mesh(("rows",), shape=(2,), device="cpu")


def test_ring_at_one_rank_sends_nothing(one_rank_group, monkeypatch):
    from tpuspmm_torch.parallel import spmm as pspmm

    def refuse(*_):
        raise AssertionError("a one-rank ring sent a panel")

    monkeypatch.setattr(pspmm.dist, "batch_isend_irecv", refuse)
    spec, b = OPERANDS["problem"]
    a = torch_container(spec)
    mesh = multihost.pod_mesh(("rows",), device="cpu")
    want = oracle.spmm_oracle(a, b)
    for local in worker.LOCALS:
        got = pspmm.spmm_ring(a, b, mesh, local=local)
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster():
    """Two gloo ranks started as torchrun starts them (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): the row-sharded and ring schedules across
    the process boundary."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             "launched"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("launched ranks timed out")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-2000:]}"
        assert f"proc {r}: OK" in out, out[-2000:]


def test_parallel_and_tools_import_neither_jax_nor_tpuspmm():
    code = ("import sys, tpuspmm_torch.parallel, "
            "tpuspmm_torch.parallel.multihost, tpuspmm_torch.parallel.mesh, "
            "tpuspmm_torch.parallel.shard, tpuspmm_torch.parallel.spmm, "
            "tpuspmm_torch.parallel.train, tpuspmm_torch.tools.ablate_panel, "
            "tpuspmm_torch.tools.fit_panel_model, "
            "tpuspmm_torch.examples.distributed_serving; "
            "bad = [m for m in ('jax', 'ml_dtypes', 'tpuspmm') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE))
    assert res.returncode == 0, res.stdout + res.stderr
