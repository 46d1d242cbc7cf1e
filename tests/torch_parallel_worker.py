"""One rank of the distributed tests of ``tpuspmm_torch.parallel``.

Imports numpy, scipy, torch and the port only (never jax or tpuspmm):
``tests/test_torch_parallel.py`` starts WORLD of these over gloo, one world
for the whole module, and holds what they write against the JAX package.

    python tests/torch_parallel_worker.py <rank> <world> <init file> <out dir>
    python tests/torch_parallel_worker.py launched   # RANK, WORLD_SIZE, ...

Each rank runs every case of :func:`cases` and writes ``rank<r>.npz`` (its
block of C per case, and the gathered C on rank 0) and ``rank<r>.json``
(its mesh coordinates, the refusals it saw, the ring's event order, the
training losses).  The input builders are shared with the test module.
"""

import json
import os
import sys

import numpy as np
import scipy.sparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GRID = (2, 2)


# ---- inputs (numpy only; the test builds the JAX containers from them) --

def csr_random(m, k, density, seed, lo=-100.0, hi=100.0):
    """(indptr, indices, data, shape): ``tpuspmm.CSR.random``'s recipe."""
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="csr",
                             random_state=rng,
                             data_rvs=lambda n: rng.uniform(lo, hi, n))
    return ("csr", sp.indptr, sp.indices, sp.data.astype(np.float32),
            (m, k))


def skewed():
    """97 x 205 with 90% of the nonzeros in K < 64 (some k buckets nearly
    empty) and B 40 wide: ``tests/test_parallel.py``'s uneven buckets."""
    rng = np.random.default_rng(13)
    m, k = 97, 205
    n1, n2 = 360, 40
    rows = np.concatenate([rng.integers(0, m, n1), rng.integers(0, m, n2)])
    cols = np.concatenate([rng.integers(0, 64, n1),
                           rng.integers(64, k, n2)])
    vals = rng.standard_normal(n1 + n2).astype(np.float32)
    b = rng.standard_normal((k, 40)).astype(np.float32)
    return ("coo", rows.astype(np.int32), cols.astype(np.int32), vals,
            (m, k)), b


def operands():
    """name -> (matrix spec, B): the inputs of every case."""
    problem = csr_random(300, 420, 0.05, 3)
    b = np.random.default_rng(7).standard_normal((420, 96)).astype(
        np.float32)
    skew, b_skew = skewed()
    return {
        "problem": (problem, b),
        "problem_w72": (problem, b[:, :72]),
        "skewed": (skew, b_skew),
        "ring_uneven": (csr_random(97, 205, 0.08, 5),
                        np.random.default_rng(11).standard_normal(
                            (205, 40)).astype(np.float32)),
        "kshard_uneven": (csr_random(130, 333, 0.07, 9),
                          np.random.default_rng(17).standard_normal(
                              (333, 72)).astype(np.float32)),
        "kshard_uneven_xla": (csr_random(101, 333, 0.07, 8),
                              np.random.default_rng(13).standard_normal(
                                  (333, 24)).astype(np.float32)),
        "supertiled": (csr_random(264, 520, 0.06, 11),
                       np.random.default_rng(5).standard_normal(
                           (520, 96)).astype(np.float32)),
        "ring_supertiled": (csr_random(128, 256, 0.06, 19),
                            np.random.default_rng(23).standard_normal(
                                (256, 40)).astype(np.float32)),
        "wide": (csr_random(96, 128, 0.1, 6),
                 np.random.default_rng(17).standard_normal(
                     (128, 1280)).astype(np.float32)),
    }


SCHEDULES = ("row_sharded", "ring", "kshard", "2d")
LOCALS = ("xla", "tile", "panel", "pair")


def cases():
    """name -> (schedule, operand, local, B dtype, mesh "1d" / "2d",
    extra): every output case.  ``extra`` names a prebuilt plan or the
    ring's column axis."""
    out = {}
    for sched in SCHEDULES:
        for local in LOCALS:
            out[f"{sched}_{local}"] = (sched, "problem", local, "f32",
                                       "2d" if sched == "2d" else "1d",
                                       None)
    for local in LOCALS:
        out[f"ring_{local}_skewed"] = ("ring", "skewed", local, "f32", "1d",
                                       None)
        out[f"ring_{local}_cols"] = ("ring", "problem", local, "f32", "2d",
                                     "cols")
    out["ring_xla_uneven"] = ("ring", "ring_uneven", "xla", "f32", "1d",
                              None)
    for local in ("tile", "panel", "pair"):
        out[f"kshard_{local}_uneven"] = ("kshard", "kshard_uneven", local,
                                         "f32", "1d", None)
    out["kshard_xla_uneven"] = ("kshard", "kshard_uneven_xla", "xla", "f32",
                                "1d", None)
    out["row_sharded_panel_supertiled"] = ("row_sharded", "problem", "panel",
                                           "f32", "1d", "panel_sm16")
    out["row_sharded_pair_supertiled"] = ("row_sharded", "problem", "pair",
                                          "f32", "1d", "pair_sm48_ch8")
    out["ring_panel_supertiled"] = ("ring", "ring_supertiled", "panel", "f32",
                                    "1d", "buckets_sm32")
    out["kshard_panel_supertiled"] = ("kshard", "supertiled", "panel", "f32",
                                      "1d", "kshard_sm64")
    for local in ("panel", "pair"):
        out[f"2d_{local}_w72"] = ("2d", "problem_w72", local, "f32", "2d",
                                  None)
        out[f"2d_{local}_bf16"] = ("2d", "problem", local, "bf16", "2d",
                                   None)
    out["2d_tile_wide"] = ("2d", "wide", "tile", "f32", "2d", None)
    for sched in ("row_sharded", "kshard", "ring"):
        out[f"{sched}_default_bf16"] = (sched, "problem", None, "bf16", "1d",
                                        None)
    for sched in ("kshard", "ring"):
        for local in ("pair", "panel"):
            out[f"{sched}_{local}_bf16"] = (sched, "problem", local, "bf16",
                                            "1d", None)
    return out


# the training cases: (operand spec, n, seed, lr, steps)
TRAIN = {"train": (csr_random(120, 200, 0.1, 9), 64, 1, 1e-7, 2),
         "grad": (csr_random(40, 60, 0.2, 2), 32, 4, 1e-2, 1)}


# ---- the rank ------------------------------------------------------------

def container(spec):
    from tpuspmm_torch import interop
    from tpuspmm_torch.formats import COO

    kind, x, y, vals, shape = spec
    if kind == "csr":
        return interop.csr_from_arrays(x, y, vals, shape)
    return COO(shape=shape, rows=x, cols=y, values=vals)


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from tpuspmm_torch import parallel
    from tpuspmm_torch.parallel import multihost, shard
    from tpuspmm_torch.parallel import spmm as pspmm

    torch.set_num_threads(1)  # WORLD ranks share the machine's cores
    multihost.initialize(device="cpu", init_method=f"file://{init_file}",
                         num_processes=world, process_id=rank)
    mesh1 = parallel.make_mesh((world,), ("rows",), device="cpu")
    mesh2 = parallel.make_mesh(GRID, ("rows", "cols"), device="cpu")
    meshes = {"1d": mesh1, "2d": mesh2}
    ops = operands()
    mats = {name: container(spec) for name, (spec, _) in ops.items()}
    r1 = mesh1.get_local_rank("rows")
    r2, j2 = mesh2.get_local_rank("rows"), mesh2.get_local_rank("cols")
    prebuilt = {
        "panel_sm16": lambda a: shard.shard_rows_panelplan(a, world, r1,
                                                           sm=16),
        "pair_sm48_ch8": lambda a: shard.shard_rows_pairplan(
            a, world, r1, sm=48, chunk_strips=8),
        "buckets_sm32": lambda a: shard.bucket_panelplans(a, world, world,
                                                          r1, sm=32),
        "kshard_sm64": lambda a: shard.bucket_panelplans(a, 1, world, 0,
                                                         sm=64, m_align=4),
    }
    fns = {"row_sharded": parallel.spmm_row_sharded,
           "ring": parallel.spmm_ring, "kshard": parallel.spmm_kshard,
           "2d": parallel.spmm_2d}
    blocks, meta = {}, {"rank": rank, "coords_1d": [r1],
                        "coords_2d": [r2, j2]}
    for name, (sched, op, local, dtype, mesh_kind, extra) in cases().items():
        a = mats[op]
        b = torch.from_numpy(ops[op][1])
        if dtype == "bf16":
            b = b.to(torch.bfloat16)
        mesh = meshes[mesh_kind]
        kwargs = {} if local is None else {"local": local}
        if extra == "cols":
            kwargs["cols_axis"] = "cols"
        elif extra in ("panel_sm16", "pair_sm48_ch8"):
            kwargs["plan"] = prebuilt[extra](a)
        elif extra is not None:
            kwargs["plans"] = prebuilt[extra](a)
        c = fns[sched](a, b, mesh, **kwargs)
        blocks[name] = c.numpy()
        cols_axis = "cols" if (sched == "2d" or extra == "cols") else None
        full = parallel.gather_output(c, mesh, cols_axis=cols_axis)
        if rank == 0:
            blocks[name + "__gathered"] = full.numpy()

    # the argument refusals
    a, b = mats["problem"], torch.from_numpy(ops["problem"][1])
    refusals = {}

    def refused(key, call):
        try:
            call()
            refusals[key] = None
        except ValueError as e:
            refusals[key] = str(e)

    trip = shard.bucket_triplets(a, world, world, r1)
    refused("ring_tile_buckets", lambda: parallel.spmm_ring(
        a, b, mesh1, buckets=trip, local="tile"))
    refused("kshard_tile_buckets", lambda: parallel.spmm_kshard(
        a, b, mesh1, buckets=shard.bucket_triplets(a, 1, world, 0),
        local="tile"))
    odd = mats["ring_uneven"]  # 97 rows: m_local 97 splits 4 ways unevenly
    refused("kshard_m_align", lambda: parallel.spmm_kshard(
        odd, torch.from_numpy(ops["ring_uneven"][1]), mesh1,
        buckets=shard.bucket_triplets(odd, 1, world, 0, m_align=1)))
    refused("kshard_ring_buckets", lambda: parallel.spmm_kshard(
        a, b, mesh1, buckets=trip))
    refused("row_sharded_other_shard", lambda: parallel.spmm_row_sharded(
        a, b, mesh1, plan=shard.shard_rows_tileplan(a, world,
                                                    (r1 + 1) % world)))
    refused("unknown_local", lambda: parallel.spmm_2d(a, b, mesh2,
                                                      local="dense"))
    meta["refusals"] = refusals

    # the ring's order of events: each step posts the next panel's
    # send / receive before its launch and waits after it
    events = []
    post, bucket = pspmm.dist.batch_isend_irecv, pspmm.run_bucket

    def logged_post(ops_):
        events.append("post")
        return [Logged(q) for q in post(ops_)]

    class Logged:
        def __init__(self, req):
            self.req = req

        def wait(self):
            events.append("wait")
            return self.req.wait()

    def logged_bucket(*args):
        events.append("launch")
        return bucket(*args)

    pspmm.dist.batch_isend_irecv = logged_post
    pspmm.run_bucket = logged_bucket
    try:
        parallel.spmm_ring(a, b, mesh1, local="tile")
    finally:
        pspmm.dist.batch_isend_irecv, pspmm.run_bucket = post, bucket
    meta["ring_events"] = events

    # training
    for name, (spec, n, seed, lr, steps) in TRAIN.items():
        ta = container(spec)
        state = parallel.make_train_state(ta, n, mesh2, seed=seed)
        blocks[name + "__b0"] = state["b"].numpy()
        blocks[name + "__c_target"] = state["c_target"].numpy()
        losses = []
        for _ in range(steps):
            state, loss = parallel.lsq_train_step(state, mesh2, lr=lr)
            losses.append(float(loss))
        blocks[name + "__b"] = state["b"].numpy()
        meta[name + "_losses"] = losses

    info = multihost.process_info()
    meta["process_info"] = info
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **blocks)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    multihost.shutdown()


def launched() -> None:
    """A rank started with a launcher's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): the row-sharded and ring schedules over the
    mesh of every rank, gathered and held to the dense product (the
    counterpart of ``tests/multihost_worker.py``)."""
    import torch

    from tpuspmm_torch import parallel
    from tpuspmm_torch.parallel import multihost

    torch.set_num_threads(1)
    assert multihost.initialize(device="cpu")
    info = multihost.process_info()
    rank = info["process_index"]
    assert info["process_count"] == int(os.environ["WORLD_SIZE"]), info
    mesh = multihost.pod_mesh(("rows",), device="cpu")
    spec = csr_random(160, 240, 0.06, 3)
    a = container(spec)
    b = np.random.default_rng(0).standard_normal((240, 32)).astype(
        np.float32)
    _, indptr, indices, data, shape = spec
    dense = scipy.sparse.csr_matrix((data, indices, indptr),
                                    shape=shape).toarray()
    ref = dense.astype(np.float64) @ b.astype(np.float64)
    for name, fn in (("row_sharded", parallel.spmm_row_sharded),
                     ("ring", parallel.spmm_ring)):
        kwargs = {"local": "xla"} if name == "row_sharded" else {}
        full = parallel.gather_output(fn(a, b, mesh, **kwargs), mesh)
        ok = np.allclose(full.numpy(), ref, rtol=1e-2, atol=1e-3)
        print(f"proc {rank}: {name} correct={ok}", flush=True)
        assert ok, name
    multihost.shutdown()
    print(f"proc {rank}: OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "launched":
        launched()
    else:
        run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
