"""The C-resident kernels' cluster launch (K5a, K5b on the card): its
schedule against the tile index and the JAX package's C-resident kernels.

On the card the owners of ``cluster`` consecutive row tiles of one column
tile form a thread-block cluster that walks the ascending union of their
dense k-tiles, each k-chunk of a B panel copied once for all of them
(``kernels/cres_spmm.py::cluster_schedule``, ``csrc/chunk_spmm.cu``).  A
CUDA kernel cannot run here, so these tests hold what it reads: every
dense tile sits once in the schedule, under its own row tile; each
member's steps ascend and each cluster's steps are its members' union; a
replay of the schedule in f64 (dense tiles at the cluster's steps, then
the gathered CSR) equals the owner routine's replay (``owner_walk``)
exactly, so the cluster launch keeps K3's sum order, and matches JAX's
K5a / K5b in interpret mode within TOL·max|C| (``test_torch_tiles``).
The reckoning of the B chunks each launch stages is held against a count
made chunk by chunk.
"""

import functools
import re

import numpy as np
import pytest
import torch

from tpuspmm.kernels import cres_spmm as jk5
from tpuspmm_torch.kernels import chunk_cuda, cres_spmm, tile_spmm
from test_torch_tiles import (CASES, THRESHOLDS, b_pair, close, index_of,
                              owner_walk, plans)

CLUSTERS = (1, 2, 4, 8)
ALL_CASES = [*CASES, "empty"]


def schedule_of(plan, min_dense, cluster):
    return cres_spmm.cluster_schedule(plan, min_dense, cluster)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", ALL_CASES)
def test_schedule_lists_every_dense_tile_once(case, cluster):
    """Each dense tile of the index is in the schedule once, in the column
    of the member that owns its row tile, at a step of its k-tile; no
    other entry names a tile."""
    _, tp = plans(case)
    for min_dense in THRESHOLDS.values():
        ix = index_of(tp, min_dense)
        s = schedule_of(tp, min_dense, cluster)
        c_rt, s_tile = s["c_rt"], s["s_tile"]
        assert c_rt.shape == (s["clusters"], cluster)
        assert s_tile.shape == (len(s["s_kt"]), cluster)
        named = np.sort(s_tile[s_tile >= 0])
        assert np.array_equal(named, np.arange(len(ix["d_kt"])))
        d_rt = np.repeat(np.arange(tp.num_row_tiles), np.diff(ix["d_ptr"]))
        step_cl = np.repeat(np.arange(s["clusters"]), np.diff(s["c_ptr"]))
        steps, members = np.nonzero(s_tile >= 0)
        t = s_tile[steps, members]
        assert np.array_equal(c_rt[step_cl[steps], members], d_rt[t])
        assert np.array_equal(s["s_kt"][steps], ix["d_kt"][t])


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", ALL_CASES)
def test_schedule_steps_are_the_members_union(case, cluster):
    """Row tiles are grouped consecutively, the last group padded with
    members of no row tile, which have no tile; each cluster's steps are
    the sorted union of its members' dense k-tiles, so each member's
    tiles ascend; clusters are ordered by nonzeros, most first."""
    _, tp = plans(case)
    nrt = tp.num_row_tiles
    for min_dense in THRESHOLDS.values():
        ix = index_of(tp, min_dense)
        s = schedule_of(tp, min_dense, cluster)
        assert s["clusters"] == -(-nrt // cluster)
        flat = s["c_rt"].reshape(-1)
        assert np.array_equal(flat[:nrt], np.arange(nrt))
        assert np.all(flat[nrt:] == -1)
        assert s["c_ptr"][0] == 0 and s["c_ptr"][-1] == len(s["s_kt"])
        assert np.all(np.diff(s["c_ptr"]) >= 0)
        shared = 0
        for c in range(s["clusters"]):
            lo, hi = s["c_ptr"][c], s["c_ptr"][c + 1]
            union = set()
            for j, r in enumerate(s["c_rt"][c]):
                tiles = s["s_tile"][lo:hi, j]
                if r < 0:
                    assert np.all(tiles == -1)
                    continue
                mine = ix["d_kt"][ix["d_ptr"][r]:ix["d_ptr"][r + 1]]
                union.update(mine.tolist())
                got = tiles[tiles >= 0]
                assert np.array_equal(got, np.arange(ix["d_ptr"][r],
                                                     ix["d_ptr"][r + 1]))
                assert np.all(np.diff(ix["d_kt"][got]) > 0)
            assert s["s_kt"][lo:hi].tolist() == sorted(union)
            shared += int(((s["s_tile"][lo:hi] >= 0).sum(axis=1) >= 2).sum())
        assert s["shared_steps"] == shared
        assert cluster > 1 or shared == 0
        nnz = np.bincount(ix["tile_rt"], weights=ix["tile_nnz"],
                          minlength=nrt)
        work = np.bincount(np.arange(nrt) // cluster, weights=nnz,
                           minlength=s["clusters"])
        assert sorted(s["c_order"]) == list(range(s["clusters"]))
        assert np.all(np.diff(work[s["c_order"]]) <= 0)


def cluster_walk(plan, b, min_dense, cluster):
    """Pure-torch replay of the cluster launch in f64: each cluster's
    steps in order, each member adding its dense tile's A @ B panel into
    its row tile, then per output row its gathered nonzeros in index
    order (``owner_walk``'s second half)."""
    ix = index_of(plan, min_dense)
    s = schedule_of(plan, min_dense, cluster)
    tm, tk = plan.tile_m, plan.tile_k
    bp = torch.zeros(plan.num_k_tiles * tk, b.shape[1], dtype=torch.float64)
    bp[:b.shape[0]] = b.double()
    out = torch.zeros(plan.num_row_tiles * tm, b.shape[1],
                      dtype=torch.float64)
    d_a = torch.from_numpy(ix["d_a"]).double()
    for c in s["c_order"]:
        for step in range(s["c_ptr"][c], s["c_ptr"][c + 1]):
            k0 = int(s["s_kt"][step]) * tk
            for j, r in enumerate(s["c_rt"][c]):
                t = s["s_tile"][step, j]
                if t >= 0:
                    out[r * tm:(r + 1) * tm] += d_a[t, :tm] @ bp[k0:k0 + tk]
    rows = torch.from_numpy(np.repeat(np.arange(len(ix["row_ptr"]) - 1),
                                      np.diff(ix["row_ptr"])))
    vals = torch.from_numpy(ix["g_val"]).double().unsqueeze(-1)
    out.index_add_(0, rows, vals * bp[torch.from_numpy(ix["g_col"]).long()])
    return out[:plan.shape[0]]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", ALL_CASES)
def test_schedule_replay_equals_owner_walk(case, cluster):
    """Each member adds its own dense tiles in ascending k-tile, then the
    gathered nonzeros: the owner routine's order, so the two replays are
    equal bit for bit, at every threshold of the dense path."""
    _, tp = plans(case)
    _, b = b_pair(tp.shape[1], 40, seed=16, bf16=False)
    for min_dense in THRESHOLDS.values():
        assert torch.equal(cluster_walk(tp, b, min_dense, cluster),
                           owner_walk(tp, b, min_dense))


@functools.lru_cache(maxsize=None)
def jax_cres(bf16: bool) -> tuple:
    """JAX's K5a ("highest", "split") and K5b ("split") in interpret mode
    on the duplicates case, and the port's B."""
    jp, _ = plans("duplicates")
    jb, tb = b_pair(jp.shape[1], 72, seed=17, bf16=bf16)
    return tb, {
        ("block8", mode): np.asarray(jk5.spmm_cres(
            jp, jb, mode=mode, schedule="block8", interpret=True))
        for mode in ("highest", "split")} | {
        ("kloop", "split"): np.asarray(jk5.spmm_cres(
            jp, jb, mode="split", schedule="kloop", interpret=True))}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_schedule_replay_matches_jax(cluster, bf16):
    """The replay against JAX's C-resident kernels, block8 at "highest"
    and "split", kloop at "split", within TOL·max|C|, at a threshold of
    one nonzero per k row (some tiles dense, some of their k-tiles shared
    by two row tiles of a cluster when it has more than one)."""
    _, tp = plans("duplicates")
    min_dense = THRESHOLDS["one_per_k"]
    assert index_of(tp, min_dense)["tile_dense"].any()
    if cluster > 1:
        assert schedule_of(tp, min_dense, cluster)["shared_steps"] > 0
    tb, refs = jax_cres(bf16)
    walk = cluster_walk(tp, tb, min_dense, cluster).float()
    for ref in refs.values():
        close(walk, ref)


def staged_by_chunk(plan, b, min_dense, cluster, sms):
    """The B chunks each launch stages, counted one KC-row chunk at a
    time as the kernel walks them: (owner stagings, cluster stagings,
    multicast issues, owner bytes, cluster bytes)."""
    ix = index_of(plan, min_dense)
    s = schedule_of(plan, min_dense, cluster)
    k, n = b.shape
    esize = b.element_size()
    tn = chunk_cuda.column_tile(plan.num_row_tiles, n, sms)
    aligned = b.data_ptr() % 16 == 0 and n * esize % 16 == 0
    owner = [0, 0]
    clus = [0, 0, 0]
    for kt_list, members in ((ix["d_kt"], None),
                             (s["s_kt"], (s["s_tile"] >= 0).sum(axis=1))):
        for i, kt in enumerate(kt_list):
            for kc in range(0, plan.tile_k, chunk_cuda.KC):
                r0 = int(kt) * plan.tile_k + kc
                rows = min(max(k - r0, 0), chunk_cuda.KC)
                for n0 in range(0, n, tn):
                    nbytes = rows * min(tn, n - n0) * esize
                    if members is None:
                        owner[0] += 1
                        owner[1] += nbytes
                    elif (aligned and r0 + chunk_cuda.KC <= k
                          and n0 + tn <= n):
                        clus[0] += 1
                        clus[1] += 1
                        clus[2] += nbytes
                    else:
                        clus[0] += int(members[i])
                        clus[2] += int(members[i]) * nbytes
    return owner[0], clus[0], clus[1], owner[1], clus[2]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", ALL_CASES)
def test_b_traffic_is_the_chunk_count(case, cluster):
    """``b_traffic`` (chip_smoke.py's record) against a count chunk by
    chunk, f32 and bf16 B, 16-byte rows and not (width 77: no multicast);
    the cluster stages no more than the owner routine, fewer wherever a
    step is shared and B is bulk copied, and as many at one row tile a
    cluster or with no multicast."""
    _, tp = plans(case)
    min_dense = THRESHOLDS["one_per_k"]
    for width, bf16, sms in ((64, False, 132), (77, False, 132),
                             (200, True, 4)):
        _, b = b_pair(tp.shape[1], width, seed=18, bf16=bf16)
        got = cres_spmm.b_traffic(tp, b, min_dense, sms, cluster)
        want = staged_by_chunk(tp, b, min_dense, cluster, sms)
        assert (got["owner_stagings"], got["cluster_stagings"],
                got["multicast_issues"], got["b_panel_bytes"]["owner"],
                got["b_panel_bytes"]["cluster"]) == want
        assert got["cluster_stagings"] <= got["owner_stagings"]
        if got["multicast_issues"] and got["shared_steps"]:
            assert got["cluster_stagings"] < got["owner_stagings"]
            assert got["b_panel_bytes"]["cluster"] < \
                got["b_panel_bytes"]["owner"]
        if cluster == 1 or not got["multicast_issues"]:
            assert got["cluster_stagings"] == got["owner_stagings"]
        if width == 77:
            assert got["multicast_issues"] == 0
            assert got["b_copy"] in ("none (no dense tile)",
                                     "member plain loads (B rows not "
                                     "16-byte aligned)")


def test_schedule_built_once_and_transferred_once():
    """Cached on the plan per threshold and cluster size (the default is
    the build's CLUSTER), and its device arrays per device."""
    _, tp = plans("duplicates")
    md = THRESHOLDS["one_per_k"]
    s = cres_spmm.cluster_schedule(tp, md)
    assert s is cres_spmm.cluster_schedule(tp, md, chunk_cuda.CLUSTER)
    assert s["cluster"] == chunk_cuda.CLUSTER
    other = 4 if chunk_cuda.CLUSTER != 4 else 2
    assert cres_spmm.cluster_schedule(tp, md, other) is not s
    arrs = cres_spmm.schedule_arrays(tp, "cpu", md)
    assert arrs is cres_spmm.schedule_arrays(tp, "cpu", md)
    assert set(arrs) == set(chunk_cuda.CLUSTER_INDEX)
    for name in chunk_cuda.CLUSTER_INDEX:
        assert arrs[name].dtype == torch.int32 and arrs[name].is_contiguous()
        assert np.array_equal(arrs[name].numpy(), s[name])


def test_cluster_constants_match_source():
    """The cluster size the schedule is built for is the source's CLUSTER
    (at most 8, the portable cluster size), and the cluster entry takes
    the schedule's arrays by those names."""
    with open(chunk_cuda.SOURCE) as f:
        text = f.read()
    cluster = int(re.search(r"constexpr int CLUSTER = (\d+);",
                            text).group(1))
    assert cluster == chunk_cuda.CLUSTER and 1 <= cluster <= 8
    params = re.search(r"\bcres_cluster_spmm\(([^)]*)\)\s*{",
                       text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[:len(chunk_cuda.INDEX)] == list(chunk_cuda.INDEX)
    assert names[len(chunk_cuda.INDEX):len(chunk_cuda.INDEX)
                 + len(chunk_cuda.CLUSTER_INDEX)] == list(
                     chunk_cuda.CLUSTER_INDEX)
    for name in chunk_cuda.CLUSTER_INDEX:  # the device struct's fields
        assert re.search(rf"const int\* {name};", text), name


def test_cluster_launch_refuses_a_cpu_tensor():
    """The launcher refuses a CPU tensor by name; the entry runs the plain
    version on it (no launch counted), the counter unused."""
    _, tp = plans("duplicates")
    md = tile_spmm.dense_min(tp.tile_k, False)
    idx = tile_spmm.index_arrays(tp, "cpu", md)
    sched = dict(cres_spmm.schedule_arrays(tp, "cpu", md))
    b = torch.zeros(tp.shape[1], 16)
    with pytest.raises(ValueError, match="CUDA"):
        chunk_cuda.launch_cluster("cres_chunk_spmm", idx, sched, b,
                                  tp.shape[0], tp.tile_m, tp.tile_k, False)
    before = (cres_spmm.spmm_cres.launches,
              cres_spmm.spmm_cres_kloop.launches)
    issues = torch.zeros(1, dtype=torch.int32)
    out = cres_spmm.spmm_cres(tp, b, issues=issues)
    assert out.shape == (tp.shape[0], 16) and not out.any()
    assert int(issues) == 0
    assert before == (cres_spmm.spmm_cres.launches,
                      cres_spmm.spmm_cres_kloop.launches)


def test_cluster_sweep_variants_apply_once():
    """``strip_sweep.py --chunk``'s cluster sizes (2, 4, 8) and controls
    build copies of the source with CLUSTER set and their lines replaced:
    every replaced text is in the source exactly once, else that
    variant's build is an error record on the card."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import strip_sweep

    with open(chunk_cuda.SOURCE) as f:
        text = f.read()
    sizes = {r for r, _ in strip_sweep.CLUSTER_VARIANTS.values()}
    assert {2, 4, 8} <= sizes and chunk_cuda.CLUSTER in sizes
    for name, (r, patches) in strip_sweep.CLUSTER_VARIANTS.items():
        for old, _ in [strip_sweep.const("CLUSTER", chunk_cuda.CLUSTER, r),
                       *patches]:
            assert text.count(old) == 1, (name, old[:60])
    assert set(strip_sweep.CLUSTER_CONTROLS) <= set(
        strip_sweep.CLUSTER_VARIANTS)
