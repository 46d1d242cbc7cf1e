"""Operands and B pools from the seed."""

import json
import os

import numpy as np
import scipy.io
import torch

from spmm_bench import operands, spec, traffic

from conftest import copy_code

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)


def ffn_config():
    return {"hidden_size": 256, "intermediate_size": 384,
            "num_hidden_layers": 2,
            "operands": {"kind": "pruned_ffn", "block": [128, 128],
                         "block_sparsity": 0.5}}


def as_numpy(ops):
    return [(op.name, op.shape, op.indptr.numpy(), op.indices.numpy(),
             op.values.numpy()) for op in ops]


def same(x, y):
    return all(a[:2] == b[:2] and all(np.array_equal(p, q)
                                      for p, q in zip(a[2:], b[2:]))
               for a, b in zip(x, y))


def test_pruned_ffn_repeats_for_a_seed_and_differs_across_seeds():
    runs = {s: as_numpy(operands.build(ffn_config(), s, "cpu", spec.ROOT))
            for s in SEEDS}
    for s in SEEDS:
        assert same(runs[s], as_numpy(operands.build(ffn_config(), s, "cpu",
                                                     ".")))
    for s, t in zip(SEEDS, SEEDS[1:]):
        assert not same(runs[s], runs[t])


def test_pruned_ffn_does_the_same_work_on_every_seed():
    """Names, shapes, kept blocks a weight and the blocks of each block
    row (in another order) do not depend on the seed."""
    rows = {s: [sorted(torch.diff(op.indptr).tolist())
                for op in operands.build(ffn_config(), s, "cpu", spec.ROOT)]
            for s in SEEDS}
    assert all(rows[s] == rows[SEEDS[0]] for s in SEEDS)
    for s in SEEDS:
        ops = operands.build(ffn_config(), s, "cpu", spec.ROOT)
        assert [op.name for op in ops] == [
            "layer0.gate", "layer0.up", "layer0.down",
            "layer1.gate", "layer1.up", "layer1.down"]
        assert [op.shape for op in ops] == [(384, 256), (384, 256),
                                            (256, 384)] * 2
        for op in ops:
            nbr = op.shape[0] // 128
            assert op.values.shape == (3, 128, 128)   # round(0.5 · 6)
            assert op.indptr.shape == (nbr + 1,) and int(op.indptr[-1]) == 3
            # block columns ascend within each block row
            for r in range(nbr):
                cols = op.indices[op.indptr[r]:op.indptr[r + 1]]
                assert bool(torch.all(cols[1:] > cols[:-1]))


def test_matrix_market_reads_the_file(tmp_path):
    dense = np.zeros((4, 6))
    dense[0, 1], dense[2, 5], dense[3, 0] = 2, -1, 4
    path = os.path.join(tmp_path, "m.mtx")
    scipy.io.mmwrite(path, scipy.sparse.coo_matrix(dense))
    copy_code(str(tmp_path))
    (op,) = operands.build({"name": "m", "operands": {
        "kind": "matrix_market", "path": "m.mtx"}}, 3, "cpu", str(tmp_path))
    got = scipy.sparse.csr_matrix((op.values.numpy(), op.indices.numpy(),
                                   op.indptr.numpy()), shape=op.shape)
    assert op.block is None and op.values.dtype == torch.float32
    np.testing.assert_array_equal(got.toarray(), dense)


def test_b_pools_repeat_and_follow_the_mix():
    mix = {"b_width": 5, "b_dtype": "bfloat16", "pool": 3,
           "calls_per_step": 4, "warmup_steps": 1}
    values = {"dist": "uniform", "low": -1.0, "high": 1.0}
    a = traffic.b_pools([7, 9, 7], mix, values, 2**33, "cpu")
    b = traffic.b_pools([9, 7], mix, values, 2**33, "cpu")
    assert sorted(a) == [7, 9]
    for k in a:
        assert a[k].shape == (3, k, 5) and a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k])
        assert float(a[k].float().abs().max()) <= 1.0
    c = traffic.b_pools([7, 9], mix, values, 2**33 + 1, "cpu")
    assert not torch.equal(a[7], c[7])


def test_cycle_walks_operands_and_pool_in_turn():
    # one operand, pool of 8, 8 calls a step: every step is the same sweep
    assert traffic.cycle(1, 8, 8) == [[(0, p) for p in range(8)]]
    # 12 operands, pool of 2, 12 calls: pool entry alternates by step
    steps = traffic.cycle(12, 12, 2)
    assert steps == [[(o, 0) for o in range(12)], [(o, 1) for o in range(12)]]
    # 3 operands, pool of 2, 2 calls a step
    flat = [c for step in traffic.cycle(3, 2, 2) for c in step]
    assert flat == [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1)]


def test_configs_in_the_benchmark_name_every_kind():
    here = os.path.join(spec.ROOT, "spmm_bench", "configs")
    for name in os.listdir(here):
        with open(os.path.join(here, name)) as f:
            kind = json.load(f)["operands"]["kind"]
        assert os.path.isfile(operands.generator_path(kind, spec.ROOT))


def test_fresh_b_repeats_for_a_step_and_differs_across_steps():
    mix = {"b_width": 6, "b_dtype": "bfloat16", "pool": 2,
           "calls_per_step": 1, "warmup_steps": 1}
    values = {"dist": "normal", "std": 0.05}
    a = traffic.fresh_b(9, 1, 40, mix, values, 2**35, "cpu")
    assert a.shape == (9, 6) and a.dtype == torch.bfloat16
    assert torch.equal(a, traffic.fresh_b(9, 1, 40, mix, values, 2**35,
                                          "cpu"))
    for other in ((9, 0, 40, 2**35), (9, 1, 41, 2**35), (9, 1, 40, 7)):
        k, p, step, seed = other
        assert not torch.equal(a, traffic.fresh_b(k, p, step, mix, values,
                                                  seed, "cpu"))
    pool = traffic.b_pools([9], mix, values, 2**35, "cpu")[9]
    assert not torch.equal(a, pool[1])


def test_b_pools_in_chunks_repeat_and_fill_every_entry(monkeypatch):
    mix = {"b_width": 4, "b_dtype": "bfloat16", "pool": 5,
           "calls_per_step": 1, "warmup_steps": 1}
    values = {"dist": "uniform", "low": 2.0, "high": 3.0}
    # two pool entries of f32 a draw: three draws for five entries
    monkeypatch.setattr(traffic, "CHUNK_BYTES", 2 * 3 * 4 * 4)
    a = traffic.b_pools([3], mix, values, 11, "cpu")[3]
    assert a.shape == (5, 3, 4) and a.dtype == torch.bfloat16
    assert torch.equal(a, traffic.b_pools([3], mix, values, 11, "cpu")[3])
    assert float(a.float().min()) >= 2.0 and float(a.float().max()) <= 3.0
    # each chunk is a draw of its own
    assert not torch.equal(a[0], a[2]) and not torch.equal(a[2], a[4])
