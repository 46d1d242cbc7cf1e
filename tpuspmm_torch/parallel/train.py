"""Distributed least-squares training step.

Counterpart of ``tpuspmm/parallel/train.py``.  Given a sparse operator A
(M × K) and a target C (M × N), learn the dense operand B minimising
0.5·‖A @ B − C‖².  On a ("rows", "cols") mesh:

- "rows" shards A's rows and C's rows;
- "cols" shards B's and C's columns;
- B is replicated over "rows", so its gradient, a contraction over the
  row-sharded M, is summed over "rows" (``all_reduce``).

Both products run K3 (``kernels/tile_spmm.spmm_tiles``): the forward on
the rank's row-slab tile plan, the backward dB = A_sᵀ · res on the
transposed plan of the same slab.  The loss is summed over "rows", then
"cols".
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from tpuspmm_torch.kernels.common import cdiv, round_up
from tpuspmm_torch.parallel.mesh import axis_size, mesh_device
from tpuspmm_torch.parallel.shard import (shard_rows_tileplan,
                                          shard_rows_tileplan_transposed)


def make_train_state(a, n: int, mesh, seed: int = 0) -> Dict:
    """This rank's training state: the forward and transposed tile plans
    of its row slab, its column block of B (K_pad × n_local) and its block
    of the target (m_local × n_local).

    B₀ and the target are drawn whole from ``np.random.default_rng(seed)``
    exactly as the JAX package draws them (B₀ = 0.02·N(0, 1) of
    (K_pad, n_pad), then the target N(0, 1) of (m_local·n_rows, n_pad)),
    and each rank keeps its blocks, so the state equals JAX's."""
    n_rows, r = axis_size(mesh, "rows"), mesh.get_local_rank("rows")
    n_cols, j = axis_size(mesh, "cols"), mesh.get_local_rank("cols")
    fwd = shard_rows_tileplan(a, n_rows, r)
    bwd = shard_rows_tileplan_transposed(a, n_rows, r)
    m, k = fwd.shape
    m_local = fwd.m_local
    k_pad = fwd.local.num_k_tiles * fwd.local.tile_k
    n_local = round_up(cdiv(n, n_cols), 128)
    n_pad = n_local * n_cols

    rng = np.random.default_rng(seed)
    b0 = rng.standard_normal((k_pad, n_pad)).astype(np.float32) * 0.02
    c_target = rng.standard_normal((m_local * n_rows, n_pad)).astype(
        np.float32)
    cols = slice(j * n_local, (j + 1) * n_local)
    device = mesh_device(mesh)
    return {
        "fwd": fwd, "bwd": bwd,
        "b": torch.from_numpy(np.ascontiguousarray(b0[:, cols])).to(device),
        "c_target": torch.from_numpy(np.ascontiguousarray(
            c_target[r * m_local:(r + 1) * m_local, cols])).to(device),
        "meta": {"m": m, "k": k, "m_local": m_local, "k_pad": k_pad,
                 "n": n, "n_pad": n_pad, "n_local": n_local},
    }


def lsq_train_step(state: Dict, mesh, lr: float = 1e-2):
    """One SGD step on this rank's blocks.  Returns (new state, loss): the
    loss a 0-d float32 tensor, the same on every rank."""
    from tpuspmm_torch.kernels.tile_spmm import spmm_tiles

    k = state["meta"]["k"]
    b = state["b"]
    res = spmm_tiles(state["fwd"].local, b[:k]) - state["c_target"]
    loss = 0.5 * torch.sum(res * res)
    for axis in ("rows", "cols"):
        dist.all_reduce(loss, group=mesh.get_group(axis))
    # dB = A_sᵀ res through the transposed plan, summed over the row shards
    db = spmm_tiles(state["bwd"].local, res)
    dist.all_reduce(db, group=mesh.get_group("rows"))
    new_b = b.clone()
    new_b[:k] -= lr * db
    return dict(state, b=new_b), loss
