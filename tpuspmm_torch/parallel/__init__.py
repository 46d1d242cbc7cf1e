"""Distributed SpMM over torch.distributed.

Counterpart of ``tpuspmm.parallel``: the sparse operand row- or
column-partitioned across ranks, B whole, column-sharded, or passed round
a ring with the compute overlapped, and a least-squares training step
with its gradient collective.  Every rank runs the same call with the
whole A and B and gets its own block of C; ``gather_output`` assembles
C.  The locals are the single-card entry points (K1 panel, K2 pair, K3
tile, or the gather path).
"""

from tpuspmm_torch.parallel import multihost
from tpuspmm_torch.parallel.mesh import make_mesh, mesh_devices
from tpuspmm_torch.parallel.shard import KBucketedTriplets, RowShardedPlan
from tpuspmm_torch.parallel.spmm import (
    gather_output,
    spmm_2d,
    spmm_kshard,
    spmm_ring,
    spmm_row_sharded,
)
from tpuspmm_torch.parallel.train import lsq_train_step, make_train_state

__all__ = [
    "make_mesh",
    "mesh_devices",
    "RowShardedPlan",
    "KBucketedTriplets",
    "spmm_row_sharded",
    "spmm_ring",
    "spmm_2d",
    "spmm_kshard",
    "lsq_train_step",
    "make_train_state",
    "multihost",
    "gather_output",
]
