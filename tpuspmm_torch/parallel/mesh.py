"""Device-mesh helpers.

Counterpart of ``tpuspmm/parallel/mesh.py``, over
``torch.distributed.device_mesh``.  Axis convention across the package:

- ``"rows"`` partitions the sparse operand's (and output's) rows: each
  rank owns a row slab of A and computes that slab of C;
- ``"cols"`` partitions the dense operand's (and output's) columns.

The ring passes B panels along ``"rows"``; the training step sums dB over
``"rows"``.  Every rank is one device, so a mesh's size is the world size.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def mesh_devices(n: Optional[int] = None) -> list:
    """The ranks of the world (one device each), the first ``n``."""
    ranks = list(range(dist.get_world_size()))
    return ranks if n is None else ranks[:n]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("rows", "cols"),
              device: str = "cuda"):
    """A ``DeviceMesh`` over every rank: ``shape=None`` is 1-D on
    ``axis_names[0]``; otherwise the given shape, whose product must be
    the world size.  With no process group yet, it starts one
    (``multihost.initialize``: NCCL on a card, gloo for ``device="cpu"``,
    a one-rank group without a launcher)."""
    from torch.distributed.device_mesh import init_device_mesh

    from tpuspmm_torch.parallel import multihost

    multihost.initialize(device=device)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the world "
                         f"has {world}")
    names = tuple(axis_names[: len(shape)])
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current card for a CUDA mesh,
    the CPU for a CPU mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
