"""Process-group initialisation and the mesh over every rank.

Counterpart of ``tpuspmm/parallel/multihost.py``.  JAX's schedules are
single-controller: one process sees every device.  torch.distributed is
multi-controller: every rank (one per GPU) runs the same program, so a
launcher starts the ranks and tells each its place::

    torchrun --nproc_per_node=8 my_program.py
    # in my_program.py:
    from tpuspmm_torch.parallel import multihost, spmm_row_sharded
    multihost.initialize()                  # NCCL, from torchrun's env
    mesh = multihost.pod_mesh(("rows",))    # every rank, 1-D
    c_block = spmm_row_sharded(A, B, mesh)  # this rank's rows of C

With no launcher environment ``initialize`` starts a one-rank group on a
local store, as JAX's degrades to one process.  A card gets NCCL; gloo
serves only a caller that asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda",
               init_method: Optional[str] = None) -> bool:
    """Join (or start) the default process group.

    - ``coordinator_address`` ("host:port") with ``num_processes`` and
      ``process_id``, or an ``init_method`` URL ("tcp://...",
      "file://...") with them: that rendezvous;
    - else a launcher's environment (torchrun's RANK, WORLD_SIZE,
      MASTER_ADDR, MASTER_PORT);
    - else a one-rank group on a local store.

    On a CUDA device the rank's card is set first (LOCAL_RANK, else the
    rank modulo the cards present) and the backend is NCCL.  Returns True
    when the group came from a rendezvous or a launcher, False for the
    one-rank group; True at once when a group already exists."""
    if dist.is_initialized():
        return True
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(torch.device(device).type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {device!r}")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a rendezvous needs num_processes and "
                             "process_id")
        rank, world = int(process_id), int(num_processes)
        kwargs = dict(init_method=init_method, rank=rank, world_size=world)
        launched = True
    elif all(v in os.environ for v in LAUNCHER_ENV):
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        kwargs = dict(init_method="env://")
        launched = True
    else:
        rank, world = 0, 1
        kwargs = dict(store=dist.HashStore(), rank=0, world_size=1)
        launched = False
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, **kwargs)
    return launched


def shutdown() -> None:
    """Destroy the default process group (and every mesh group), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def pod_mesh(axis_names: Sequence[str] = ("rows",),
             shape: Optional[Tuple[int, ...]] = None, device: str = "cuda"):
    """Mesh over every rank: 1-D by default; ``shape`` for 2-D (e.g.
    ``(hosts, cards_per_host)``, so the ring's neighbours share a host)."""
    from tpuspmm_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world,)
    names = (tuple(axis_names) if len(axis_names) >= len(shape)
             else tuple(axis_names) + ("cols",))
    return make_mesh(shape, names, device=device)


def process_info() -> dict:
    """This rank's place: JAX's keys, one device per rank."""
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": int(os.environ.get("LOCAL_WORLD_SIZE", 1)),
        "global_devices": dist.get_world_size(),
    }
