"""Staged-B SpMM over the tile plan (kernel K4).

Counterpart of ``tpuspmm/kernels/csr_vmem.py``.  The TPU kernel pins B (or,
when B is too large, one slab_k-row stripe of it per grid step) in VMEM and
walks each row tile's chunks against it on a grid (row tile, slab): the
output block is written at slab 0 and added to after.

On the card (``csrc/chunk_spmm.cu``, ``staged_chunk_spmm``) this is shared-
memory B staging, the class of the original CUDA K4: block (rt, y) owns
output rows [rt·tm, +tm) and TN = 64 columns.  Per slab that holds a chunk
of its row tile, it stages the (slab_k × TN) B stripe in shared memory,
then runs that (rt, slab) chunk range from there, accumulating the (tm ×
TN) output tile in shared memory; it stores once.

**The staging rule on the card.**  A block's dynamic shared memory holds
the f32 accumulator (tile_m × TN × 4 bytes) and the f32 B stripe (slab_k ×
TN × 4 bytes).  slab_k is the largest multiple of tile_k that fits the
card's opt-in shared memory per block
(``torch.cuda.get_device_properties(dev).shared_memory_per_block_optin``)
after the accumulator, capped at the padded K.  On an H100 (232,448 bytes
opt-in) at tile_m = tile_k = 128: 232,448 − 32,768 = 199,680 bytes → 780
rows → slab_k = 768 (6 k tiles).  K ≤ 768 stages the whole B stripe (one
slab); medium_2048 at its on-disk width slabs 3 ways, medium_4096 6 ways,
large_25605 34 ways.  The rule admits every matrix whose accumulator leaves
room for one tile_k stripe, which the JAX package's 8 MiB VMEM budget does
not (its rule reads v5e constants): the engine's records carry the rule.
A CPU tensor reads the H100's figure, so the CPU tests plan what the card
runs.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuspmm_torch.formats.tiles import TilePlan, plan_from_container
from tpuspmm_torch.kernels.chunk_cuda import COLUMN_TILE
from tpuspmm_torch.kernels.common import round_up
from tpuspmm_torch.kernels.tile_spmm import (check_mode, check_operand,
                                             walk_plain)

# opt-in shared memory per block of an H100 (NVIDIA's data sheet; what
# cudaDevAttrMaxSharedMemoryPerBlockOptin reports there)
H100_SMEM_OPTIN = 232448


def smem_optin(device) -> int:
    """Opt-in shared memory per block of ``device`` (the H100's for a CPU
    device)."""
    device = torch.device(device)
    if device.type == "cpu":
        return H100_SMEM_OPTIN
    if device.type != "cuda":
        raise ValueError(f"{device} is neither a CUDA device nor the CPU: "
                         "no shared-memory figure")
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


def max_slab_k(k_pad: int, tile_m: int, tile_k: int, smem_bytes: int) -> int:
    """Largest B stripe height (a multiple of tile_k, ≤ k_pad) that fits a
    block's shared memory beside its accumulator; 0 when not even one
    tile_k stripe fits (→ inadmissible)."""
    avail = smem_bytes - tile_m * COLUMN_TILE * 4
    if avail <= 0:
        return 0
    slab = (avail // (COLUMN_TILE * 4)) // tile_k * tile_k
    return int(min(max(slab, 0), k_pad))


def slab_geometry(plan: TilePlan, device):
    """(num_slabs, slab_k) of the card's staging rule for this plan, or
    None when not one tile_k stripe fits."""
    k_pad = plan.num_k_tiles * plan.tile_k
    slab_k = max_slab_k(k_pad, plan.tile_m, plan.tile_k, smem_optin(device))
    if slab_k < plan.tile_k:
        return None
    return -(-k_pad // slab_k), slab_k


def fits_whole_b(k_pad: int, tile_m: int, tile_k: int, device) -> bool:
    """The dispatcher's staged rule: the whole B stripe (all of K) stages
    in one slab (the JAX package's whole-B ``fits_vmem``)."""
    return max_slab_k(k_pad, tile_m, tile_k, smem_optin(device)) >= k_pad


def _slab_arrays(plan: TilePlan, num_slabs: int, kts_per_slab: int) -> dict:
    """Chunk arrays stably reordered by (row tile, slab) plus per-(rt,
    slab) contiguous [start, end) ranges (numpy; cached on the plan).  The
    all-sentinel padding chunks (kt 0, last row tile) land in slab 0,
    where their sentinel rows contribute nothing."""
    def build():
        rt = np.asarray(plan.rt).astype(np.int64)
        kt = np.asarray(plan.kt)
        slab = np.minimum(kt // kts_per_slab, num_slabs - 1).astype(np.int64)
        keyv = rt * num_slabs + slab
        order = np.argsort(keyv, kind="stable")
        bounds = np.searchsorted(
            keyv[order], np.arange(plan.num_row_tiles * num_slabs + 1))
        return {"kt": np.asarray(plan.kt)[order],
                "start": bounds[:-1].astype(np.int32),
                "end": bounds[1:].astype(np.int32),
                "rows": np.asarray(plan.rows)[order],
                "cols": np.asarray(plan.cols)[order],
                "vals": np.asarray(plan.vals)[order]}

    return plan.derived(("slab", num_slabs, kts_per_slab), build)


def staged_spmm_plain(plan: TilePlan, b: torch.Tensor, num_slabs: int,
                      slab_k: int, mode: str = "split") -> torch.Tensor:
    """Plain version of K4 on b's device: the slab layout walked per (row
    tile, slab) range; each chunk's B panel is read at its slab's stripe
    offset plus its slab-local k tile."""
    kps = slab_k // plan.tile_k
    arrs = plan.device_arrays(
        b.device, ("slab", num_slabs, kps),
        lambda: _slab_arrays(plan, num_slabs, kps))
    lengths = (arrs["end"] - arrs["start"]).long()
    group = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=b.device), lengths)
    rt, s = group // num_slabs, group % num_slabs
    krow0 = s * slab_k + (arrs["kt"].long() - s * kps) * plan.tile_k
    out = walk_plain(rt, krow0, arrs["rows"], arrs["cols"], arrs["vals"], b,
                     plan.padded_shape[0], plan.tile_m, plan.tile_k, mode)
    return out[:plan.shape[0]]


def spmm_staged(a_or_plan, b: torch.Tensor,
                mode: str = "split") -> torch.Tensor:
    """Container- or plan-level entry of K4: the staging rule on b's
    device picks (num_slabs, slab_k); on a CUDA tensor it launches
    ``staged_chunk_spmm`` or raises, on a CPU tensor it runs
    :func:`staged_spmm_plain`."""
    split2 = check_mode(mode)
    plan = (a_or_plan if isinstance(a_or_plan, TilePlan)
            else plan_from_container(a_or_plan))
    check_operand(plan, b)
    geom = slab_geometry(plan, b.device)
    if geom is None:
        raise ValueError(
            f"not even one ({plan.tile_k} x {COLUMN_TILE}) B stripe fits "
            "beside the accumulator in shared memory; use spmm_tiles")
    num_slabs, slab_k = geom
    if b.device.type == "cpu":
        return staged_spmm_plain(plan, b, num_slabs, slab_k, mode)
    from tpuspmm_torch.kernels import chunk_cuda

    kps = slab_k // plan.tile_k
    arrs = plan.device_arrays(b.device, ("slab", num_slabs, kps),
                              lambda: _slab_arrays(plan, num_slabs, kps))
    out = chunk_cuda.staged(arrs, b.contiguous(), plan.shape[0],
                            plan.tile_m, plan.tile_k, plan.chunk, split2,
                            num_slabs, slab_k)
    spmm_staged.launches += 1
    return out


spmm_staged.launches = 0


def residency(plan: TilePlan, device) -> dict:
    """The staging rule's outcome for a record: the card's shared memory,
    slab height and slab count."""
    geom = slab_geometry(plan, device)
    return {"rule": "B stripe in opt-in shared memory",
            "smem_optin_bytes": smem_optin(device),
            "slab_k": None if geom is None else geom[1],
            "num_slabs": None if geom is None else geom[0],
            "k_pad": round_up(plan.shape[1], plan.tile_k)}
