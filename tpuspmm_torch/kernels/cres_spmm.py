"""C-resident SpMM over the k-major tile plan (kernels K5a and K5b).

Counterpart of ``tpuspmm/kernels/cres_spmm.py``.  The TPU kernels keep the
whole output in VMEM and stream the chunks k-major, so each B panel is
fetched once:

- block8 (K5a): chunks padded per k tile to multiples of 8 with rt -1
  sentinel chunks; one grid step per 8-chunk block shares one B panel;
- kloop (K5b): one grid step per k tile, looping over exactly that tile's
  chunks (no sentinels); the split tiers only.

On the card (``csrc/chunk_spmm.cu``, ``cres_chunk_spmm`` and
``cres_kloop_chunk_spmm``) nothing carries over between blocks, so each
output tile has one owner block that walks its row tile's chunks,
accumulating in shared memory and storing once; C lives in device memory,
written once.  Both k-major layouts list each row tile's chunks in
ascending k tile, the row-major plan's order, so the owner walks the
row-major plan (:func:`tile_spmm.owner_arrays`): K5a, K5b and K3 are one
kernel on the card, with bit-identical outputs, under three entries and
counters.  K5's own mechanism, one B panel shared by the chunks of a k
tile, does not carry over yet (ROADMAP Queue 2).  The k-major layouts
serve the plain versions, which walk them in the TPU's grid order.

**Admission on the card.**  What must be resident is one owner's
accumulator, tile_m × TN × 4 bytes of shared memory (32 KiB at tile_m =
128), not the whole C: every output size is admitted while that fits the
card's opt-in shared memory per block.  The JAX package's ``fits_vmem_out``
/ ``fits_vmem_loop`` (C plus panels, or C plus the whole payload, within
8 / 13 MiB of v5e VMEM) admit far fewer matrices; the engine's records
carry the card's rule.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuspmm_torch.formats.tiles import TilePlan, plan_from_container
from tpuspmm_torch.kernels.chunk_cuda import COLUMN_TILE
from tpuspmm_torch.kernels.csr_vmem import smem_optin
from tpuspmm_torch.kernels.tile_spmm import (check_mode, check_operand,
                                             owner_arrays, walk_plain)

SCHEDULES = ("auto", "block8", "kloop")


def fits_card_out(tile_m: int, device) -> bool:
    """The card's C-resident rule: one owner's (tile_m × TN) f32
    accumulator fits the opt-in shared memory of a block on ``device``."""
    return tile_m * COLUMN_TILE * 4 <= smem_optin(device)


def _kmajor_order(plan: TilePlan):
    order = np.lexsort((plan.rt, plan.kt))
    return (plan.rt[order], plan.kt[order], plan.rows[order],
            plan.cols[order], plan.vals[order])


def _kmajor_loop(plan: TilePlan) -> dict:
    """Chunk payloads sorted k-major with per-k-tile [start, end) chunk
    ranges, no sentinel padding (numpy; cached on the plan)."""
    def build():
        rt, kt, rows, cols, vals = _kmajor_order(plan)
        bounds = np.searchsorted(kt, np.arange(plan.num_k_tiles + 1)).astype(
            np.int32)
        return {"start": bounds[:-1], "end": bounds[1:],
                "rt": rt.astype(np.int32), "rows": rows, "cols": cols,
                "vals": vals}

    return plan.derived("kmajor_loop", build)


def _kmajor_blocks(plan: TilePlan) -> dict:
    """Chunk payloads sorted k-major and padded per k-tile group to
    multiples of 8 with rt -1 sentinel chunks; kt8 per 8-chunk block
    (numpy; cached on the plan).  An empty plan is one all-sentinel
    block."""
    def build():
        C, E = plan.num_chunks, plan.chunk
        rt, kt, rows, cols, vals = _kmajor_order(plan)
        gb = np.flatnonzero(np.diff(kt)) + 1
        starts = np.concatenate([[0], gb]) if C else np.zeros(0, np.int64)
        ends = np.concatenate([gb, [C]]) if C else np.zeros(0, np.int64)
        o_rt, o_rows, o_cols, o_vals, kt8 = [], [], [], [], []
        for s, e in zip(starts, ends):
            n = int(e - s)
            pad = (-n) % 8
            o_rt.append(rt[s:e])
            o_rows.append(rows[s:e])
            o_cols.append(cols[s:e])
            o_vals.append(vals[s:e])
            if pad:
                o_rt.append(np.full(pad, -1, np.int32))
                o_rows.append(np.full((pad, E), -1, np.int32))
                o_cols.append(np.zeros((pad, E), np.int32))
                o_vals.append(np.zeros((pad, E), np.float32))
            kt8.extend([int(kt[s])] * ((n + pad) // 8))
        if not kt8:
            o_rt = [np.full(8, -1, np.int32)]
            o_rows = [np.full((8, E), -1, np.int32)]
            o_cols = [np.zeros((8, E), np.int32)]
            o_vals = [np.zeros((8, E), np.float32)]
            kt8 = [0]
        return {"rt8": np.concatenate(o_rt),
                "kt8": np.asarray(kt8, np.int32),
                "rows": np.concatenate(o_rows),
                "cols": np.concatenate(o_cols),
                "vals": np.concatenate(o_vals)}

    return plan.derived("kmajor_blocks", build)


def _block8_layout(plan: TilePlan) -> dict:
    """The block8 layout with kt per chunk (each block's kt8)."""
    blk = _kmajor_blocks(plan)
    return {"rt": blk["rt8"], "kt": np.repeat(blk["kt8"], 8),
            "rows": blk["rows"], "cols": blk["cols"], "vals": blk["vals"]}


def _kloop_layout(plan: TilePlan) -> dict:
    """The kloop layout with kt per chunk (from its k-tile ranges)."""
    lp = _kmajor_loop(plan)
    kt = np.repeat(np.arange(plan.num_k_tiles, dtype=np.int32),
                   lp["end"] - lp["start"])
    return {"rt": lp["rt"], "kt": kt, "rows": lp["rows"],
            "cols": lp["cols"], "vals": lp["vals"]}


_LAYOUTS = {"block8": _block8_layout, "kloop": _kloop_layout}


def cres_spmm_plain(plan: TilePlan, b: torch.Tensor, mode: str = "split",
                    schedule: str = "block8") -> torch.Tensor:
    """Plain version of K5a ("block8") or K5b ("kloop") on b's device: the
    k-major layout walked in its order (the TPU's grid order) into a zeroed
    C, sentinel chunks dropped."""
    arrs = plan.device_arrays(b.device, ("cres_plain", schedule),
                              lambda: _LAYOUTS[schedule](plan))
    out = walk_plain(arrs["rt"], arrs["kt"].long() * plan.tile_k,
                     arrs["rows"], arrs["cols"], arrs["vals"], b,
                     plan.padded_shape[0], plan.tile_m, plan.tile_k, mode)
    return out[:plan.shape[0]]


def spmm_cres(a_or_plan, b: torch.Tensor, mode: str = "split",
              schedule: str = "auto") -> torch.Tensor:
    """Container- or plan-level entry of the C-resident kernels.

    ``schedule``: "block8" (K5a, all tiers), "kloop" (K5b, "split" and
    "split2" only, as in the JAX package), or "auto" (block8, as there).
    On a CUDA tensor it launches ``cres_chunk_spmm`` /
    ``cres_kloop_chunk_spmm`` or raises; on a CPU tensor it runs
    :func:`cres_spmm_plain`."""
    split2 = check_mode(mode)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    if schedule == "auto":
        schedule = "block8"
    if schedule == "kloop" and mode not in ("split", "split2"):
        # the TPU's kloop kernel implements the bf16 split tiers only
        raise ValueError(
            f"schedule='kloop' supports mode 'split'/'split2', not "
            f"{mode!r}; use schedule='block8'")
    plan = (a_or_plan if isinstance(a_or_plan, TilePlan)
            else plan_from_container(a_or_plan))
    check_operand(plan, b)
    if not fits_card_out(plan.tile_m, b.device):
        raise ValueError(
            f"a ({plan.tile_m} x {COLUMN_TILE}) f32 accumulator exceeds the "
            "shared memory of a block; use spmm_tiles")
    if b.device.type == "cpu":
        return cres_spmm_plain(plan, b, mode, schedule)
    from tpuspmm_torch.kernels import chunk_cuda

    entry = ("cres_chunk_spmm" if schedule == "block8"
             else "cres_kloop_chunk_spmm")
    out = chunk_cuda.owner_walk(entry, owner_arrays(plan, b.device),
                                b.contiguous(), plan.shape[0], plan.tile_m,
                                plan.tile_k, plan.chunk, split2)
    counter = spmm_cres if schedule == "block8" else spmm_cres_kloop
    counter.launches += 1
    return out


def spmm_cres_kloop(a_or_plan, b: torch.Tensor,
                    mode: str = "split") -> torch.Tensor:
    """K5b's own entry: :func:`spmm_cres` with ``schedule="kloop"``.  Its
    ``launches`` counts the kloop kernel's launches through either."""
    return spmm_cres(a_or_plan, b, mode=mode, schedule="kloop")


spmm_cres.launches = 0
spmm_cres_kloop.launches = 0


def residency(plan: TilePlan, device) -> dict:
    """The C-resident rule's outcome for a record."""
    return {"rule": "one owner's accumulator in opt-in shared memory",
            "smem_optin_bytes": smem_optin(device),
            "accumulator_bytes": plan.tile_m * COLUMN_TILE * 4}
