"""Best-kernel dispatch for the serving path, every format.

Counterpart of ``tpuspmm/kernels/dispatch.py::spmm_pallas``, in its
order:

1. a matrix that needs the compensated path and can afford it routes
   there (``ops/exact.py``);
2. a BSR whose blocks K6 admits (``bsr_spmm.mxu_friendly``) takes the
   block-streaming kernel; another BSR takes it on its 128 × 128 packed
   copy where ``bsr_spmm.pack_blocks`` allows one ("bsr_stream"); any
   other BSR, and every ELL or CSC, goes down the steps below through its
   COO view, as in the JAX package;
3. density ≥ densify_min_density with dense A ≤ densify_max_bytes →
   densify once and serve one f32 matmul (``ops/xla.py``);
4. the panel (K1) and pair (K2) geometries are resolved with this
   device's cost constants, within its panel_max_plan_bytes, and the
   lower modelled serve time serves, at
   the "highest" tier whatever ``config.precision_mode`` says (as the JAX
   package does: the 2-term tier is verified-only);
5. with ≥ tile_min_nnz_per_chunk nonzeros per tile-plan chunk, the tile
   family by residency: staged (K4) when the whole B stripe stages in
   one slab, else C-resident (K5a) when an owner's accumulator fits, else
   tile (K3), at ``config.precision_mode``.  An owner's accumulator is
   tile_m × 64 f32, so on an H100 (232,448 bytes of opt-in shared memory
   per block) the tile branch is reached only when tile_m > 908;
6. otherwise the gather path (``ops/xla.py``).
"""

from __future__ import annotations

import torch

from tpuspmm_torch.engine.report import hbm_gbps
from tpuspmm_torch.kernels.common import round_up

# The H100 row: every key of the JAX package's per-chip row
# (``tpuspmm/kernels/dispatch.py::_CHIP_THRESHOLDS``), each one measured
# on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi).
# - densify_min_density, densify_max_bytes, tile_min_nnz_per_chunk,
#   panel_max_plan_bytes and panel_gather_gbps: tools/fit_routing.py from
#   tools/routing_h100.jsonl (244 records), serve times through
#   tpuspmm_torch.spmm on both sides of each constant (CUDA events,
#   median of 20 serves, plan prebuilt), measured under this row:
#   - densify_min_density: least regret over 116 records (uniform 2048²
#     and 4096² at 0.0005-0.2, w256 / w1024; the pruned 4096² weights;
#     the corpus; f32 and bf16 B), the measured density of
#     uniform_4096_d0.001 (geometric-mean regret 1.135);
#   - densify_max_bytes: densify is least regret on dense A of 64 and
#     256 MiB and not at 1 GiB;
#   - tile_min_nnz_per_chunk: least regret over 72 records, the tile
#     family against the gather path: the fewest nonzeros per chunk
#     measured (uniform_16384_r4); the tile family won every record;
#   - panel_max_plan_bytes: the largest panel plan measured serving
#     faster than the route the cap below it gives (8192² at 0.016 and,
#     with bf16 B, 0.2);
#   - panel_gather_gbps: the un-permute's row gather, 20000 × 256 f32,
#     bytes read and written over its median time.
# - panel_step_us (per panel or pair chunk), panel_strip_us (per strip)
#   and panel_hbm_gbps (the plan stream's effective rate): tools/
#   fit_panel_model.py from tools/ablate_panel_h100.jsonl, 55 gate-passing
#   panel "highest" records of 5 matrices at B width 256, device time
#   (the launch replayed in a CUDA graph), residual RMS 0.0885 ms on
#   0.107-0.624 ms launches.  The residual is large because the strip
#   kernel's time follows its (64-row group, k-tile) entries and B
#   traffic, which the model does not count (PERF.md).  So the fitted
#   panel_hbm_gbps is a cost term (JAX's name), not the card's memory
#   rate: a roofline reads engine/report.hbm_gbps instead.
# The row was measured on the SXM part; other H100s read it too.  The
# "cpu" row is the same row, so the CPU tests pick the route the card
# picks.
H100_FIT = {"densify_max_bytes": 268435456,
            "densify_min_density": 0.0009999275207519531,
            "tile_min_nnz_per_chunk": 4.069547938400397,
            "panel_max_plan_bytes": 268435456,
            "panel_step_us": 0.022, "panel_strip_us": 0.01041,
            "panel_hbm_gbps": 221.4,
            "panel_gather_gbps": 1238.5}


def thresholds(device="cpu") -> dict:
    """Routing and cost constants for ``device``: the H100 row, for a CPU
    device and for a CUDA device whose card is on record
    (``engine/report.HBM_GBPS``).  Another card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        hbm_gbps(torch.cuda.get_device_name(device))  # an unknown card raises
    elif device.type != "cpu":
        raise ValueError(f"no cost constants for device {device}")
    return dict(H100_FIT)


def route(a, b: torch.Tensor, config=None) -> str:
    """The path ``spmm_pallas`` serves (a, b) by: "exact", "bsr_stream",
    "densify", "panel", "pair", "staged", "cres", "tile" or "xla".
    Resolves (and caches) the packed BSR, the geometries and the tile plan
    it needs."""
    return _resolve(a, b, config)[0]


def _resolve(a, b: torch.Tensor, config=None):
    """(route, what that route serves from: the BSR K6 runs on, a panel or
    pair plan, a tile plan, or None)."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.formats.tiles import plan_from_container
    from tpuspmm_torch.kernels import (bsr_spmm, cres_spmm, csr_vmem,
                                       pair_spmm, panel_spmm)
    from tpuspmm_torch.ops import exact

    config = config or default_config()
    if exact.needs_compensated(a) and exact.exact_admissible(a):
        return "exact", None
    if a.format_name == "bsr":
        served = bsr_spmm.stream_operand(a)
        if served is not None:
            return "bsr_stream", served

    th = thresholds(b.device)
    m, k = a.shape
    if (m * k * 4 <= th["densify_max_bytes"]
            and a.sparsity >= th["densify_min_density"]):
        return "densify", None

    n_pad = round_up(int(b.shape[1]), 128)
    cap = th["panel_max_plan_bytes"]
    geom = panel_spmm.resolve_panel_geometry(
        a, n_pad, panel_strips=config.panel_strips, plan_bytes_cap=cap,
        device=b.device, b_dtype=b.dtype)
    pgeom = pair_spmm.resolve_pair_geometry(a, n_pad, plan_bytes_cap=cap,
                                            device=b.device, b_dtype=b.dtype)
    if (geom is not None and pgeom is not None
            and pgeom.cost_us < geom.cost_us):
        geom = None  # pair's modelled serve time wins
    if geom is not None:
        return "panel", panel_spmm.panel_plan_from_geometry(a, geom)
    if pgeom is not None:
        return "pair", pair_spmm.pair_plan_from_container(
            a, chunk_strips=pgeom.chunk_strips, n_pad=n_pad, geom=pgeom,
            device=b.device)

    plan = plan_from_container(a, tile_m=config.tile_m,
                               tile_k=config.tile_k, chunk=config.chunk_nnz)
    if a.nnz / max(plan.num_chunks, 1) >= th["tile_min_nnz_per_chunk"]:
        k_pad = plan.num_k_tiles * plan.tile_k
        if csr_vmem.fits_whole_b(k_pad, plan.tile_m, plan.tile_k, b.device):
            return "staged", plan
        if cres_spmm.fits_card_out(plan.tile_m, b.device):
            return "cres", plan
        return "tile", plan
    return "xla", None


def spmm_pallas(a, b: torch.Tensor, config=None) -> torch.Tensor:
    """Best-strategy SpMM (the "pallas" / "auto" path) on b's device."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.kernels import (bsr_spmm, cres_spmm, csr_vmem,
                                       pair_spmm, panel_spmm, tile_spmm)
    from tpuspmm_torch.ops import exact, xla

    config = config or default_config()
    b = b.contiguous()
    kind, plan = _resolve(a, b, config)
    mode = config.precision_mode
    if kind == "exact":
        return exact.spmm_exact(a, b)
    if kind == "bsr_stream":
        return bsr_spmm.spmm_bsr_stream(plan, b)
    if kind == "densify":
        return xla.spmm_densify_cached(a, b)
    if kind == "panel":
        return panel_spmm.spmm_panel(plan, b)
    if kind == "pair":
        return pair_spmm.spmm_pair(plan, b)
    if kind == "staged":
        return csr_vmem.spmm_staged(plan, b, mode=mode)
    if kind == "cres":
        return cres_spmm.spmm_cres(plan, b, mode=mode)
    if kind == "tile":
        return tile_spmm.spmm_tiles(plan, b, mode=mode)
    return xla.spmm_xla(a, b)
