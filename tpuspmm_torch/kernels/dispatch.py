"""Best-kernel dispatch for the CSR / COO serving path.

Counterpart of ``tpuspmm/kernels/dispatch.py::spmm_pallas``, in its
order:

1. a matrix that needs the compensated path and can afford it routes
   there (``ops/exact.py``);
2. BSR input takes the block-streaming kernel (not yet ported: raises);
3. density ≥ densify_min_density with dense A ≤ densify_max_bytes →
   densify once and serve one f32 matmul (``ops/xla.py``);
4. the panel (K1) and pair (K2) geometries are resolved with this
   device's cost constants, and the lower modelled serve time serves, at
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

from tpuspmm_torch.engine.report import HBM_GBPS, hbm_gbps
from tpuspmm_torch.kernels.common import round_up

# Routing and cost constants.
# - densify_max_bytes, densify_min_density and tile_min_nnz_per_chunk are
#   the JAX package's routing rule (its v5e row), not fitted on this card.
# - panel_step_us (per panel or chunk) and panel_strip_us (per strip) are
#   not yet fitted on the H100: 0.0 until bench/fit_panel_model.py is
#   ported and run there (ROADMAP).  With them at zero the model prices
#   plan bytes alone.
# The bandwidths are the card's data-sheet figure; the "cpu" row holds the
# H100 SXM's, so the CPU tests pick the route the card picks.
_UNFITTED = {"densify_max_bytes": 128 * 1024 * 1024,
             "densify_min_density": 0.004,
             "tile_min_nnz_per_chunk": 40.0,
             "panel_step_us": 0.0, "panel_strip_us": 0.0}


def _row(gbps: float) -> dict:
    return dict(_UNFITTED, panel_hbm_gbps=gbps, panel_gather_gbps=gbps)


def thresholds(device="cpu") -> dict:
    """Routing and cost constants for ``device``: the "cpu" row for a CPU
    device, the "h100" row (bandwidth by the card's name) for a CUDA
    device.  An unknown card raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return _row(HBM_GBPS["NVIDIA H100 80GB HBM3"])
    if device.type != "cuda":
        raise ValueError(f"no cost constants for device {device}")
    return _row(hbm_gbps(torch.cuda.get_device_name(device)))


def route(a, b: torch.Tensor, config=None) -> str:
    """The path ``spmm_pallas`` serves (a, b) by: "exact", "densify",
    "panel", "pair", "staged", "cres", "tile" or "xla".  Resolves (and
    caches) the geometries and the tile plan it needs."""
    return _resolve(a, b, config)[0]


def _resolve(a, b: torch.Tensor, config=None):
    """(route, what that route serves from: a panel or pair plan, a tile
    plan, or None)."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.formats.tiles import plan_from_container
    from tpuspmm_torch.kernels import (cres_spmm, csr_vmem, pair_spmm,
                                       panel_spmm)
    from tpuspmm_torch.ops import exact

    config = config or default_config()
    if exact.needs_compensated(a) and exact.exact_admissible(a):
        return "exact", None
    if a.format_name not in ("csr", "coo"):
        raise NotImplementedError(
            f"{a.format_name} input is not yet served by tpuspmm_torch "
            "(BSR: ROADMAP Queue 2 K6)")

    th = thresholds(b.device)
    m, k = a.shape
    if (m * k * 4 <= th["densify_max_bytes"]
            and a.sparsity >= th["densify_min_density"]):
        return "densify", None

    n_pad = round_up(int(b.shape[1]), 128)
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(
        a, n_pad, panel_strips=config.panel_strips, plan_bytes_cap=cap,
        device=b.device)
    pgeom = pair_spmm.resolve_pair_geometry(a, n_pad, plan_bytes_cap=cap,
                                            device=b.device)
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
    from tpuspmm_torch.kernels import (cres_spmm, csr_vmem, pair_spmm,
                                       panel_spmm, tile_spmm)
    from tpuspmm_torch.ops import exact, xla

    config = config or default_config()
    b = b.contiguous()
    kind, plan = _resolve(a, b, config)
    mode = config.precision_mode
    if kind == "exact":
        return exact.spmm_exact(a, b)
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
