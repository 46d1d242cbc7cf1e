"""Best-kernel dispatch for the CSR / COO serving path.

Counterpart of ``tpuspmm/kernels/dispatch.py::spmm_pallas``, in its
order:

1. a matrix that needs the compensated path and can afford it routes
   there (not yet ported: raises);
2. BSR input takes the block-streaming kernel (not yet ported: raises);
3. the panel (K1) and pair (K2) geometries are resolved with this
   device's cost constants, and the lower modelled serve time serves;
4. otherwise the one-hot / gather fall-through (not yet ported: raises).

The JAX package's densify branch is not in this slice: a dense-ish matrix
goes on to the panel or pair kernel here (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from tpuspmm_torch.engine.report import HBM_GBPS, hbm_gbps
from tpuspmm_torch.kernels.common import round_up

# Cost-model constants of the panel and pair geometry searches.
# panel_step_us (per panel or chunk) and panel_strip_us (per strip) are
# not yet fitted on the H100: 0.0 until bench/fit_panel_model.py is ported
# and run there (ROADMAP).  With them at zero the model prices plan bytes
# alone.  The bandwidths are the card's data-sheet figure; the "cpu" row
# holds the H100 SXM's, so the CPU tests pick the geometry the card picks.
_UNFITTED = {"panel_step_us": 0.0, "panel_strip_us": 0.0}


def _row(gbps: float) -> dict:
    return dict(_UNFITTED, panel_hbm_gbps=gbps, panel_gather_gbps=gbps)


def thresholds(device="cpu") -> dict:
    """Cost constants for ``device``: the "cpu" row for a CPU device, the
    "h100" row (bandwidth by the card's name) for a CUDA device.  An
    unknown card raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return _row(HBM_GBPS["NVIDIA H100 80GB HBM3"])
    if device.type != "cuda":
        raise ValueError(f"no cost constants for device {device}")
    return _row(hbm_gbps(torch.cuda.get_device_name(device)))


def spmm_pallas(a, b: torch.Tensor, config=None) -> torch.Tensor:
    """Best-strategy SpMM (the "pallas" / "auto" path) on b's device."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm
    from tpuspmm_torch.ops import exact

    config = config or default_config()
    if exact.needs_compensated(a) and exact.exact_admissible(a):
        raise NotImplementedError(
            "this matrix needs the compensated (exact) path, which is not "
            "yet ported to tpuspmm_torch (ROADMAP Queue 1 item 9)")
    if a.format_name not in ("csr", "coo"):
        raise NotImplementedError(
            f"{a.format_name} input is not yet served by tpuspmm_torch "
            "(BSR: ROADMAP Queue 2 K6)")

    b = b.contiguous()
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
        plan = panel_spmm.panel_plan_from_geometry(a, geom)
        return panel_spmm.spmm_panel(plan, b, mode=config.precision_mode)
    if pgeom is not None:
        plan = pair_spmm.pair_plan_from_container(
            a, chunk_strips=pgeom.chunk_strips, n_pad=n_pad, geom=pgeom,
            device=b.device)
        return pair_spmm.spmm_pair(plan, b, mode=config.precision_mode)
    raise NotImplementedError(
        "no panel or pair plan fits PLAN_BYTES_CAP; the tile / staged / "
        "C-resident kernels and the gather path are not yet ported "
        "(ROADMAP Queue 2 K3-K5, Queue 1 item 9)")
