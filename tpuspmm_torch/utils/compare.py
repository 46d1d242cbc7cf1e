"""Correctness gate: torch.allclose semantics |a - b| <= atol + rtol·|b| at
the reference's tolerances (REL_TOL=1e-2, ABS_TOL=1e-3)."""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def allclose(result, reference, rel_tol: float = 1e-2,
             abs_tol: float = 1e-3) -> bool:
    result, reference = _f64(result), _f64(reference)
    if result.shape != reference.shape:
        return False
    return bool(np.allclose(result, reference, rtol=rel_tol, atol=abs_tol))


def max_abs_err(result, reference) -> float:
    return float(np.max(np.abs(_f64(result) - _f64(reference))))
