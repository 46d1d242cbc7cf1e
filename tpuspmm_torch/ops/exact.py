"""Routing test for the compensated SpMM of extreme-value matrices.

Counterpart of the routing half of ``tpuspmm/ops/exact.py``.  Above
``EXTREME_ABS_VALUE`` one float32 product's rounding (eps ~6e-8 relative)
can exceed the gate's absolute tolerance of 1e-3, so a plain-f32 result
passes the gate only by luck of the operand.  The dispatcher routes such a
matrix to the compensated path when that path is affordable.  The path
itself is not yet ported (ROADMAP Queue 1 item 9): the dispatcher raises.
"""

from __future__ import annotations

import numpy as np

from tpuspmm_torch.formats.base import container_cache

EXTREME_ABS_VALUE = 2.0e4

# Affordability caps of the (m, W)-padded compensated pass (W = max row nnz,
# 8 B per slot for column index and value).
EXACT_MAX_SLOT_BYTES = 256 * 1024 * 1024
EXACT_MAX_PAD_RATIO = 32.0


def needs_compensated(a) -> bool:
    """True when plain-f32 products can breach the abs-1e-3 gate for this
    matrix (cached on the container)."""
    cache = container_cache(a)
    if "max_abs_value" not in cache:
        vals = np.asarray(a.values)
        cache["max_abs_value"] = (float(np.max(np.abs(vals)))
                                  if vals.size else 0.0)
    return cache["max_abs_value"] > EXTREME_ABS_VALUE


def _max_row_nnz(a) -> int:
    if a.format_name == "csr":
        ip = np.asarray(a.indptr, dtype=np.int64)
        return int(np.diff(ip).max()) if len(ip) > 1 else 0
    r = np.asarray(a.rows)
    return int(np.bincount(r, minlength=a.shape[0]).max()) if r.size else 0


def exact_admissible(a) -> bool:
    """True when the (m, W)-padded compensated pass is affordable for this
    matrix (slot-array bytes and padding blow-up within the caps)."""
    m = a.shape[0]
    w = max(_max_row_nnz(a), 1)
    if m * w * 8 > EXACT_MAX_SLOT_BYTES:
        return False
    return m * w <= EXACT_MAX_PAD_RATIO * max(a.nnz, 1)
