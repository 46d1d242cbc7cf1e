"""The compensated SpMM of extreme-value matrices, and its routing test.

Counterpart of ``tpuspmm/ops/exact.py``.  Above ``EXTREME_ABS_VALUE`` one
float32 product's rounding (eps ~6e-8 relative) can exceed the gate's
absolute tolerance of 1e-3, so a plain-f32 result passes the gate only by
luck of the operand.  The dispatcher routes such a matrix to
``spmm_exact`` when it is affordable (``exact_admissible``).

The JAX package's Dekker / TwoSum error-free transformations exist only
because the TPU has no float64.  The card has it: ``spmm_exact`` upcasts
the values and B to float64, gathers and adds with ``index_add_`` in
float64, and returns float32, the reference's own f64 accumulation.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache

EXTREME_ABS_VALUE = 2.0e4

# Affordability caps of the JAX package's (m, W)-padded compensated pass
# (W = max row nnz, 8 B per slot for column index and value).  The f64
# path here has no slot arrays; the caps are kept so that both packages
# route the same matrices to it.
EXACT_MAX_SLOT_BYTES = 256 * 1024 * 1024
EXACT_MAX_PAD_RATIO = 32.0


def needs_compensated(a) -> bool:
    """True when plain-f32 products can breach the abs-1e-3 gate for this
    matrix (cached on the container)."""
    cache = container_cache(a)
    if "max_abs_value" not in cache:
        vals = np.asarray(a.blocks if a.format_name == "bsr" else a.values)
        cache["max_abs_value"] = (float(np.max(np.abs(vals)))
                                  if vals.size else 0.0)
    return cache["max_abs_value"] > EXTREME_ABS_VALUE


def _max_row_nnz(a) -> int:
    """W, the JAX package's way: exact for CSR and COO, the upper bound
    (densest block row) × bw for BSR, through the COO view otherwise."""
    if a.format_name in ("csr", "bsr"):
        ip = np.asarray(a.indptr, dtype=np.int64)
        w = int(np.diff(ip).max()) if len(ip) > 1 else 0
        return w * a.block_size[1] if a.format_name == "bsr" else w
    from tpuspmm_torch.ops.xla import coo_view

    r = np.asarray(coo_view(a).rows)
    return int(np.bincount(r, minlength=a.shape[0]).max()) if r.size else 0


def exact_admissible(a) -> bool:
    """True when the (m, W)-padded compensated pass is affordable for this
    matrix (slot-array bytes and padding blow-up within the caps)."""
    m = a.shape[0]
    w = max(_max_row_nnz(a), 1)
    if m * w * 8 > EXACT_MAX_SLOT_BYTES:
        return False
    return m * w <= EXACT_MAX_PAD_RATIO * max(a.nnz, 1)


def spmm_exact(a, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B accumulated in float64 on b's device, returned as float32
    (the float64 triplets are moved to the device once and cached)."""
    from tpuspmm_torch.ops import xla

    coo = xla.coo_view(a)
    rows, cols, vals = xla.cached_device(
        coo, "exact_triplets", b.device,
        lambda: (coo.rows, coo.cols, np.asarray(coo.values, np.float64)))
    return xla.spmm_triplets(rows, cols, vals, b.double(),
                             a.shape[0]).float()
