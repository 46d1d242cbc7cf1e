"""Format selection (``--auto``): counterpart of
``tpuspmm/engine/select.py``.

``analyze`` takes the JAX package's statistics of the sparsity pattern
(from the COO view), and ``select_format`` its rules in its order:

- fill of the non-empty (8, 128) blocks > 0.5 → BSR block streaming;
- density ≥ the densify floor with an affordable dense A → CSR densify;
- tile occupancy > 0.25 or density > 0.02 → CSR C-resident;
- even, short rows (cv < 0.5, max ≤ 4·mean) → ELL gather;
- else CSR gather.

The one difference is the C-resident rule: the JAX package's reads its
8 MiB VMEM budget (``fits_vmem_out`` on the whole padded C), this one the
card's (``cres_spmm.fits_card_out``: one owner's accumulator in a block's
shared memory), which admits every output size.  Where the whole C misses
JAX's budget, JAX selects the tile kernel and the port C-resident.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparsityStats:
    shape: Tuple[int, int]
    nnz: int
    density: float
    row_nnz_mean: float
    row_nnz_max: int
    row_nnz_cv: float         # coefficient of variation of row lengths
    block_fill_8x128: float   # nnz density within non-empty (8, 128) blocks
    nonempty_tiles_128: int   # non-empty (128, 128) tiles
    tile_occupancy: float     # nnz / (non-empty tiles · 128)


def analyze(a) -> SparsityStats:
    from tpuspmm_torch.ops.xla import coo_view

    coo = coo_view(a)
    r = np.asarray(coo.rows, dtype=np.int64)
    c = np.asarray(coo.cols, dtype=np.int64)
    m, k = coo.shape
    nnz = len(r)
    row_counts = np.bincount(r, minlength=m)
    mean = row_counts.mean() if m else 0.0
    cv = float(row_counts.std() / mean) if mean > 0 else 0.0

    def block_stats(bh, bw):
        ids = (r // bh) * (-(-k // bw)) + (c // bw)
        nonempty = len(np.unique(ids))
        cap = nonempty * bh * bw
        return nonempty, (nnz / cap if cap else 0.0)

    _, fill8 = block_stats(8, 128)
    ne128, _ = block_stats(128, 128)
    return SparsityStats(
        shape=(m, k), nnz=nnz, density=nnz / (m * k) if m * k else 0.0,
        row_nnz_mean=float(mean),
        row_nnz_max=int(row_counts.max()) if m else 0, row_nnz_cv=cv,
        block_fill_8x128=float(fill8), nonempty_tiles_128=int(ne128),
        tile_occupancy=float(nnz / (ne128 * 128.0) if ne128 else 0.0))


def select_format(a, device="cpu") -> Tuple[str, str]:
    """(format, variant name) recommended for this matrix.  A CPU
    ``device`` reads the H100's figures."""
    from tpuspmm_torch.kernels.dispatch import thresholds

    stats = analyze(a)
    if stats.block_fill_8x128 > 0.5:
        return "bsr", "pallas_block_stream"
    th = thresholds(device)
    if (stats.density >= th["densify_min_density"]
            and stats.shape[0] * stats.shape[1] * 4
            <= th["densify_max_bytes"]):
        return "csr", "xla_densify_matmul"
    if stats.tile_occupancy > 0.25 or stats.density > 0.02:
        # the card's C-resident rule admits every output size
        return "csr", "pallas_c_resident"
    if (stats.row_nnz_cv < 0.5
            and stats.row_nnz_max <= 4 * max(stats.row_nnz_mean, 1.0)):
        return "ell", "xla_segment_sum"
    return "csr", "xla_segment_sum"


def auto_spmm(a, b, config=None):
    """Select, convert and run the selected variant on b's device; where
    it does not admit this operand, the dispatcher serves.  Returns
    (result, format, variant name or "dispatch")."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import dispatch

    config = config or default_config()
    fmt, name = select_format(a, device=b.device)
    if a.format_name != fmt:
        a = convert.to_format(a, fmt)
    variant = next(v for v in get_engine(fmt).variants if v.name == name)
    if variant.admissible is not None and not variant.admissible(a, b,
                                                                 config):
        return dispatch.spmm_pallas(a, b, config), fmt, "dispatch"
    return variant.fn(a, b, config), fmt, name
