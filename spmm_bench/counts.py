"""Operations, least bytes and the published peaks: the benchmark's own
arithmetic, independent of the program it measures.

The counts depend only on the operand, B's width and B's dtype, whatever
kernel serves the call:

- operations: 2 · stored entries · N (a BSR block counts all its entries);
- least bytes: A's stored values (f32) once, one int32 index a stored
  entry (a block for BSR) and the row pointer once, each B row that a
  stored entry reads once at B's dtype, and C once as f32.

A card missing from ``PEAKS`` has no least time: the caller fails rather
than guess a peak.
"""

from __future__ import annotations

import dataclasses

# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3 bytes a second and
# dense tensor-core operations a second by B's dtype (an f32 B at the TF32
# rate, the fastest rate an f32 product has on the card)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "power_limit_w": 700.0,
        "hbm_bytes_per_s": 3.35e12,
        "flops_per_s": {"float32": 495e12, "bfloat16": 989e12},
    },
}

VALUE_BYTES = 4   # A's values and C, f32
INDEX_BYTES = 4   # int32 indices and row pointers
B_BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class OperandCounts:
    """What the counts read of one operand."""
    rows: int
    cols: int
    stored: int         # stored entries (a BSR block's all)
    indices: int        # column indices (one a block for BSR)
    pointers: int       # row-pointer entries (block rows + 1 for BSR)
    touched_cols: int   # columns holding a stored entry: B rows read


def flops(c: OperandCounts, n: int) -> int:
    return 2 * c.stored * n


def min_bytes(c: OperandCounts, n: int, b_dtype: str) -> int:
    return (c.stored * VALUE_BYTES + (c.indices + c.pointers) * INDEX_BYTES
            + c.touched_cols * n * B_BYTES[b_dtype]
            + c.rows * n * VALUE_BYTES)


def peak(card: str) -> dict:
    """The card's published peaks; raises for a card not in the table."""
    try:
        return PEAKS[card]
    except KeyError:
        raise KeyError(f"no published peaks for {card!r}; known: "
                       f"{sorted(PEAKS)}") from None


def least_seconds(c: OperandCounts, n: int, b_dtype: str, card: str) -> float:
    """The least time of one call on the card: the larger of its least
    bytes over the memory rate and its operations over the dense peak of
    B's dtype."""
    p = peak(card)
    return max(min_bytes(c, n, b_dtype) / p["hbm_bytes_per_s"],
               flops(c, n) / p["flops_per_s"][b_dtype])
