"""Shared kernel utilities (counterpart of ``tpuspmm/kernels/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def split_bf16(x: torch.Tensor, terms: int = 3):
    """bf16 multi-term decomposition: x ≈ Σ parts, each part exactly
    representable in bf16.  Each term adds ~8 mantissa bits: 2 terms carry
    ~2^-17 relative fidelity, 3 terms ~2^-26."""
    parts = []
    rem = x.float()
    for i in range(terms):
        p = rem.to(torch.bfloat16)
        parts.append(p)
        if i + 1 < terms:
            rem = rem - p.float()
    return parts


def pad_b(b: torch.Tensor, k_pad: int, n_pad: int) -> torch.Tensor:
    """Zero-pad the dense operand to tile-aligned shape."""
    k, n = b.shape
    if k == k_pad and n == n_pad:
        return b
    return F.pad(b, (0, n_pad - n, 0, k_pad - k))
