"""Shared kernel utilities (counterpart of ``tpuspmm/kernels/common.py``)."""

from __future__ import annotations

import contextlib

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


def onehot_dot_split(onehot: torch.Tensor, parts) -> torch.Tensor:
    """Σ onehot @ part in float32 matmuls, one per split term, summed in
    term order (the TPU's single-pass bf16 MXU products with f32
    accumulation: the one-hot is 0/1 and every part is exact in f32)."""
    onehot = onehot.float()
    acc = torch.matmul(onehot, parts[0].float())
    for p in parts[1:]:
        acc = acc + torch.matmul(onehot, p.float())
    return acc


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full f32 on the card inside the block, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says outside it (the JAX
    package's Precision.HIGHEST)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def pad_b(b: torch.Tensor, k_pad: int, n_pad: int) -> torch.Tensor:
    """Zero-pad the dense operand to tile-aligned shape."""
    k, n = b.shape
    if k == k_pad and n == n_pad:
        return b
    return F.pad(b, (0, n_pad - n, 0, k_pad - k))
