"""The plain reference: C = A @ B from the benchmark's own arrays, in plain
torch, and the comparison that decides ``correct``.

It imports nothing of the program and reads nothing the program made: the
operands are made again from the seed (``operands.build``), and B is the
benchmark's own pool.  ``product`` works in blocks of stored entries (CSR)
or blocks (BSR), so that it fits beside the kept outputs:

- at float64 it is the reference;
- with ``control`` set it is the control: the precision one step below
  the serve's, which is B's dtype, for both operands, the products and
  sums in f32 with TF32 off.  An f32 serve's control is ``"tf32"``: A and
  B rounded to TF32 (10 mantissa bits, to nearest even), as TF32 tensor
  cores round their inputs.  A bf16 serve's is ``"fp8"``: each operand
  scaled so its largest magnitude is e4m3's largest, rounded to e4m3 and
  scaled back, as an fp8 product with per-tensor scales takes them.  A
  correct serve must stay well clear of it.

The number compared is ``max_rel_err``: the largest gap of an output from
the reference, over the reference's largest magnitude.
"""

from __future__ import annotations

import contextlib
import math

import torch

# bytes a block of the reference's partial products may take
CHUNK_BYTES = 1 << 29


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 values through e4m3 with one scale for the tensor: its largest
    magnitude goes to e4m3's largest (448)."""
    x = x.float()
    top = float(x.abs().max()) if x.numel() else 0.0
    if top == 0.0:
        return x.clone()
    scale = 448.0 / top
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


# the control of a serve, by B's dtype: the precision one step below it
CONTROLS = {"float32": ("tf32", round_tf32),
            "bfloat16": ("fp8", round_fp8)}


@contextlib.contextmanager
def no_tf32():
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def product(op, b: torch.Tensor, control=None) -> torch.Tensor:
    """A @ B for an ``operands.Operand`` on b's device: float64, or in f32
    with both operands through ``control`` (a rounding of ``CONTROLS``)."""
    dtype = torch.float64 if control is None else torch.float32
    device = b.device
    values = op.values.to(device)
    b = b.to(device)
    if control is not None:
        values, b = control(values), control(b)
    values, b = values.to(dtype), b.to(dtype)
    indptr, indices = op.indptr.to(device), op.indices.to(device)
    m, k = op.shape
    n = int(b.shape[1])
    counts = torch.diff(indptr)
    with no_tf32():
        if op.block is None:
            rows = torch.repeat_interleave(
                torch.arange(m, device=device), counts)
            out = torch.zeros((m, n), dtype=dtype, device=device)
            step = max(1, CHUNK_BYTES // (8 * n))
            for s in range(0, int(values.numel()), step):
                sl = slice(s, s + step)
                out.index_add_(0, rows[sl],
                               values[sl, None] * b[indices[sl]])
            return out
        bh, bw = op.block
        nbr = m // bh
        brow = torch.repeat_interleave(
            torch.arange(nbr, device=device), counts)
        panels = b.reshape(k // bw, bw, n)
        out = torch.zeros((nbr, bh, n), dtype=dtype, device=device)
        step = max(1, CHUNK_BYTES // (8 * n * max(bh, bw)))
        for s in range(0, int(values.shape[0]), step):
            sl = slice(s, s + step)
            out.index_add_(0, brow[sl],
                           torch.bmm(values[sl], panels[indices[sl]]))
        return out.reshape(m, n)


def max_rel_err(c, ref: torch.Tensor) -> float:
    """max |C - ref| / max |ref|; infinite for an answer of another shape,
    a non-finite entry, or no answer at all."""
    if not isinstance(c, torch.Tensor) or tuple(c.shape) != tuple(ref.shape):
        return math.inf
    gap = (c.to(ref.device, torch.float64) - ref.double()).abs().max()
    scale = ref.abs().max().double()
    err = float(gap / torch.clamp(scale, min=1e-300))
    return err if math.isfinite(err) else math.inf
