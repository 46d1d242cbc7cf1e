"""Public compute API: spmm, spmv, spmm_batched, spmm_transpose, spmm_fn.

Counterpart of ``tpuspmm/ops/api.py`` with its method names:

- "oracle"  — numpy float64 oracle (kernel 0)
- "vendor"  — torch.sparse CSR @ dense, cuSPARSE on the card (kernel -1)
- "pallas"  — the hand-written kernels through the dispatcher
  (``kernels/dispatch.py``): CUDA on a CUDA tensor, their plain versions
  on a CPU tensor
- "auto"    — the same dispatch, on whatever device B is on
- "xla"     — gather + ``index_add_`` (``ops/xla.py``)
- "exact"   — float64 accumulation, float32 result (``ops/exact.py``)
- "densify" — densify once (cached), one f32 matmul per call
- "tuned"   — the verified autotune (``engine/autotune.py``): every
  admissible variant measured once per (matrix, width, B dtype), the
  fastest that passes the gate served
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import profiler as torch_profiler

from tpuspmm_torch.utils import profiling


def _as_tensor(b, config=None) -> torch.Tensor:
    """A tensor keeps its device; a host array goes to ``config.device``,
    and a CUDA device that is not there raises."""
    if isinstance(b, torch.Tensor):
        return b
    from tpuspmm_torch.config import default_config

    config = config or default_config()
    device = torch.device(config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"spmm: no CUDA device for a host operand (Config.device="
            f"{config.device!r}); pass Config(device='cpu') to run on the "
            "CPU")
    return torch.from_numpy(np.ascontiguousarray(b, dtype=np.float32)).to(
        device)


def spmm(a, b, method: str = "auto", config=None) -> torch.Tensor:
    """Sparse @ dense.  `a` is a tpuspmm_torch container (CSR, COO, BSR,
    ELL or CSC), `b` a (K, N) torch tensor (f32 or bf16), served on its own
    device, or a numpy array, placed on ``config.device`` (the card unless
    the caller asks for the CPU); the result is a float32 tensor on b's
    device.  While a profiler records, the call is the span
    ``tpuspmm_torch.spmm`` (``utils/profiling.py``)."""
    if torch_profiler._is_profiler_enabled:
        with profiling.span("tpuspmm_torch.spmm"):
            return _spmm(a, b, method, config)
    return _spmm(a, b, method, config)


def _spmm(a, b, method: str, config) -> torch.Tensor:
    from tpuspmm_torch.config import default_config

    config = config or default_config()
    b = _as_tensor(b, config)
    if method in ("auto", "pallas"):
        from tpuspmm_torch.kernels import dispatch

        return dispatch.spmm_pallas(a, b, config)
    if method == "oracle":
        from tpuspmm_torch.ops import oracle

        ref = oracle.spmm_oracle(a, b.float().cpu().numpy())
        return torch.from_numpy(ref).to(b.device)
    if method == "vendor":
        from tpuspmm_torch.ops import vendor

        return vendor.spmm_vendor(a, b)
    if method in ("xla", "densify"):
        from tpuspmm_torch.ops import xla

        return (xla.spmm_xla(a, b) if method == "xla"
                else xla.spmm_densify_cached(a, b))
    if method == "exact":
        from tpuspmm_torch.ops import exact

        return exact.spmm_exact(a, b)
    if method == "tuned":
        from tpuspmm_torch.engine.autotune import spmm_tuned

        return spmm_tuned(a, b, config)
    raise ValueError(f"unknown method {method!r}")


def spmv(a, x, method: str = "auto", config=None) -> torch.Tensor:
    """Sparse @ vector: SpMM with N = 1.  A 1-D ``x`` gives a 1-D result;
    a 2-D one is an ordinary SpMM."""
    x = _as_tensor(x, config)
    if x.dim() != 1:
        return spmm(a, x, method=method, config=config)
    return spmm(a, x[:, None], method=method, config=config)[:, 0]


def spmm_batched(a, b, method: str = "auto", config=None) -> torch.Tensor:
    """One sparse operand against a stack of dense ones: ``b`` is (..., K,
    N), the result (..., M, N).  The batch is folded into the columns,
    (..., K, N) → (K, B·N), so one SpMM (one kernel launch) serves the
    whole stack and reads A's plan once, then unfolded."""
    b = _as_tensor(b, config)
    if b.dim() == 2:
        return spmm(a, b, method=method, config=config)
    if b.dim() < 2 or b.shape[-2] != a.shape[1]:
        raise ValueError(f"b must be (..., K={a.shape[1]}, N); got "
                         f"{tuple(b.shape)}")
    batch, (k, n) = b.shape[:-2], b.shape[-2:]
    flat = b.reshape(-1, k, n).movedim(0, 1).reshape(k, -1)
    out = spmm(a, flat, method=method, config=config)  # (M, B·N)
    m = out.shape[0]
    return out.reshape(m, -1, n).movedim(1, 0).reshape(*batch, m, n)


def transposed(a):
    """Aᵀ as a row-sorted COO, cached on ``a``; its plans, device tensors
    and tune ranking cache on it in turn, so a backward pays the
    transpose's preparation once per matrix."""
    from tpuspmm_torch.formats import COO
    from tpuspmm_torch.formats.base import container_cache
    from tpuspmm_torch.ops.xla import coo_view

    cache = container_cache(a)
    if "transposed" not in cache:
        coo = coo_view(a)
        cache["transposed"] = COO(
            rows=np.asarray(coo.cols), cols=np.asarray(coo.rows),
            values=np.asarray(coo.values),
            shape=(coo.shape[1], coo.shape[0])).sort_by_row()
    return cache["transposed"]


def spmm_transpose(a, b, method: str = "auto", config=None) -> torch.Tensor:
    """Aᵀ @ B (d/dB of A @ B is Aᵀ @ dC), through :func:`transposed`."""
    return spmm(transposed(a), b, method=method, config=config)


class _SpmmFunction(torch.autograd.Function):
    """C = A @ B with dB = Aᵀ @ dC; A is frozen (no gradient)."""

    @staticmethod
    def forward(ctx, b, a, method, config):
        ctx.a, ctx.method, ctx.config = a, method, config
        ctx.b_dtype = b.dtype
        return spmm(a, b, method=method, config=config)

    @staticmethod
    def backward(ctx, grad):
        g = spmm_transpose(ctx.a, grad.contiguous(), method=ctx.method,
                           config=ctx.config)
        return g.to(ctx.b_dtype), None, None, None


def spmm_fn(a, method: str = "auto", config=None):
    """A differentiable ``b -> A @ b`` over the sparse operand: the
    forward is :func:`spmm` (float32 out), the backward
    :func:`spmm_transpose` of the incoming gradient, in B's dtype.  A gets
    no gradient (frozen sparse weights, a trainable dense operand)."""
    def f(b):
        return _SpmmFunction.apply(_as_tensor(b, config), a,
                                   method, config)

    return f
