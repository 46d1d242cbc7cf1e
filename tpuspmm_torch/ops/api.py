"""Public compute API: spmm.

Counterpart of ``tpuspmm/ops/api.py::spmm`` with its method names:

- "oracle"  — numpy float64 oracle (kernel 0)
- "vendor"  — torch.sparse CSR @ dense, cuSPARSE on the card (kernel -1)
- "pallas"  — the hand-written kernels through the dispatcher
  (``kernels/dispatch.py``): CUDA on a CUDA tensor, their plain versions
  on a CPU tensor
- "auto"    — the same dispatch, on whatever device B is on
- "xla", "exact", "densify", "tuned" — not yet ported (raise)
"""

from __future__ import annotations

import numpy as np
import torch

_NOT_YET = {
    "xla": "the gather / segment-sum paths (ROADMAP Queue 1 item 9)",
    "exact": "the compensated path (ROADMAP Queue 1 item 9)",
    "densify": "the densify path (ROADMAP Queue 1 item 9)",
    "tuned": "the verified autotune (ROADMAP Queue 1 item 7)",
}


def _as_tensor(b, config) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b
    b = torch.from_numpy(np.ascontiguousarray(b, dtype=np.float32))
    return b if config.device is None else b.to(config.device)


def spmm(a, b, method: str = "auto", config=None) -> torch.Tensor:
    """Sparse @ dense.  `a` is a tpuspmm_torch container, `b` a (K, N)
    torch tensor (f32 or bf16) or numpy array; the result is a float32
    tensor on b's device."""
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
    if method in _NOT_YET:
        raise NotImplementedError(
            f"method {method!r} is not yet ported to tpuspmm_torch: "
            f"{_NOT_YET[method]}")
    raise ValueError(f"unknown method {method!r}")
