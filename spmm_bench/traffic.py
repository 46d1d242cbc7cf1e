"""A traffic mix: the B operands and the calls of one step.

A mix file (``traffic/<mix>.json``) holds

- ``b_width``: B's columns (N);
- ``b_dtype``: ``float32`` or ``bfloat16``;
- ``pool``: distinct B a B shape (one shape a distinct operand width K),
  made on the device from the seed in a few calls a shape, with the values
  the configuration's ``b_values`` gives (``uniform`` over [low, high), or
  ``normal`` with standard deviation ``std``), drawn in f32 and rounded to
  ``b_dtype``.  Just before a step whose answers are compared, the pool
  entries it reads are written over in place with new values (``fresh_b``):
  the same storage with other values, so an answer kept from an earlier
  call on it reads wrong;
- ``calls_per_step``: ``spmm`` calls a step; the k-th call of the run goes
  to operand k mod (operands) with entry (k // operands) mod ``pool`` of
  its shape's pool, so a step cycles through the operands in serving order
  and the pool in turn;
- ``warmup_steps``: steps run after each operand's first serve, before the
  window.
"""

from __future__ import annotations

import math

import torch

from spmm_bench.operands import generator

B_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KEYS = ("b_width", "b_dtype", "pool", "calls_per_step", "warmup_steps")
# f32 bytes a call of the B generator draws at most
CHUNK_BYTES = 1 << 30


def check(traffic: dict) -> dict:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if traffic["b_dtype"] not in B_DTYPES:
        raise ValueError(f"b_dtype {traffic['b_dtype']!r} is not one of "
                         f"{sorted(B_DTYPES)}")
    return traffic


def _draw(shape: tuple, b_values: dict, g: torch.Generator,
          device) -> torch.Tensor:
    """f32 values of the configuration's B distribution."""
    if b_values["dist"] == "uniform":
        lo, hi = float(b_values["low"]), float(b_values["high"])
        return torch.rand(shape, generator=g, device=device).mul_(
            hi - lo).add_(lo)
    if b_values["dist"] == "normal":
        return torch.randn(shape, generator=g, device=device).mul_(
            float(b_values["std"]))
    raise ValueError(f"unknown B distribution {b_values['dist']!r}")


def b_pools(widths_k, traffic: dict, b_values: dict, seed: int,
            device) -> dict:
    """{K: a (pool, K, N) tensor of B's dtype} for each distinct K, drawn
    in chunks of at most ``CHUNK_BYTES`` of f32."""
    g = generator(seed, "b_pools", device)
    n, pool = int(traffic["b_width"]), int(traffic["pool"])
    dtype = B_DTYPES[traffic["b_dtype"]]
    out = {}
    for k in sorted(set(int(k) for k in widths_k)):
        b = torch.empty((pool, k, n), dtype=dtype, device=device)
        step = max(1, CHUNK_BYTES // (4 * k * n))
        for p in range(0, pool, step):
            q = min(pool, p + step)
            b[p:q] = _draw((q - p, k, n), b_values, g, device)
        out[k] = b
    return out


def fresh_b(k: int, p: int, step: int, traffic: dict, b_values: dict,
            seed: int, device) -> torch.Tensor:
    """New values for entry ``p`` of the K-wide pool, written into it just
    before step ``step`` of the window: one stream of the seed a (step, K,
    entry), so the reference draws the same values again."""
    g = generator(seed, f"fresh_b:{step}:{k}:{p}", device)
    b = _draw((k, int(traffic["b_width"])), b_values, g, device)
    return b.to(B_DTYPES[traffic["b_dtype"]])


def cycle(n_ops: int, calls_per_step: int, pool: int) -> list:
    """The steps of one period of the schedule: each a list of (operand,
    pool entry); step s of a run is ``cycle[s % len(cycle)]``."""
    span = n_ops * pool
    period = span // math.gcd(calls_per_step, span)
    steps = []
    for s in range(period):
        ks = range(s * calls_per_step, (s + 1) * calls_per_step)
        steps.append([(k % n_ops, (k // n_ops) % pool) for k in ks])
    return steps
