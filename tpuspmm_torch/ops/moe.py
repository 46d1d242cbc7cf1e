"""An expert-parallel mixture-of-experts layer served through ``spmm``.

DeepSeek-V3's MoE block on one chip of an expert-parallel deployment (at
EP32 each chip holds 8 of the 256 routed experts of a layer).  The layer is
told which routed experts it holds, routes every token over all of them,
and computes the part of the result that its own experts give, plus the
shared expert on the tokens this chip owns.  What the absent experts add
is computed on other chips; on one chip the layer runs without the
exchange, and its partial result is what goes on.

Routing, the published ``noaux_tc`` rule (:func:`route`): scores =
sigmoid(x · Wrᵀ) in f32; the choice alone adds ``e_score_correction_bias``:
a group's score is the sum of its two largest biased scores, the
``topk_group`` best of ``n_group`` groups are kept and the ``top_k`` best
experts inside them are chosen; the weights are the chosen experts'
unbiased scores, normalised to sum to one (``norm_topk_prob``), times
``routed_scaling_factor``.

An expert (:func:`ffn`) is y = Wd · (silu(Wg · xᵀ) ⊙ (Wu · xᵀ)), each
product a ``tpuspmm_torch.spmm`` of the expert's pruned weight and its
tokens' (hidden, n) slab; the hidden activations are rounded to the
tokens' dtype between the products, as a serving stack keeps them.  A
slab is padded with zero columns to a multiple of ``PAD``: a routed width
n is any count, and bf16 B whose rows are not 16 bytes long takes K6's
register build, ~6× slower at expert shapes than the warp-specialised
build (``kernels/bsr_cuda.warp_specialised``).  The zero columns add
nothing to the kept ones, and are dropped from the products.  The
output is f32 (tokens, hidden): the held experts' weighted outputs added
in ascending expert id (a token meets an expert once, so no two adds of one
step touch one row: no float atomics), then the shared expert's, unscaled.

While a profiler records, the router, each held expert's gather and the
adds into the output are the spans ``tpuspmm_torch.moe.route``,
``.gather`` and ``.combine`` (``utils/profiling.py``); the tokens the held
experts served are added to the counter ``tpuspmm_torch.moe.tokens`` on
every call.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch.autograd import profiler as torch_profiler

from tpuspmm_torch.utils import profiling

TOKENS_COUNTER = "tpuspmm_torch.moe.tokens"
# a token slab's width is padded to a multiple of this: 16-byte bf16 rows
PAD = 8


@dataclasses.dataclass(frozen=True)
class Routing:
    """The router's published settings."""
    n_group: int
    topk_group: int
    top_k: int
    norm_topk_prob: bool
    routed_scaling_factor: float

    @classmethod
    def from_config(cls, config: dict) -> "Routing":
        """From a model config's keys (DeepSeek-V3's ``config.json``)."""
        return cls(n_group=int(config["n_group"]),
                   topk_group=int(config["topk_group"]),
                   top_k=int(config["num_experts_per_tok"]),
                   norm_topk_prob=bool(config["norm_topk_prob"]),
                   routed_scaling_factor=float(
                       config["routed_scaling_factor"]))


@dataclasses.dataclass(frozen=True)
class Expert:
    """A gated FFN's pruned weights, each a container ``spmm`` serves:
    gate and up (width, hidden), down (hidden, width)."""
    gate: object
    up: object
    down: object


def _hot(name: str):
    return (profiling.span(name) if torch_profiler._is_profiler_enabled
            else contextlib.nullcontext())


def route(x: torch.Tensor, router_weight: torch.Tensor, bias: torch.Tensor,
          routing: Routing) -> tuple:
    """(experts (T, top_k) int64, weights (T, top_k) f32) of the tokens x
    (T, hidden) over all of router_weight's (experts, hidden) rows."""
    scores = (x.float() @ router_weight.float().T).sigmoid()
    t, n = scores.shape
    choice = (scores + bias.float()).view(t, routing.n_group, -1)
    groups = choice.topk(2, dim=-1).values.sum(dim=-1)
    kept = groups.topk(routing.topk_group, dim=-1).indices
    dropped = torch.ones_like(groups, dtype=torch.bool).scatter_(1, kept,
                                                                 False)
    choice = choice.masked_fill(dropped[..., None], float("-inf"))
    experts = choice.view(t, n).topk(routing.top_k, dim=-1).indices
    weights = scores.gather(1, experts)
    if routing.norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return experts, weights * routing.routed_scaling_factor


def _slab(rows: torch.Tensor) -> torch.Tensor:
    """Tokens (n, hidden) as B: (hidden, n) and zero columns up to a
    multiple of PAD."""
    n = rows.shape[0]
    b = rows.new_empty((rows.shape[1], -(-n // PAD) * PAD))
    b[:, :n] = rows.T
    b[:, n:] = 0
    return b


def _products(expert: Expert, b: torch.Tensor, n: int,
              config) -> torch.Tensor:
    """The expert on B = the :func:`_slab` of n tokens: (hidden, n) f32."""
    from tpuspmm_torch.ops.api import spmm

    gate = spmm(expert.gate, b, config=config)
    up = spmm(expert.up, b, config=config)
    h = (F.silu(gate) * up).to(b.dtype)
    return spmm(expert.down, h, config=config)[:, :n]


def ffn(expert: Expert, x: torch.Tensor, config=None) -> torch.Tensor:
    """A gated FFN (a dense layer's, the shared expert's) on every token of
    x (T, hidden): (T, hidden) f32."""
    return _products(expert, _slab(x), x.shape[0], config).T


def moe(x: torch.Tensor, router_weight: torch.Tensor, bias: torch.Tensor,
        experts: dict, routing: Routing, shared: Expert | None = None,
        own=None, config=None) -> torch.Tensor:
    """This chip's share of the MoE layer on the tokens x (T, hidden), f32
    or bf16: (T, hidden) f32.  ``experts`` maps each held expert's id (a
    row of router_weight) to its :class:`Expert`; ``shared``, where given,
    is added on the rows ``own`` selects (this chip's tokens; every row by
    default).  A held expert that no token chose is skipped."""
    with _hot("tpuspmm_torch.moe.route"):
        chosen, weights = route(x, router_weight, bias, routing)
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    ids = sorted(experts)
    with _hot("tpuspmm_torch.moe.gather"):
        flat = chosen.flatten()
        # (token, slot) pairs by expert, tokens ascending within each
        order = torch.argsort(flat, stable=True)
        loads = torch.bincount(flat, minlength=router_weight.shape[0])
        starts = torch.cumsum(loads, 0) - loads
        held = torch.tensor(ids, dtype=torch.int64, device=flat.device)
        ranges = torch.stack([starts[held], loads[held]]).tolist()
    weights = weights.flatten()
    served = 0
    for e, start, n in zip(ids, *ranges):
        if n == 0:
            continue
        with _hot("tpuspmm_torch.moe.gather"):
            pairs = order[start:start + n]
            tokens = pairs // routing.top_k
            b = _slab(x.index_select(0, tokens))
        y = _products(experts[e], b, n, config)
        with _hot("tpuspmm_torch.moe.combine"):
            out.index_put_((tokens,),
                           out.index_select(0, tokens)
                           + y.T * weights[pairs, None])
        served += n
    if shared is not None:
        rows = slice(None) if own is None else own
        y = ffn(shared, x[rows], config)
        with _hot("tpuspmm_torch.moe.combine"):
            out[rows] += y
    profiling.count(TOKENS_COUNTER, served)
    return out
