"""The plain reference of DeepSeek-V3's FFN side: its dense FFN and one
chip's share of its MoE layer, in plain torch at float32.

It imports nothing of the program (nor JAX), runs on the CPU and on the
card, and holds every matrix product at f32 with TF32 off
(``spmm_bench.reference.no_tf32``).  Weights are dense f32 tensors
(:func:`dense` makes one from a pruned weight's blocks).

The published description (``config.json`` of deepseek-ai/DeepSeek-V3 and
the technical report, arXiv:2412.19437 §2.1.2):

- a dense FFN and an expert are SiLU-gated: y = (silu(x·Wgᵀ) ⊙ (x·Wuᵀ))·Wdᵀ;
- the router scores every routed expert with sigmoid(x·Wrᵀ); the choice
  adds ``e_score_correction_bias`` to the scores (``noaux_tc``): a group's
  score is the sum of its two largest biased scores, ``topk_group`` of the
  ``n_group`` groups are kept, and the ``num_experts_per_tok`` best
  experts inside them are chosen; the weights are the chosen experts'
  unbiased scores, normalised to sum to one (``norm_topk_prob``), times
  ``routed_scaling_factor``;
- the layer's output is the routed experts' weighted outputs plus the
  shared expert's, unscaled.

Departures from it, each the configuration's (``dsv3_ep32_b128.json``):

- only the FFN side: no attention (MLA), norms, residual, embedding or
  head; no multi-token-prediction module;
- one chip's share (:func:`moe_share`): the routed experts it holds, over
  a router of every expert, and the shared expert on the tokens it owns;
  the 32 redundant experts of the report's deployment are left out;
- the weights are pruned (128 × 128 blocks at 90%, standard normal);
- between the products the activations h are rounded to the tokens' dtype
  (bf16 when the tokens are), as the program serves them; the products
  and sums are f32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spmm_bench.reference import no_tf32


def dense(shape: tuple, block: tuple, indptr: torch.Tensor,
          indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The dense f32 weight of a BSR's arrays (indptr over block rows, a
    block column a block, values (blocks, bh, bw)), on values' device."""
    bh, bw = block
    rows, cols = shape
    out = torch.zeros((rows // bh, cols // bw, bh, bw), dtype=torch.float32,
                      device=values.device)
    brow = torch.repeat_interleave(
        torch.arange(rows // bh, device=values.device),
        torch.diff(indptr.to(values.device)))
    out[brow, indices.to(values.device)] = values.float()
    return out.permute(0, 2, 1, 3).reshape(rows, cols)


def route(x: torch.Tensor, router_weight: torch.Tensor, bias: torch.Tensor,
          config: dict) -> tuple:
    """(experts (T, k) int64, weights (T, k) f32) of the tokens x (T,
    hidden) over router_weight's (experts, hidden) rows."""
    with no_tf32():
        scores = torch.sigmoid(x.float() @ router_weight.float().T)
    t, n = scores.shape
    n_group = int(config["n_group"])
    biased = (scores + bias.float()).view(t, n_group, n // n_group)
    group_scores = biased.topk(2, dim=-1).values.sum(dim=-1)
    kept = group_scores.topk(int(config["topk_group"]), dim=-1).indices
    mask = torch.ones((t, n_group), dtype=torch.bool, device=x.device)
    mask.scatter_(1, kept, False)
    biased = biased.masked_fill(mask[..., None], float("-inf")).view(t, n)
    experts = biased.topk(int(config["num_experts_per_tok"]),
                          dim=-1).indices
    weights = scores.gather(1, experts)
    if config["norm_topk_prob"]:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return experts, weights * float(config["routed_scaling_factor"])


def ffn(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
        down: torch.Tensor) -> torch.Tensor:
    """A SiLU-gated FFN on the tokens x (T, hidden): (T, hidden) f32, h
    rounded to x's dtype between the products."""
    with no_tf32():
        xf = x.float()
        h = F.silu(xf @ gate.float().T) * (xf @ up.float().T)
        return h.to(x.dtype).float() @ down.float().T


def moe_share(x: torch.Tensor, router_weight: torch.Tensor,
              bias: torch.Tensor, experts: dict, config: dict,
              shared: tuple | None = None, own=None) -> torch.Tensor:
    """One chip's share of the MoE layer on the tokens x (T, hidden):
    (T, hidden) f32.  ``experts`` maps each held expert's id to its (gate,
    up, down) weights; ``shared`` (gate, up, down) is added, unscaled, on
    the rows ``own`` selects (every row by default).  With every routed
    expert held and every row owned it is the whole layer."""
    chosen, weights = route(x, router_weight, bias, config)
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for e in sorted(experts):
        token, slot = torch.nonzero(chosen == e, as_tuple=True)
        if token.numel():
            y = ffn(x[token], *experts[e])
            out[token] += weights[token, slot, None] * y
    if shared is not None:
        rows = slice(None) if own is None else own
        out[rows] += ffn(x[rows], *shared)
    return out
