"""Operands of kind ``pruned_moe``: the FFN weights one chip of an
expert-parallel deployment holds of a model with leading dense layers and
then MoE layers (DeepSeek-V3's layout), in serving order:

- each of the ``first_k_dense_replace`` dense layers: gate and up
  ``[intermediate_size, hidden_size]``, down the transpose's shape;
- each of the other ``num_hidden_layers`` layers: the held routed experts
  0 .. ``n_routed_experts`` - 1 (the count held here), then the shared
  expert (``n_shared_experts`` · ``moe_intermediate_size`` wide), each
  gate, up ``[width, hidden_size]`` and down ``[hidden_size, width]``.

Every weight is pruned to ``operands.block`` blocks at
``operands.block_sparsity`` by ``pruned_ffn``'s draw (imported, so both
kinds place blocks alike): how many blocks each block row keeps is one
fixed draw a shape, and the seed orders the block rows, places the blocks
and draws the standard-normal values, so every seed does the same work."""

from __future__ import annotations

from spmm_bench.generators.pruned_ffn import _group
from spmm_bench.operands import Operand, generator

FFN = ("gate", "up", "down")


def layout(config: dict) -> list:
    """(name, shape) of each operand, in serving order."""
    hidden = config["hidden_size"]
    dense = config["first_k_dense_replace"]
    inter = config["intermediate_size"]
    width = config["moe_intermediate_size"]
    experts = [f"expert{e}" for e in range(config["n_routed_experts"])]
    shared = width * config["n_shared_experts"]
    out = []
    for layer in range(config["num_hidden_layers"]):
        if layer < dense:
            owners = [("", inter)]
        else:
            owners = [(f"{e}.", width) for e in experts]
            owners.append(("shared.", shared))
        for owner, w in owners:
            for part in FFN:
                shape = (hidden, w) if part == "down" else (w, hidden)
                out.append((f"layer{layer}.{owner}{part}", shape))
    return out


def build(config: dict, seed: int, device, root: str) -> list:
    spec = config["operands"]
    block = tuple(spec["block"])
    sparsity = float(spec["block_sparsity"])
    g = generator(seed, "operands", device)
    names = layout(config)
    shapes = sorted({shape for _, shape in names})
    drawn = {shape: iter(_group(shape, sum(s == shape for _, s in names),
                                block, sparsity, g, device))
             for shape in shapes}
    return [Operand(name, shape, *next(drawn[shape]), block=block)
            for name, shape in names]
