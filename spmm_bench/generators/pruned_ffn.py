"""Operands of kind ``pruned_ffn``: the gated FFN weights of
``num_hidden_layers`` layers (gate and up ``[intermediate_size,
hidden_size]``, down the transpose's shape, in that order a layer), each
pruned to ``operands.block`` blocks at ``operands.block_sparsity``:
exactly round((1 - sparsity) · blocks) blocks kept a weight, with
standard-normal values.  How many blocks each block row keeps is one fixed
draw (a kernel that gives a block row to one owner takes as long as its
heaviest row); the seed orders the block rows, places the blocks in each
and draws the values, so every seed does the same work."""

from __future__ import annotations

import torch

from spmm_bench.operands import Operand, generator


def _group(shape: tuple, count: int, block: tuple, sparsity: float,
           g: torch.Generator, device) -> list:
    """``count`` pruned weights of one shape: (indptr, indices, blocks)
    each, in a few calls a group."""
    bh, bw = block
    rows, cols = shape
    if rows % bh or cols % bw:
        raise ValueError(f"block {block} does not tile {shape}")
    nbr, nbc = rows // bh, cols // bw
    kept = int(round((1.0 - sparsity) * nbr * nbc))
    layout = generator(0, f"layout:{rows}x{cols}:{block}", device)
    first = torch.topk(torch.rand((count, nbr * nbc), generator=layout,
                                  device=device), kept, dim=1,
                       largest=False).indices // nbc
    per_row = torch.stack([torch.bincount(r, minlength=nbr) for r in first])
    order = torch.argsort(torch.rand((count, nbr), generator=g,
                                     device=device), dim=1)
    per_row = torch.gather(per_row, 1, order)
    rank = torch.argsort(torch.argsort(
        torch.rand((count, nbr, nbc), generator=g, device=device), dim=2),
        dim=2)
    chosen = rank < per_row[:, :, None]
    values = torch.randn((count, kept, bh, bw), generator=g, device=device)
    out = []
    for i in range(count):
        indptr = torch.zeros(nbr + 1, dtype=torch.int64, device=device)
        indptr[1:] = torch.cumsum(per_row[i], 0)
        out.append((indptr, torch.nonzero(chosen[i])[:, 1], values[i]))
    return out


def build(config: dict, seed: int, device, root: str) -> list:
    spec = config["operands"]
    hidden, inter = config["hidden_size"], config["intermediate_size"]
    layers = config["num_hidden_layers"]
    block = tuple(spec["block"])
    sparsity = float(spec["block_sparsity"])
    g = generator(seed, "operands", device)
    up = _group((inter, hidden), 2 * layers, block, sparsity, g, device)
    down = _group((hidden, inter), layers, block, sparsity, g, device)
    out = []
    for layer in range(layers):
        for name, shape, arrays in (
                ("gate", (inter, hidden), up[2 * layer]),
                ("up", (inter, hidden), up[2 * layer + 1]),
                ("down", (hidden, inter), down[layer])):
            out.append(Operand(f"layer{layer}.{name}", shape, *arrays,
                               block=block))
    return out
