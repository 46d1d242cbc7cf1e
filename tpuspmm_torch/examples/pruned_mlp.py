"""Example: a pruned transformer MLP block served with tpuspmm_torch.

Counterpart of ``examples/pruned_mlp.py``: the reference frames SpMM as
the pruned-LLM inference primitive (reference/README.md:11-24), and this
is that use end to end.  A 2-layer MLP whose weights are 90% block-sparse
at 4 × 4 pruning granularity runs on a batch of activations

    h = gelu(x · W1ᵀ);  y = h · W2ᵀ

where each x · Wᵀ is (W · xᵀ)ᵀ, an SpMM through ``tpuspmm_torch.spmm``
(``--method``, the dispatcher by default).  With bf16 activations h is
cast back to bf16 between the layers, as a serving stack would.  gelu is
the tanh form, ``jax.nn.gelu``'s default.

Each layer's product is held at the gate (rel 1e-2 / abs 1e-3) to the f64
oracle of the operands it was served: x · W1ᵀ to that of x, y to that of
the served h, as the sweeps hold a bf16 B to the oracle of its values;
the exit status is 1 when either misses.  The JAX example holds y to a
dense f32 pipeline of its own instead, which re-quantises its own h: with
bf16 activations at these sizes the two h differ in a few bf16 roundings
(f32 sums in another order land on the other side of a rounding
boundary), each 2^-8 of its value, and y then misses that gate in both
packages.  The deviation from that dense pipeline is printed on stderr,
with the count of h values rounded apart.

Run it::

    python -m tpuspmm_torch.examples.pruned_mlp            # the card
    python -m tpuspmm_torch.examples.pruned_mlp --device cpu
    torchrun --nproc_per_node=N -m tpuspmm_torch.examples.pruned_mlp --sharded

``--sharded`` row-shards each weight over the launcher's ranks
(``parallel.spmm_row_sharded`` with its tile local, K3 on the card; the
JAX example runs its XLA local) and gathers each layer's output on every
rank; without a launcher it runs as one rank.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_layer(d_out: int, d_in: int, block_sparsity: float, seed: int):
    from tpuspmm_torch.formats import BSR

    return BSR.random_blocks(d_out, d_in, block_size=(4, 4),
                             block_density=1.0 - block_sparsity, seed=seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--d-model", type=int, default=1024)
    p.add_argument("--d-ff", type=int, default=4096)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--block-sparsity", type=float, default=0.9)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--method", default="auto",
                   choices=["auto", "xla", "pallas", "tuned", "vendor"])
    p.add_argument("--activations-dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="bf16: how activations arrive in LLM serving; the "
                        "kernels take them as they are, outputs are f32")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from tpuspmm_torch.sweeps.common import resolve_device

    device = resolve_device(args.device)
    if device is None:
        return 2

    import tpuspmm_torch
    from tpuspmm_torch.config import Config
    from tpuspmm_torch.engine.report import detect_card
    from tpuspmm_torch.ops.oracle import spmm_oracle
    from tpuspmm_torch.utils.compare import allclose

    rng = np.random.default_rng(0)
    w1 = build_layer(args.d_ff, args.d_model, args.block_sparsity, seed=1)
    w2 = build_layer(args.d_model, args.d_ff, args.block_sparsity, seed=2)
    x = torch.from_numpy(rng.standard_normal(
        (args.batch, args.d_model)).astype(np.float32) * 0.1)
    if args.activations_dtype == "bf16":
        x = x.to(torch.bfloat16)
    print(f"# W1 {w1.shape} ({w1.nnz} nnz), W2 {w2.shape}, x "
          f"{tuple(x.shape)}, device {detect_card(device)}", file=sys.stderr)

    rank = 0
    if args.sharded:
        import torch.distributed as dist

        from tpuspmm_torch.parallel import (gather_output, make_mesh,
                                            multihost, spmm_row_sharded)

        multihost.initialize(device=device.type)
        rank = dist.get_rank()
        mesh = make_mesh((dist.get_world_size(),), ("rows",),
                         device=device.type)

        def layer(w, act):
            return gather_output(spmm_row_sharded(
                w, act.T.contiguous(), mesh, local="tile"), mesh).T
    else:
        config = Config(device=device.type)

        def layer(w, act):
            return tpuspmm_torch.spmm(w, act.T.contiguous(),
                                      method=args.method, config=config).T

    x_dev = x.to(device)
    t0 = time.perf_counter()
    z = layer(w1, x_dev)
    h = F.gelu(z, approximate="tanh").to(x.dtype)
    y = layer(w2, h).float().cpu().numpy()
    t1 = time.perf_counter()
    z, h = z.float().cpu(), h.cpu()

    def oracle_of(w, act):
        return spmm_oracle(w, act.float().numpy().T).T

    ok = (allclose(z.numpy(), oracle_of(w1, x), 1e-2, 1e-3)
          and allclose(y, oracle_of(w2, h), 1e-2, 1e-3))
    # the dense f32 pipeline of the JAX example, for the record
    dense_z = torch.from_numpy(x.float().numpy() @ w1.to_dense().T)
    dense_h = F.gelu(dense_z, approximate="tanh").to(x.dtype)
    dense_y = dense_h.float().numpy() @ w2.to_dense().T
    apart = (f", {int((dense_h != h).sum())} of {h.numel()} h values "
             f"rounded apart" if x.dtype == torch.bfloat16 else "")
    print(f"# first call (plans and kernel builds included): "
          f"{t1 - t0:.2f} s, output {y.shape}, each layer at the gate "
          f"against the oracle of its served operands: {ok}; against the "
          f"dense f32 pipeline: max |dy| {np.abs(y - dense_y).max():.3g}"
          f"{apart}", file=sys.stderr)
    if rank == 0:
        print({"correct": bool(ok), "out_shape": list(y.shape),
               "sharded": args.sharded, "method": args.method,
               "activations_dtype": args.activations_dtype})
    if args.sharded:
        multihost.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
