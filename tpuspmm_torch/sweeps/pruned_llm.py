"""Pruned-LLM benchmark: block-sparse weights × dense activations.

Counterpart of ``bench/pruned_llm.py`` (BASELINE config 4: weights at
80-95% block sparsity in 4 × 4 blocks, magnitude-pruned transformer
layers, activation width 512).  Every variant of the BSR engine runs on
``BSR.random_blocks(dim, dim, (block, block), 1 - s, seed)`` for each
block sparsity s, against B = standard_normal · 0.05 in f32 or bf16 (the
oracle sees the bf16 values, upcast):

- ``xla_block_einsum``    — gathered B panels, one batched product;
- ``pallas_block_stream`` — K6 on blocks it admits, or on their 128 × 128
  repacking where the stored values grow at most 4×, else the tile kernel
  (``blockStream`` says which);
- ``pallas_tile_mxu``     — the tile-plan kernel over the blocks' entries;
- the panel, pair, densify and compensated variants where admitted.

Each record: the gate against the f64 oracle (``correct``), ``ms`` (CUDA
events over back-to-back calls, ``utils/timing.serve_time_ms``; the host
clock on a CPU device), ``device_ms`` where the call is one hand-kernel
launch (that launch replayed in a CUDA graph), GFLOP/s from ``ms`` on a
card.  One
JSON object on stdout at the end.  Exit 1 when a variant that is not
verified-only fails the gate or raises.

Usage::

    python -m tpuspmm_torch.sweeps.pruned_llm [--dim 4096] [--width 512]
        [--block-sparsity 0.8,0.9,0.95] [--block 4] [--repeats 12]
        [--b-dtype f32|bf16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tpuspmm_torch.sweeps.common import hand_kernels, resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--block-sparsity", default="0.8,0.9,0.95")
    p.add_argument("--block", type=int, default=4)
    p.add_argument("--repeats", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="activation dtype; the gate checks against the "
                        "f64 oracle of the bf16 values")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2

    import torch

    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.engine.report import detect_card
    from tpuspmm_torch.formats import BSR
    from tpuspmm_torch.kernels import bsr_spmm
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.utils.compare import allclose
    from tpuspmm_torch.utils.timing import graph_time_ms, serve_time_ms

    config = default_config()
    engine = get_engine("bsr")
    counters = hand_kernels()
    rng = np.random.default_rng(args.seed)
    b = torch.from_numpy(rng.standard_normal(
        (args.dim, args.width)).astype(np.float32) * 0.05)
    if args.b_dtype == "bf16":
        b = b.to(torch.bfloat16)
    b_dev = b.to(device)
    on_card = device.type == "cuda"

    results, failures, poisoned = [], 0, False
    for bs in (float(x) for x in args.block_sparsity.split(",")):
        if poisoned:
            break
        a = BSR.random_blocks(args.dim, args.dim,
                              block_size=(args.block, args.block),
                              block_density=1.0 - bs, seed=args.seed)
        ref = oracle.spmm_oracle(a, b.float().numpy())
        flops = 2.0 * a.nnz * args.width
        print(f"# block sparsity {bs:.0%}: {a.nblocks} blocks, "
              f"nnz={a.nnz}", file=sys.stderr)
        for v in engine.variants:
            rec = {"block_sparsity": bs, "variant": v.name,
                   "number": v.number}
            if v.verified_only:
                rec["verifiedOnly"] = "1"
            if v.admissible is not None and not v.admissible(a, b_dev,
                                                             config):
                results.append({**rec, "skipped": "inadmissible"})
                continue
            fn = (lambda bb, v=v: v.fn(a, bb, config))
            try:
                before = {n: c.launches for n, c in counters.items()}
                out = fn(b_dev)
                launched = {n: c.launches - before[n]
                            for n, c in counters.items()
                            if c.launches > before[n]}
                ok = allclose(out.float().cpu().numpy(), ref, 1e-2, 1e-3)
                ms = serve_time_ms(fn, b_dev, iters=args.repeats)
                device_ms = (graph_time_ms(lambda: fn(b_dev))
                             if on_card and sum(launched.values()) == 1
                             else None)
            except Exception as e:  # recorded: the run goes on, and fails
                print(f"#   {v.name}: ERROR {type(e).__name__}: {e}",
                      file=sys.stderr)
                results.append({**rec,
                                "error": f"{type(e).__name__}: {e}"})
                failures += 1
                # a CUDA error poisons the context: nothing after it runs
                poisoned = "CUDA error" in str(e)
                if poisoned:
                    break
                continue
            if not ok and not v.verified_only:
                failures += 1
            rec.update(correct=bool(ok), ms=ms, device_ms=device_ms,
                       launched=launched,
                       timer="cuda_events" if on_card else "host_clock")
            if on_card:  # no rate from the host clock
                rec["gflops"] = flops / (ms / 1e3) / 1e9
            if v.name == "pallas_block_stream":
                served = bsr_spmm.stream_operand(a)
                rec["blockStream"] = ("tile" if served is None else
                                      "k6" if served is a else "k6_packed")
            print(f"#   {v.name:24s} {ms:9.4f} ms"
                  + (f" (device {device_ms:.4f})" if device_ms else "")
                  + f"  correct={ok}", file=sys.stderr)
            results.append(rec)
        del a

    print(json.dumps({"dim": args.dim, "width": args.width,
                      "block": args.block, "bDtype": args.b_dtype,
                      "device": detect_card(device), "results": results}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
