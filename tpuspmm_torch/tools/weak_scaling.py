"""Weak scaling: nnz/s at 1..N ranks of the row-sharded (or ring) SpMM,
the base matrix replicated k times along its rows for k ranks, so the
work per rank stays fixed and efficiency(n) = t(1) / t(n).

Counterpart of ``bench/weak_scaling.py``.  JAX runs virtual devices in one
process; here every rank is a process of its own over torch.distributed
(NCCL on cards, gloo with ``--device cpu``), started by this tool for
each count in ``--devices`` on a file store, or by a launcher
(``python -m torch.distributed.run --nproc_per_node=N -m
tpuspmm_torch.tools.weak_scaling``, one count: the launcher's world).  A
call's time is the slowest rank's median (CUDA events on a card, the host
clock on the CPU), after one warm-up call that builds the shard plans.
Each count's C is gathered and held to the gate against the f64 oracle
of the replicated matrix; ``launches`` counts rank 0's hand-kernel
launches.  Counts above the cards present are not run and are listed under
``dropped``; any rank that fails stops the count's ranks and the tool
exits 1, as it does when a C misses the gate.

Usage::

    python -m tpuspmm_torch.tools.weak_scaling [--devices 1,2,4,8]
        [--base-dir large_25605] [--width 256] [--repeats 5]
        [--schedule row_sharded|ring] [--local xla|tile|panel|pair]
        [--device cuda] [--save-dir DIR]

``--save-dir`` writes each count's gathered C as ``c_n<count>.npy``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RANK_TIMEOUT_S = 900


def replicate_rows(a, k: int):
    """Stack k row-copies of ``a`` (the weak-scaling problem generator)."""
    import scipy.sparse

    from tpuspmm_torch.formats import CSR

    sp = a.to_scipy().tocsr()
    return CSR.from_scipy(scipy.sparse.vstack([sp] * k).tocsr())


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("--base-dir", default="large_25605")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--schedule", default="row_sharded",
                   choices=["row_sharded", "ring"])
    p.add_argument("--local", default="xla",
                   choices=["xla", "tile", "panel", "pair"],
                   help="per-rank kernel of the row-sharded schedule")
    p.add_argument("--device", default="cuda")
    p.add_argument("--save-dir", default=None)
    # one rank of a count this tool started
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return p


def run_rank(args) -> dict:
    """This rank's part of one count: the sharded call timed, C gathered;
    rank 0 holds C to the gate.  Returns rank 0's record (others: {})."""
    import torch.distributed as dist

    from tpuspmm_torch import parallel
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.parallel import multihost
    from tpuspmm_torch.parallel.shard import (bucket_triplets,
                                              shard_rows_tileplan)
    from tpuspmm_torch.sweeps.common import hand_kernels
    from tpuspmm_torch.utils.compare import allclose
    from tpuspmm_torch.utils.timing import cuda_time_ms

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the machine's cores
    if args.rank is not None:
        multihost.initialize(device=device.type,
                             init_method=f"file://{args.store}",
                             num_processes=args.world, process_id=args.rank)
    else:
        multihost.initialize(device=device.type)
    try:
        n, rank = dist.get_world_size(), dist.get_rank()
        if on_card:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = parallel.make_mesh((n,), ("rows",), device=device.type)
        d = data_dir(args.base_dir) or args.base_dir
        base = convert.load_sparse(d, "csr")
        b_np = np.asarray(convert.load_dense(d, width=args.width).data,
                          dtype=np.float32)
        a = replicate_rows(base, n) if n > 1 else base
        b = torch.from_numpy(b_np).to(device)
        # the host-side partition is built by the warm-up call, outside
        # the timing: the steady state measured is the sharded call
        if args.schedule == "ring":
            buckets = bucket_triplets(a, n, n, rank)

            def fn():
                return parallel.spmm_ring(a, b, mesh, buckets=buckets)
        elif args.local in ("panel", "pair"):
            def fn():
                return parallel.spmm_row_sharded(a, b, mesh,
                                                 local=args.local)
        else:
            plan = shard_rows_tileplan(a, n, rank)

            def fn():
                return parallel.spmm_row_sharded(a, b, mesh,
                                                 local=args.local, plan=plan)

        kernels = hand_kernels()
        for k in kernels.values():
            k.launches = 0
        c = fn()
        if on_card:
            ms = cuda_time_ms(fn, warmup=1, iters=args.repeats)
        else:
            fn()
            dist.barrier()
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(times))
        launches = {name: k.launches for name, k in kernels.items()}
        slowest = torch.tensor([ms], dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        full = parallel.gather_output(c, mesh)
        if rank != 0:
            return {}
        ref = oracle.spmm_scipy_oracle(a, b_np)
        gate = bool(full.shape == ref.shape and allclose(full, ref))
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
            np.save(os.path.join(args.save_dir, f"c_n{n}.npy"),
                    full.cpu().numpy())
        slowest = float(slowest.item())
        return {"devices": n, "nnz": int(a.nnz), "width": int(b.shape[1]),
                "ms": slowest, "rank0_ms": ms,
                "nnz_per_s": a.nnz / (slowest / 1e3), "correct": gate,
                "launches": launches}
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    from tpuspmm_torch.parallel import multihost
    from tpuspmm_torch.sweeps.common import resolve_device
    from tpuspmm_torch.utils.timing import card_line

    if args.rank is not None:  # a rank this tool started
        rec = run_rank(args)
        if rec:
            with open(os.path.join(args.out, "rank0.json"), "w") as f:
                json.dump(rec, f)
        return 0 if not rec or rec["correct"] else 1

    device = resolve_device(args.device)
    if device is None:
        return 2
    on_card = device.type == "cuda"
    head = {"schedule": args.schedule, "local": args.local,
            "base": args.base_dir,
            "device": (torch.cuda.get_device_name(device) if on_card
                       else "cpu"),
            "card": card_line() if on_card else "cpu",
            "timer": "cuda_events" if on_card else "host"}
    if all(v in os.environ for v in multihost.LAUNCHER_ENV):
        rec = run_rank(args)  # under a launcher: its world is the count
        if rec:
            rec["efficiency"] = None
            print(json.dumps({**head, "width": rec["width"],
                              "scaling": [rec], "dropped": []}), flush=True)
        return 0 if not rec or rec["correct"] else 1

    counts = [int(x) for x in args.devices.split(",")]
    cards = torch.cuda.device_count() if on_card else None
    dropped = [c for c in counts if cards is not None and c > cards]
    results, t1 = [], None
    for n in (c for c in counts if c not in dropped):
        with tempfile.TemporaryDirectory(prefix="tpuspmm-weak-") as tmp:
            store = os.path.join(tmp, "store")
            multihost.run_ranks(
                lambda r: ["-m", "tpuspmm_torch.tools.weak_scaling", *argv,
                           "--rank", str(r), "--world", str(n), "--store",
                           store, "--out", tmp], n, RANK_TIMEOUT_S)
            with open(os.path.join(tmp, "rank0.json")) as f:
                rec = json.load(f)
        t1 = t1 if t1 is not None else rec["ms"]
        rec["efficiency"] = t1 / rec["ms"]
        results.append(rec)
        print(f"# n={n}: {rec['ms']:.3f} ms, {rec['nnz_per_s'] / 1e6:.1f} "
              f"Mnnz/s, eff={rec['efficiency'] * 100:.1f}%", file=sys.stderr)
    width = results[0]["width"] if results else None
    print(json.dumps({**head, "width": width, "scaling": results,
                      "dropped": dropped}), flush=True)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
