"""Example: one SpMM, four distributed schedules — pick by what fits where.

Counterpart of ``examples/distributed_serving.py``.  Serves the same
C = A @ B through every schedule of ``tpuspmm_torch.parallel`` over every
rank and prints what each one communicates:

- ``row``    — A row-sharded, B whole on every rank: no collective.
- ``2d``     — A row-sharded, B column-sharded: no collective, B's share of
               a rank's memory drops by the column count.
- ``ring``   — B K-sharded, panels passed round the ranks while each
               multiplies the bucket matching the panel it holds: no rank
               stores all of B, (n-1)/n of B sent a rank, overlapped with
               the local launches.
- ``kshard`` — A column-sharded, full-height partials reduce-scattered:
               one reduce-scatter of C.

Every schedule serves any of the four locals (xla / tile / panel / pair:
the gather path, K3, K1, K2); ``panel`` is the default.  Each rank checks
the gathered C against the f64 oracle at the reference gate; the run
exits non-zero if any schedule misses it.

Launch one process per card::

    torchrun --nproc_per_node=N -m tpuspmm_torch.examples.distributed_serving \\
        [-l panel] [--data-dir large_25605 --width 256] [--device cuda]

Without a launcher it runs as one rank.  ``--device cpu`` runs gloo ranks
on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--data-dir", default=None,
                   help="a corpus directory (or its name under data/): its "
                        "CSR matrix and its dense operand (seeded, --width "
                        "columns, where it has none) in place of the "
                        "random A and B")
    p.add_argument("-l", "--local", default="panel",
                   choices=["xla", "tile", "panel", "pair"],
                   help="the local kernel (under torchrun give it as -l: "
                        "its own parser can take --local for an "
                        "abbreviation of its --local-* options)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import scipy.sparse
    import torch
    import torch.distributed as dist

    from tpuspmm_torch import interop
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.parallel import (gather_output, make_mesh, multihost,
                                        spmm_2d, spmm_kshard, spmm_ring,
                                        spmm_row_sharded)
    from tpuspmm_torch.utils.compare import allclose

    multihost.initialize(device=args.device)
    n = dist.get_world_size()
    if args.data_dir is not None:
        from tpuspmm_torch.data import data_dir
        from tpuspmm_torch.formats import convert

        d = data_dir(args.data_dir) or args.data_dir
        a = convert.load_sparse(d, "csr")
        b = convert.load_dense(d, width=args.width).data
        source = f"{args.data_dir} ({a.shape[0]}x{a.shape[1]}, {a.nnz} nnz)"
    else:
        rng = np.random.default_rng(3)
        sp = scipy.sparse.random(args.m, args.k, density=args.density,
                                 format="csr", random_state=rng,
                                 data_rvs=lambda k: rng.uniform(-1, 1, k))
        a = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape)
        b = np.random.default_rng(0).standard_normal(
            (args.k, args.width)).astype(np.float32)
        source = f"random {args.m}x{args.k} at {args.density}"
    ref = oracle.spmm_scipy_oracle(a, b)
    b_mb = b.nbytes / 1e6

    mesh1d = make_mesh((n,), ("rows",), device=args.device)
    rows_dim, cols_dim = (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)
    mesh2d = make_mesh((rows_dim, cols_dim), device=args.device)
    runs = [
        ("row", f"B whole ({b_mb:.1f} MB a rank), no collective",
         lambda: gather_output(spmm_row_sharded(a, b, mesh1d,
                                                local=args.local), mesh1d)),
        ("2d", f"B column-sharded ({b_mb / cols_dim:.1f} MB a rank), "
               "no collective",
         lambda: gather_output(spmm_2d(a, b, mesh2d, local=args.local),
                               mesh2d, cols_axis="cols")),
        ("ring", f"B K-sharded ({b_mb / n:.1f} MB a rank), "
                 f"{(n - 1) / n * b_mb:.1f} MB sent a rank, overlapped",
         lambda: gather_output(spmm_ring(a, b, mesh1d, local=args.local),
                               mesh1d)),
        ("kshard", f"A K-sharded, one reduce-scatter of C "
                   f"({a.shape[0] * b.shape[1] * 4 / 1e6:.1f} MB of f32 partials "
                   "a rank)",
         lambda: gather_output(spmm_kshard(a, b, mesh1d, local=args.local),
                               mesh1d)),
    ]
    ok = True
    rank = dist.get_rank()
    for name, note, fn in runs:
        good = allclose(fn(), ref)
        ok &= good
        if rank == 0:
            print(f"{name:7s} local={args.local:5s} ranks={n} "
                  f"correct={good}   {note}", flush=True)
    if rank == 0:
        print(f"A: {source}, B width {b.shape[1]}, device "
              f"{torch.device(args.device).type}", flush=True)
    multihost.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
