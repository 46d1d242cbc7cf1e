"""Headline benchmark of the port: CSR SpMM on large_25605 at B width 256.

Counterpart of ``bench.py`` (the JAX package's headline), run as::

    python -m tpuspmm_torch.bench [--data-dir DIR] [--width 256]
                                  [--repeats 20] [--device cuda]

It times ``tpuspmm_torch.spmm(A, B)`` at the default config (what a user
who does not tune is served: the cost model's geometry, unless the
geometry cache already holds one that an earlier tune of this matrix
pinned, which a default serve then reads too), then autotunes (``engine/autotune.py``:
every admissible variant and cuSPARSE checked against the f64 oracle and
timed) and serves the fastest hand-written variant, cuSPARSE kept out of
that slot as ``bench.py`` keeps the vendor out.  The winner is checked at
the gate and timed with CUDA events (median of ``--repeats`` back-to-back
calls, its host work included), and its launch is replayed in a CUDA graph
for the device time alone; cuSPARSE (``torch.sparse`` CSR @ B) is timed
afresh in the same window; then the same winner serves bf16 B, timed and
checked against the oracle of the bf16 values.

Diagnostics go to stderr; stdout gets one JSON line with ``bench.py``'s
keys (``metric``, ``kernel``, ``value`` in GFLOP/s, ``unit``,
``vs_baseline``, ``kernel_ms``, ``vendor_ms``, ``nnz_per_s``,
``hbm_roofline_frac``, ``correct``, ``bf16_serving_ms``,
``bf16_serving_correct``, ``geometry`` for a panel or pair winner,
``bCols``, ``bDtype``, ``bSource``) and ``backend`` (the card's name and
power limit as nvidia-smi gives them), ``device_ms`` and
``default_serve_ms``.  Exit 1 when the winner fails the gate.  Without a
card it exits 2 unless ``--device cpu`` asks for the CPU, where every time
is the host clock's, ``backend`` is "cpu", and ``device_ms`` and
``hbm_roofline_frac`` are null.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpuspmm_torch.bench")
    p.add_argument("--data-dir", default="large_25605",
                   help="data directory or corpus name")
    p.add_argument("--width", type=int, default=256,
                   help="B width when B is synthesised")
    p.add_argument("--repeats", type=int, default=20,
                   help="timed calls per measurement (median)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu for the CPU)",
              file=sys.stderr)
        return 2
    if device.type not in ("cuda", "cpu"):
        print(f"bench: --device must be cuda or cpu, got {args.device}",
              file=sys.stderr)
        return 2

    import tpuspmm_torch
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.engine import autotune, report
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import dispatch
    from tpuspmm_torch.ops import oracle, vendor
    from tpuspmm_torch.utils.compare import allclose
    from tpuspmm_torch.utils.timing import (card_line, graph_time_ms,
                                            serve_time_ms)

    data = args.data_dir if os.path.isdir(args.data_dir) else data_dir(
        args.data_dir)
    if data is None:
        print(f"bench: no data directory {args.data_dir!r}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    testcase = os.path.basename(os.path.normpath(data))
    a = convert.load_sparse(data, "csr")
    dense = convert.load_dense(data, width=args.width)
    b_host = np.ascontiguousarray(dense.data, dtype=np.float32)
    b = torch.from_numpy(b_host).to(device)
    n = int(b.shape[1])
    backend = card_line() if on_card else "cpu"
    print(f"# {testcase}: A {a.shape} nnz={a.nnz}, B {tuple(b.shape)}, "
          f"{backend}", file=sys.stderr)

    default_ms = serve_time_ms(lambda bb: tpuspmm_torch.spmm(a, bb), b,
                               args.repeats)

    cfg = default_config()
    ranking = autotune.tune(a, b, iters=args.repeats, config=cfg)
    custom = [r for r in ranking if r.number != -1]
    if custom:
        winner = get_engine("csr").variant(custom[0].number)
        winner_name = winner.name
        serve = lambda bb: winner.fn(a, bb, cfg)  # noqa: E731
    else:  # nothing ranked: the dispatcher serves
        winner_name = "dispatch"
        serve = lambda bb: dispatch.spmm_pallas(a, bb, cfg)  # noqa: E731
    print(f"# serving: {winner_name} (ranking: "
          f"{[(r.variant_name, r.ms) for r in ranking]})", file=sys.stderr)

    correct = allclose(serve(b), oracle.spmm_scipy_oracle(a, b_host))
    kernel_ms = serve_time_ms(serve, b, args.repeats)
    device_ms = graph_time_ms(lambda: serve(b), args.repeats) if on_card else None
    vendor.spmm_vendor(a, b)
    vendor_ms = serve_time_ms(lambda bb: vendor.spmm_vendor(a, bb), b,
                              args.repeats)

    b16 = b.to(torch.bfloat16)
    bf16_correct = allclose(serve(b16), oracle.spmm_scipy_oracle(
        a, b16.float().cpu().numpy()))
    bf16_ms = serve_time_ms(serve, b16, args.repeats)

    secs = kernel_ms / 1e3
    roofline = (report.spmm_min_bytes(a.nnz, *a.shape, n)
                / (report.hbm_gbps(torch.cuda.get_device_name(device)) * 1e9)
                / secs) if on_card else None
    print(f"# ours {kernel_ms:.4f} ms (device {device_ms}), vendor "
          f"{vendor_ms:.4f} ms, default serve {default_ms:.4f} ms, "
          f"bf16 {bf16_ms:.4f} ms, correct={correct}/{bf16_correct}",
          file=sys.stderr)
    record = {
        "metric": f"csr_spmm_gflops_{testcase}_w{n}",
        "kernel": winner_name,
        "value": report.spmm_flops(a.nnz, n) / secs / 1e9,
        "unit": "GFLOP/s",
        "vs_baseline": vendor_ms / kernel_ms,
        "kernel_ms": kernel_ms,
        "vendor_ms": vendor_ms,
        "nnz_per_s": a.nnz / secs,
        "hbm_roofline_frac": roofline,
        "correct": correct,
        "bf16_serving_ms": bf16_ms,
        "bf16_serving_correct": bf16_correct,
        "backend": backend,
        "timer": "cuda_events" if on_card else "host_clock",
        "device_ms": device_ms,
        "default_serve_ms": default_ms,
        "bCols": n,
        "bDtype": "f32",
        "bSource": getattr(dense, "b_source", "ondisk"),
    }
    if custom and custom[0].geom is not None:
        record["geometry"] = custom[0].geom
    print(json.dumps(record), flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
