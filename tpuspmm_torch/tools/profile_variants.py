"""Steady-state per-strategy times on the card: operands on the device
once, each strategy timed over many repeats, its device time split from
its host time.

Counterpart of ``bench/profile_variants.py``, with its flags and strategy
names.  Each strategy gets one result: ``ms`` (``cuda_time_ms`` of the
entry point, calls back to back: host work included), ``device_ms`` (the
call captured once in a CUDA graph and replayed, ``graph_time_ms``: its
kernels alone), ``gflops`` (2·nnz·N over ``ms``) and ``correct`` (the gate
against the f64 oracle).  The gap between ``ms`` and ``device_ms`` is the
host's.  A strategy that cannot be captured keeps ``device_ms: null`` with
its ``capture_error``; every hand kernel (the tile family) must capture.

Strategies: ``xla_segment_sum`` (the gather path), ``pallas_tile_tk{tk}_c
{ch}`` (K3 at 128-row tiles), ``pallas_c_resident`` (K5a),
``pallas_staged_b`` (K4), ``xla_densify_matmul`` (dense A, built once,
times B) and ``vendor_bcoo`` (cuSPARSE, ``torch.sparse`` CSR @ B).  K5a
and K4 run where the card's residency rules admit the plan
(``cres_spmm.fits_card_out``, ``csr_vmem.fits_whole_b``), densify where
m·k·4 ≤ 2^29; otherwise the result says ``inadmissible``, with the rule's
figures.  A strategy that raises gets an ``error`` result, and the tool
exits 1 after printing its line, as it does when a result is incorrect.

Usage::

    python -m tpuspmm_torch.tools.profile_variants -d large_25605
        [--width 256] [--repeats 30] [--tile-ks 128,256,512]
        [--chunks 128] [--skip xla,tile,cres,staged,densify,vendor]
        [--random ROWSxCOLSxDENSITY] [--device cuda]

With ``--device cpu`` the times are the host clock's and there is no
``device_ms``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

DENSIFY_MAX_BYTES = 1 << 29


def load_operands(args):
    """(A, B as f32 numpy, testcase name) as JAX's tool builds them."""
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import CSR, convert

    if args.random:
        r, c, d = args.random.split("x")
        a = CSR.random(int(r), int(c), float(d), seed=0)
        b = (np.random.default_rng(1)
             .uniform(-1, 1, (int(c), args.width)).astype(np.float32))
        return a, b, f"random_{args.random}"
    if args.data_dir is None:
        raise SystemExit("give --data-dir or --random")
    d = data_dir(args.data_dir) or args.data_dir
    a = convert.load_sparse(d, "csr")
    b = np.asarray(convert.load_dense(d, width=args.width).data,
                   dtype=np.float32)
    return a, b, args.data_dir


def strategies(a, args, device) -> list:
    """(name, fn of B or None, inadmissible record or None) in JAX's
    order."""
    from tpuspmm_torch.formats.tiles import plan_from_container
    from tpuspmm_torch.kernels import cres_spmm, csr_vmem, tile_spmm
    from tpuspmm_torch.ops import vendor, xla

    skip = set(args.skip.split(",")) if args.skip else set()
    out = []
    if "xla" not in skip:
        out.append(("xla_segment_sum",
                    lambda bb: xla.spmm_csr_xla(a, bb), None))
    if "tile" not in skip:
        for tk in (int(x) for x in args.tile_ks.split(",")):
            for ch in (int(x) for x in args.chunks.split(",")):
                plan = plan_from_container(a, tile_m=128, tile_k=tk,
                                           chunk=ch)
                print(f"#   plan tk={tk} chunk={ch}: {plan.num_chunks} "
                      f"chunks ({plan.num_chunks * ch / max(a.nnz, 1):.1f}x"
                      " padding)", file=sys.stderr)
                out.append((f"pallas_tile_tk{tk}_c{ch}",
                            lambda bb, plan=plan: tile_spmm.spmm_tiles(
                                plan, bb), None))
    plan = plan_from_container(a)
    if "cres" not in skip:
        if cres_spmm.fits_card_out(plan.tile_m, device):
            out.append(("pallas_c_resident",
                        lambda bb: cres_spmm.spmm_cres(plan, bb), None))
        else:
            out.append(("pallas_c_resident", None,
                        cres_spmm.residency(plan, device)))
    if "staged" not in skip:
        k_pad = plan.num_k_tiles * plan.tile_k
        if csr_vmem.fits_whole_b(k_pad, plan.tile_m, plan.tile_k, device):
            out.append(("pallas_staged_b",
                        lambda bb: csr_vmem.spmm_staged(plan, bb), None))
        else:
            out.append(("pallas_staged_b", None,
                        csr_vmem.residency(plan, device)))
    if "densify" not in skip:
        dense_bytes = a.shape[0] * a.shape[1] * 4
        if dense_bytes <= DENSIFY_MAX_BYTES:
            out.append(("xla_densify_matmul",
                        lambda bb: xla.spmm_densify_cached(a, bb), None))
        else:
            out.append(("xla_densify_matmul", None,
                        {"rule": "dense f32 A of at most 2^29 bytes",
                         "dense_bytes": dense_bytes}))
    if "vendor" not in skip:
        out.append(("vendor_bcoo",
                    lambda bb: vendor.spmm_vendor(a, bb), None))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-d", "--data-dir", default=None)
    p.add_argument("--random", default=None, metavar="ROWSxCOLSxDENSITY",
                   help="synthetic CSR instead of a data dir, e.g. "
                        "2048x2048x0.1")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--repeats", type=int, default=30)
    p.add_argument("--tile-ks", default="128,256,512")
    p.add_argument("--chunks", default="128")
    p.add_argument("--skip", default="",
                   help="comma list: xla,tile,cres,staged,densify,vendor")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.sweeps.common import resolve_device
    from tpuspmm_torch.utils.compare import allclose
    from tpuspmm_torch.utils.timing import (card_line, cuda_time_ms,
                                            graph_time_ms, serve_time_ms)

    device = resolve_device(args.device)
    if device is None:
        return 2
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    a, b, testcase = load_operands(args)
    b_dev = torch.from_numpy(b).to(device)
    ref = oracle.spmm_scipy_oracle(a, b)
    n = b.shape[1]
    flops = 2.0 * a.nnz * n
    print(f"# A {a.shape} nnz={a.nnz} (density {a.sparsity:.2e}), N={n}, "
          f"device={device}", file=sys.stderr)

    def bench(name, fn) -> dict:
        rec = {"variant": name}
        try:
            out = fn(b_dev)
            if on_card:
                torch.cuda.synchronize()
            ok = allclose(out, ref)
            del out
            if on_card:
                ms = cuda_time_ms(lambda: fn(b_dev), iters=args.repeats)
            else:
                ms = serve_time_ms(fn, b_dev, iters=args.repeats)
        except Exception as e:  # recorded, and the tool exits 1
            print(f"# {name}: ERROR {type(e).__name__}: {e}",
                  file=sys.stderr)
            return {**rec, "error": f"{type(e).__name__}: {e}"}
        rec.update({"ms": ms, "gflops": flops / (ms / 1e3) / 1e9,
                    "correct": bool(ok), "device_ms": None})
        if on_card:
            try:
                rec["device_ms"] = graph_time_ms(lambda: fn(b_dev),
                                                 iters=args.repeats)
            except Exception as e:  # the library's call may not capture
                torch.cuda.synchronize()
                rec["capture_error"] = f"{type(e).__name__}: {e}"
                if name.startswith("pallas_"):  # a hand kernel
                    rec["error"] = ("a hand kernel must capture: "
                                    + rec["capture_error"])
        print(f"# {name:28s} {ms:9.4f} ms  device "
              f"{rec['device_ms']} ms  {rec['gflops']:9.2f} GFLOP/s  "
              f"correct={ok}", file=sys.stderr)
        return rec

    results = []
    for name, fn, refusal in strategies(a, args, device):
        if fn is None:
            results.append({"variant": name, "inadmissible": refusal})
            print(f"# {name}: inadmissible {refusal}", file=sys.stderr)
        else:
            results.append(bench(name, fn))

    print(json.dumps({"testcase": testcase, "width": n,
                      "nnz": int(a.nnz), "shape": list(a.shape),
                      "device": (torch.cuda.get_device_name(device)
                                 if on_card else "cpu"),
                      "card": card_line() if on_card else "cpu",
                      "timer": "cuda_events" if on_card else "host",
                      "results": results}), flush=True)
    failed = [r["variant"] for r in results
              if "error" in r or r.get("correct") is False]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
