"""Measured memory controls: what share of its data-sheet bandwidth the
card delivers to well-formed programs.

Counterpart of ``bench/hbm_control.py``.  Prints one JSON line per
control, each with the card line (``nvidia-smi``'s name and power limit):

- ``stream``      — y = 2x + 1 over ``--stream-mb`` of f32 in one pass
  (one read, one write, no other work; ``csrc/stream.cu``, one kernel:
  eager ``2 * x + 1`` is two), held equal to ``2 * x + 1``: the card's
  practical ceiling for a pure stream.  Beside it the plain version's
  time and one PyTorch call of the same function (``torch.addcmul``).
- ``matmul_sol``  — a dense bf16 A with the bytes of the port's own panel
  plan of the headline (``--data-dir``, large_25605, at ``--width`` 256)
  times a bf16 B, f32 C out (``torch.mm``; bf16 C where the card's torch
  has no f32 output for it): the same bytes the panel kernel streams,
  through cuBLAS.
- ``matmul_pair`` — the same with A sized to the pair plan's bytes.

The plans' rows and bytes are computed at run time and printed in the
records; ``bytes`` counts what each call reads and writes once.
``frac_of_nominal`` divides by the card's data-sheet rate
(``engine/report.hbm_gbps``, which raises on a card it does not know).
Times are CUDA events around each call, the least median of
``--repeats`` windows, with the L2 cache flushed before each call (a
buffer of twice its size written), so ``frac_of_nominal`` reads device
memory; ``ms_l2_warm`` is the same calls back to back
(``utils/timing.cuda_time_ms``), as the kernels are timed.  With
``--device cpu`` (tests, at a small ``--stream-mb``) the times are the
host clock's and no ``frac_of_nominal`` is given.

Usage::

    python -m tpuspmm_torch.tools.hbm_control [--repeats 3]
        [--stream-mb 64] [--data-dir large_25605] [--width 256]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

STREAM_ITERS = 8
MATMUL_ITERS = 16


def plan_controls(data_dir: str, width: int, device) -> dict:
    """name: (A rows, plan bytes) of the port's panel and pair plans of
    ``data_dir`` at ``width`` columns, the geometries the dispatcher
    resolves for ``device``."""
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm
    from tpuspmm_torch.kernels.common import round_up

    a = convert.load_sparse(data_dir, "csr")
    n_pad = round_up(width, 128)
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a, n_pad, plan_bytes_cap=cap,
                                             device=device)
    panel = panel_spmm.panel_plan_from_geometry(a, geom)
    pgeom = pair_spmm.resolve_pair_geometry(a, n_pad, plan_bytes_cap=cap,
                                            device=device)
    pair = pair_spmm.pair_plan_from_container(
        a, chunk_strips=pgeom.chunk_strips, n_pad=n_pad, geom=pgeom,
        device=device)
    return {"matmul_sol": (panel.m_pad, panel.plan_bytes),
            "matmul_pair": (pair.m_pad, pair.plan_bytes)}


def mm_call(a: torch.Tensor, b: torch.Tensor):
    """(the product's call, C's dtype): ``torch.mm`` with an f32 output
    where this torch offers it for bf16 operands on their device (tried
    once here), else with a bf16 output."""
    try:
        torch.mm(a[:8, :8], b[:8, :8], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.mm(a, b)), a.dtype
    return (lambda: torch.mm(a, b, out_dtype=torch.float32)), torch.float32


def timer(device, repeats: int):
    """(cold, warm): ms of one call, the least median of ``repeats``
    windows.  On a card, CUDA events around each call; ``cold`` first
    writes a buffer of twice the L2 cache before each call, so the call
    reads its operands from device memory, ``warm`` runs the calls back
    to back.  On the CPU both are the host clock's, back to back."""
    from tpuspmm_torch.utils.timing import cuda_time_ms, serve_time_ms

    if device.type != "cuda":
        def host(fn, iters: int) -> float:
            return serve_time_ms(lambda _: fn(), torch.empty(0), iters=iters,
                                 windows=max(1, repeats))

        return host, host
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    scratch = torch.empty(2 * l2 // 4, dtype=torch.float32, device=device)

    def window(fn, iters: int) -> float:
        fn()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            scratch.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))

    def cold(fn, iters: int) -> float:
        return min(window(fn, iters) for _ in range(max(1, repeats)))

    def warm(fn, iters: int) -> float:
        return min(cuda_time_ms(fn, iters=iters)
                   for _ in range(max(1, repeats)))

    return cold, warm


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--stream-mb", type=int, default=64)
    p.add_argument("--data-dir", default="large_25605",
                   help="corpus dir whose panel / pair plans size the "
                        "matmul controls")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.engine.report import hbm_gbps
    from tpuspmm_torch.kernels import stream_cuda
    from tpuspmm_torch.sweeps.common import resolve_device
    from tpuspmm_torch.utils.timing import card_line

    device = resolve_device(args.device)
    if device is None:
        return 2
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line() if on_card else "cpu"
    nominal = hbm_gbps(torch.cuda.get_device_name(device)) * 1e9 \
        if on_card else None
    time_ms, warm_ms = timer(device, args.repeats)

    def rates(bytes_moved: int, ms: float) -> dict:
        out = {"bytes": bytes_moved, "ms": ms,
               "gbps": bytes_moved / (ms / 1e3) / 1e9,
               "timer": "cuda_events" if on_card else "host"}
        if nominal is not None:
            out["nominal_gbps"] = nominal / 1e9
            out["frac_of_nominal"] = bytes_moved / (ms / 1e3) / nominal
        return out

    records = []
    # ---- stream: one read, one write ------------------------------------
    n_el = args.stream_mb * 1024 * 1024 // 4
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n_el)
                         .astype(np.float32)).to(device)
    y = stream_cuda.stream(x)
    want = stream_cuda.stream_plain(x)
    one, two = (torch.tensor(v, dtype=torch.float32, device=device)
                for v in (1.0, 2.0))
    library = torch.addcmul(one, x, two)
    equal = bool(torch.equal(y, want))
    records.append({
        "control": "stream", "card": card, "elements": n_el,
        "equal_to_plain": equal,
        "max_abs_err": float((y - want).abs().max()),
        "library_equal": bool(torch.equal(library, want)),
        **rates(2 * n_el * 4, time_ms(lambda: stream_cuda.stream(x),
                                      STREAM_ITERS)),
        "ms_l2_warm": warm_ms(lambda: stream_cuda.stream(x), STREAM_ITERS),
        "plain_ms": time_ms(lambda: stream_cuda.stream_plain(x),
                            STREAM_ITERS),
        "library_ms": time_ms(lambda: torch.addcmul(one, x, two),
                              STREAM_ITERS),
        "library_call": "torch.addcmul(1, x, 2)"})
    del x, y, want, library

    # ---- dense products moving the headline plans' bytes ------------------
    d = data_dir(args.data_dir)
    if d is None:
        raise SystemExit(f"no corpus dir {args.data_dir!r}")
    rng = np.random.default_rng(0)
    for name, (m_pad, plan_bytes) in plan_controls(
            d, args.width, device).items():
        n_pad = -(-args.width // 128) * 128
        kd = max(128, int(round(plan_bytes / (m_pad * 2) / 128)) * 128)
        a = torch.from_numpy(rng.standard_normal((m_pad, kd)).astype(
            np.float32)).to(device, torch.bfloat16)
        b = torch.from_numpy(rng.standard_normal((kd, n_pad)).astype(
            np.float32)).to(device, torch.bfloat16)
        mm, c_dtype = mm_call(a, b)
        c_size = mm().element_size()
        ms = time_ms(mm, MATMUL_ITERS)
        ms_warm = warm_ms(mm, MATMUL_ITERS)
        flops = 2.0 * m_pad * kd * n_pad
        records.append({
            "control": name, "card": card, "testcase": args.data_dir,
            "width": args.width, "m": m_pad, "kd": kd, "n": n_pad,
            "plan_bytes": plan_bytes, "c_dtype": str(c_dtype),
            **rates(m_pad * kd * 2 + kd * n_pad * 2 + m_pad * n_pad * c_size,
                    ms),
            "ms_l2_warm": ms_warm, "gflops": flops / (ms / 1e3) / 1e9})
        del a, b, mm

    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
