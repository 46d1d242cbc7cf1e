"""Device time of a callable on the card, with CUDA events.

``cuda_time_ms`` warms up, then enqueues ``iters`` calls back to back, each
between a pair of CUDA events, synchronises once and returns the median of
the per-call times.  Calls are not separated by a synchronise, so a call
whose host work is shorter than the previous call's device work adds no
idle time; one whose host work is longer shows that gap, which a serving
caller pays as well.

``graph_time_ms`` is the device time of a callable's kernels: the call
captured once in a CUDA graph and the graph replayed through
``cuda_time_ms``, so the wrapper's host work does not show.  ``card_line``
is the card's name and power limit as ``nvidia-smi`` gives them, which
every time taken on the card is reported beside.

``serve_time_ms`` is the one timer the autotuner (``engine/autotune.py``)
calls: ``cuda_time_ms`` of ``fn(b)`` on a CUDA tensor, so a host-bound
entry point is ranked by what a serve costs, and the host clock's median
on a CPU tensor; with ``windows`` > 1, the least of that many medians, so
a burst of host noise in one window does not decide a ranking.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import numpy as np
import torch


def cuda_time_ms(fn: Callable, warmup: int = 3, iters: int = 20) -> float:
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s line for the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def graph_time_ms(fn: Callable, iters: int = 20) -> float:
    """Device time of ``fn``'s kernels: ``fn`` captured in a CUDA graph and
    replayed.  ``fn`` must have run once already (its plans and device
    arrays built: a capture allocates nothing it keeps)."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        # a capture that fails (a call that synchronises, say) raises
        # from the graph's exit before it leaves its capture stream
        torch.cuda.set_stream(stream)
    torch.cuda.synchronize()
    return cuda_time_ms(graph.replay, iters=iters)


def serve_time_ms(fn: Callable, b: torch.Tensor, iters: int = 8,
                  windows: int = 1) -> float:
    """Median ms of one call ``fn(b)``: CUDA events over ``iters`` back to
    back calls when ``b`` is on the card, the host clock (each call run to
    its end) when it is on the CPU.  With ``windows`` > 1 the median is
    taken in that many windows of ``iters`` calls and the least is
    returned."""
    if b.device.type == "cuda":
        return min(cuda_time_ms(lambda: fn(b), warmup=1, iters=max(1, iters))
                   for _ in range(max(1, windows)))
    fn(b)
    best = float("inf")
    for _ in range(max(1, windows)):
        times = []
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            fn(b)
            times.append((time.perf_counter() - t0) * 1e3)
        best = min(best, float(np.median(times)))
    return best
