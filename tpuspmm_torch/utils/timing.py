"""Device time of a callable on the card, with CUDA events.

``cuda_time_ms`` warms up, then enqueues ``iters`` calls back to back, each
between a pair of CUDA events, synchronises once and returns the median of
the per-call times.  Calls are not separated by a synchronise, so a call
whose host work is shorter than the previous call's device work adds no
idle time; one whose host work is longer shows that gap, which a serving
caller pays as well.
"""

from __future__ import annotations

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
