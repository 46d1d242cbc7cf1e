"""Profiler tracing (counterpart of ``tpuspmm/utils/profiling.py``).

``trace(log_dir)`` wraps a region in ``torch.profiler.profile`` with the
CPU and CUDA activities (the CPU alone when there is no card) and writes
a Chrome trace, ``TRACE_FILE`` in ``log_dir``, when the region ends: the
kernels the region launched appear in it under their CUDA symbols, beside
the host work that led to each.  View it in Perfetto or chrome://tracing.

Usage::

    with trace("build/trace"):
        C = tpuspmm_torch.spmm(A, B)

or ``python -m tpuspmm_torch.cli --csr -d DIR --trace build/trace``.  A
profiler that cannot start raises.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
