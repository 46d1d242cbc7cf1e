"""Profiler tracing and the port's spans (counterpart of
``tpuspmm/utils/profiling.py``, which has the trace alone).

``trace(log_dir)`` wraps a region in ``torch.profiler.profile`` with the
CPU and CUDA activities (the CPU alone when there is no card) and writes
a Chrome trace, ``TRACE_FILE`` in ``log_dir``, when the region ends: the
kernels the region launched appear in it under their CUDA symbols, beside
the host work that led to each and the port's own spans.  View it in
Perfetto or chrome://tracing.

Usage::

    with trace("build/trace"):
        C = tpuspmm_torch.spmm(A, B)

or ``python -m tpuspmm_torch.cli --csr -d DIR --trace build/trace``.  A
profiler that cannot start raises.

``span(name)`` marks one layer's work: a range in the running profiler's
trace (a ``cpu_op`` event, on the clock of the device activity beside it)
and a count and a duration added to this process's table of spans,
``snapshot()``.  The spans a ``spmm`` call passes (``ops/api.spmm``,
``kernels/dispatch.spmm_pallas``) are entered only while a profiler is
recording (``torch.autograd.profiler._is_profiler_enabled``, false in a
profiler's warm-up steps): with none a call reads that flag and enters
nothing.  The spans of a served handle's build (``dispatch.served``) and
of K6's term planes (``bsr_spmm.term_planes``) run once an operand and
are always entered.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast

TRACE_FILE = "trace.json"

# each thread's table of the spans it closed, {span name: [count,
# nanoseconds]}: a thread writes only its own, so a span takes no lock
_LOCAL = threading.local()
_TABLES: list = []
_TABLES_LOCK = threading.Lock()


def _thread_table() -> dict:
    table = _LOCAL.table = {}
    with _TABLES_LOCK:
        _TABLES.append(table)
    return table


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


class span:
    """``with span(name):`` records the block as a range named ``name`` in
    the running profiler's trace (none is needed) and adds one and the
    block's host time (``perf_counter_ns``) to ``name``'s entry of the
    table.  A block that raises is recorded too.  The table is written
    inside the range, so the trace puts the span's own cost under its
    name."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = _RecordFunctionFast(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        ns = time.perf_counter_ns() - self._t0
        try:
            table = _LOCAL.table
        except AttributeError:
            table = _thread_table()
        entry = table.get(self.name)
        if entry is None:
            table[self.name] = [1, ns]
        else:
            entry[0] += 1
            entry[1] += ns
        self._range.__exit__(exc_type, exc, tb)
        return False


def snapshot() -> dict:
    """{span name: (count, seconds)}: every span this process closed since
    it started, summed over its threads (a span that another thread closes
    while the copy is taken may show its count before its time)."""
    with _TABLES_LOCK:
        tables = [dict(table) for table in _TABLES]
    total = {}
    for table in tables:
        for name, (count, ns) in table.items():
            c, t = total.get(name, (0, 0))
            total[name] = (c + count, t + ns)
    return {name: (count, ns / 1e9) for name, (count, ns) in total.items()}
