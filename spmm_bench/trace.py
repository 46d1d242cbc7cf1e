"""Reading of a profiler trace (``torch.profiler``'s Chrome trace).

The harness traces two runs of steps: one that records the device's
activity alone, with no annotation, and one that records the host too,
each step wrapped in a ``STEP`` annotation and each ``spmm`` call in a
``CALL`` annotation.  From a trace:

- the window: the first traced step's start to the last one's end (with
  no annotation, the first runtime call or device operation to the end of
  the last);
- the device operations in it (categories ``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), their union (busy time) and the gaps between them;
- each gap named by what the host was doing at its middle: the
  innermost host event (an annotation, an operator or a runtime call)
  that covers it, under the innermost harness annotation around it;
- ``breakdown``: the device operations that took most time, by name, and
  the longest gaps, each by its name.

Times in the trace are microseconds; what this module returns is seconds.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

STEP = "spmm_bench.step"
CALL = "spmm_bench.call"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation") + RUNTIME_CATEGORIES
TOP = 10


@dataclasses.dataclass
class Segment:
    """The device's view of the traced steps."""
    window_s: float
    steps: int
    calls: int
    device_ops: list      # [(name, start_us, dur_us)] in the window
    busy_s: float         # union of the device operations
    gaps: list            # [(name, seconds)] of each idle gap, longest first

    def idle_by_name(self) -> list:
        """[(name, seconds)] of idle time summed by what the host did."""
        total = collections.Counter()
        for name, secs in self.gaps:
            total[name] += secs
        return total.most_common()


def _complete(events: list, categories) -> list:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in categories and "dur" in e]


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and merged."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _name_gaps(gaps: list, host: list) -> list:
    """[(name, seconds)] of each (start, end) gap: what the host was doing
    at its middle, the innermost harness annotation and the innermost host
    event covering that instant (one sweep over both, by time)."""
    host = sorted(host, key=lambda e: e["ts"])
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    active, nxt, named = [], 0, [None] * len(gaps)
    for i in order:
        t = (gaps[i][0] + gaps[i][1]) / 2
        while nxt < len(host) and host[nxt]["ts"] <= t:
            heapq.heappush(active, (host[nxt]["ts"] + host[nxt]["dur"],
                                    nxt))
            nxt += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        covering = [host[j] for _, j in active]
        if not covering:
            name = "host: outside any traced event"
        else:
            inner = min(covering, key=lambda e: e["dur"])["name"]
            ours = [e for e in covering
                    if e["name"].startswith("spmm_bench.")]
            outer = (min(ours, key=lambda e: e["dur"])["name"] if ours
                     else inner)
            name = inner if outer == inner else f"{outer} > {inner}"
        named[i] = (name, (gaps[i][1] - gaps[i][0]) / 1e6)
    return sorted(named, key=lambda g: -g[1])


def segment(trace: dict, steps: int | None = None,
            calls: int | None = None) -> Segment:
    """The traced steps' window, device operations, busy time and named
    idle gaps, from a Chrome trace's JSON object.

    With ``STEP`` annotations the window is their span and the steps and
    calls are counted from the annotations.  A trace of the device's
    activity alone has none: its window runs from its first runtime call
    or device operation to the end of its last, and ``steps`` and
    ``calls`` are the caller's counts of what it traced."""
    events = trace.get("traceEvents", [])
    host = _complete(events, HOST_CATEGORIES)
    device = _complete(events, DEVICE_CATEGORIES)
    marks = [e for e in host if e["name"] == STEP]
    if marks:
        lo = min(e["ts"] for e in marks)
        hi = max(e["ts"] + e["dur"] for e in marks)
        steps = len(marks)
        calls = sum(1 for e in host if e["name"] == CALL)
    elif steps is not None and calls is not None:
        span = [e for e in host if e["cat"] in RUNTIME_CATEGORIES] + device
        if not span:
            raise ValueError("no runtime call or device operation in the "
                             "trace")
        lo = min(e["ts"] for e in span)
        hi = max(e["ts"] + e["dur"] for e in span)
    else:
        raise ValueError(f"no {STEP!r} annotation in the trace, and no "
                         "count of the steps traced")
    ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in device
           if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    merged = union((max(lo, s), min(hi, s + d)) for _, s, d in ops)
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named = _name_gaps(gaps, host)
    return Segment(window_s=(hi - lo) / 1e6, steps=int(steps),
                   calls=int(calls), device_ops=ops, busy_s=busy / 1e6,
                   gaps=named)


def breakdown(seg: Segment) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time (summed by name) and the longest idle gaps by what the host was
    doing, at most ``TOP`` each, seconds as measured."""
    by_name = collections.Counter()
    for name, _, dur in seg.device_ops:
        by_name[name] += dur / 1e6
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in seg.gaps[:TOP]]}
