"""One run of one cell: set-up, warm-up, the measured window, the traced
steps and the comparison with the reference.

A step is the traffic's calls, each ``spmm(a, b)`` with a B of the seeded
pool, then one synchronize; the next step starts when it returns (a closed
loop, one caller).  The window counts every step that started in it.

- ``gflops``: 2 · stored entries · N of every call of the window over the
  host clock from the first step's start to the last step's return.
- ``step_ms_p95``: the 95th percentile of the steps' latencies, each read
  by CUDA events around the step (the host clock is too coarse for a step
  under a millisecond); the start event runs when the step's first call is
  enqueued, since the device is idle after the previous synchronize.
- ``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over set-up and
  window (reset when the run starts), read when the window closes.
- ``setup_s``: from the run's start to the window's start.

An end-to-end metric is named by its quantity, and may add ``.`` and the
class of cells whose spread it is held to (``gflops.decode``).

With ``trace`` the window also records the benchmark's span around each
call, and after it two bounded runs of steps go under ``torch.profiler``
(``trace.py``): one that records the device alone, with no annotation,
for the device's busy time, the window's length and the device operations;
and a shorter one that records the host too, each step and call
annotated, only to name what the host was doing in each idle gap.  The
per-layer readers (``metrics/``) take their numbers from those.

``correct``: one step in each band of ``DRAW_BANDS`` of the expected
window is drawn from the seed.  Just before a drawn step the pool entries
it reads are written over in place with new values (``traffic.fresh_b``),
so an answer that a program kept from an earlier call on the same storage
reads wrong.  The outputs of about ``COMPARED_CALLS`` of its calls, drawn
from the seed in proportion to each output shape, are kept and compared with the plain reference on the new
values once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import time

import numpy as np
import torch

from spmm_bench import counts, operands, reference, spec, trace, traffic

# the traced steps: about this long, at most this many, after the
# profiler's own warm-up steps; the pass that names the idle gaps traces
# at most NAMED_MAX_CALLS calls
PROFILED_SECONDS = 0.5
PROFILED_MAX_STEPS = 200
PROFILER_WARMUP_STEPS = 5
NAMED_MAX_CALLS = 2000
# the compared steps: one drawn in each band of the expected window (as
# shares of its steps), about COMPARED_CALLS calls of each drawn
DRAW_BANDS = ((0.0, 0.1), (0.1, 0.45), (0.45, 0.8))
COMPARED_CALLS = 16


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    calls: int                 # spmm calls of the window
    call_host_s: float         # the harness's spans around them, summed
    first_serve_s: list        # each operand's first serve, synchronized
    segment: object            # trace.Segment of the traced steps, or None
    least_s: float | None      # least time of the traced calls (counts.py)


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class _Clock:
    """Per-step latency: CUDA events on the card, the host clock on the
    CPU (where only tests run the harness)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def start(self):
        if self.cuda:
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Synchronize; the step's latency in ms."""
        if self.cuda:
            self.events[1].record()
            torch.cuda.synchronize()
            return self.events[0].elapsed_time(self.events[1])
        return (time.perf_counter() - self.t0) * 1e3


def _drawn(seed: int, expected_steps: int, shapes_of) -> dict:
    """{step: [call index, ...]}: the compared steps, one in each of
    ``DRAW_BANDS``, and the compared calls of each, drawn from the seed.
    ``shapes_of(step)`` gives each call's output shape: the calls are drawn
    from each shape in proportion, so every seed keeps outputs of the
    same sizes."""
    rng = np.random.default_rng(operands.derived_seed(seed, "sample"))
    out = {}
    for lo, hi in DRAW_BANDS:
        a = int(lo * expected_steps)
        step = int(rng.integers(a, max(a + 1, int(hi * expected_steps))))
        shapes = shapes_of(step)
        want = min(COMPARED_CALLS, len(shapes))
        picks = []
        for shape in sorted(set(shapes)):
            calls = [i for i, x in enumerate(shapes) if x == shape]
            take = max(1, round(want * len(calls) / len(shapes)))
            picks += [calls[j] for j in rng.permutation(len(calls))[:take]]
        out.setdefault(step, sorted(picks))
    return out


def _window(steps: list, spmm, seconds: float, clock: _Clock, drawn: dict,
            refresh, spans: bool) -> dict:
    """Steps back to back for ``seconds``; before each drawn step
    ``refresh(step)`` writes its B over, and the drawn calls' outputs are
    kept."""
    period = len(steps)
    latency, kept = [], {}
    host_s, failed, error = 0.0, 0, None
    s = 0
    t0 = time.perf_counter()
    t_end = t0
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        calls = steps[s % period]
        if s in drawn:
            refresh(s)
        clock.start()
        try:
            if spans:
                outs = []
                for handle, b in calls:
                    t = time.perf_counter()
                    outs.append(spmm(handle, b))
                    host_s += time.perf_counter() - t
            else:
                outs = [spmm(handle, b) for handle, b in calls]
            latency.append(clock.stop())
        except Exception as exc:  # a failed call ends the window
            failed, error = len(calls), exc
            break
        t_end = time.perf_counter()
        if s in drawn:
            kept[s] = [outs[i] for i in drawn[s]]
        s += 1
    return {"steps": s, "t0": t0, "t_end": t_end, "latency_ms": latency,
            "kept": kept, "host_s": host_s, "failed": failed,
            "error": error}


def _profiled(steps: list, spmm, sync, n_steps: int, activities: list,
              annotate: bool, path: str) -> dict:
    """``n_steps`` steps under torch.profiler (after its warm-up steps),
    each step and call annotated if ``annotate``; the Chrome trace's JSON,
    its file removed."""
    import contextlib
    import json

    from torch.profiler import profile, record_function, schedule

    mark = record_function if annotate else (
        lambda name: contextlib.nullcontext())
    period = len(steps)
    plan = schedule(wait=0, warmup=PROFILER_WARMUP_STEPS, active=n_steps,
                    repeat=1)
    with profile(activities=activities, schedule=plan,
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for s in range(PROFILER_WARMUP_STEPS + n_steps):
            with mark(trace.STEP):
                for handle, b in steps[s % period]:
                    with mark(trace.CALL):
                        spmm(handle, b)
                sync()
            prof.step()
    try:
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _traced(steps: list, spmm, sync, step_s: float, calls_per_step: int,
            device, work_dir: str) -> trace.Segment:
    """The device's view of a bounded run of steps, recorded with the
    device's activity alone (no host events, no annotations), with its
    idle gaps named from a shorter run that records the host too."""
    from torch.profiler import ProfilerActivity

    period = len(steps)
    path = os.path.join(work_dir, "trace.json")
    n = min(PROFILED_MAX_STEPS, max(period, int(PROFILED_SECONDS / step_s)))
    n = period * max(1, n // period)
    named_n = period * max(1, min(n, NAMED_MAX_CALLS // calls_per_step)
                           // period)
    host = [ProfilerActivity.CPU]
    if device.type != "cuda":
        return trace.segment(_profiled(steps, spmm, sync, named_n, host,
                                       True, path))
    seg = trace.segment(_profiled(steps, spmm, sync, n,
                                  [ProfilerActivity.CUDA], False, path),
                        steps=n, calls=n * calls_per_step)
    named = trace.segment(_profiled(steps, spmm, sync, named_n,
                                    host + [ProfilerActivity.CUDA], True,
                                    path))
    return dataclasses.replace(seg, gaps=named.gaps)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, system, root: str, t_start: float, work_dir: str,
             log=sys.stderr) -> dict:
    """One run; the contract's result object (``checks`` last)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    mix, config = cell.traffic, cell.config
    n, b_dtype = int(mix["b_width"]), mix["b_dtype"]

    ops = operands.build(config, seed, device, root)
    names = [op.name for op in ops]
    widths_k = [op.shape[1] for op in ops]
    op_shapes = [tuple(op.shape) for op in ops]
    op_counts = [op.counts() for op in ops]
    pools = traffic.b_pools(widths_k, mix, config["b_values"], seed, device)
    handles = [system.prepare(op) for op in ops]
    del ops
    cycle = traffic.cycle(len(handles), int(mix["calls_per_step"]),
                          int(mix["pool"]))
    steps = [[(handles[o], pools[widths_k[o]][p]) for o, p in step]
             for step in cycle]

    first_serve = []
    for j, handle in enumerate(handles):
        t = time.perf_counter()
        system.spmm(handle, pools[widths_k[j]][0])
        sync()
        first_serve.append(time.perf_counter() - t)
    for j, handle in enumerate(handles):
        print(f"route {names[j]} {system.route(handle, pools[widths_k[j]][0])}"
              f" first_serve_s {first_serve[j]}", file=log)

    clock = _Clock(device)
    period = len(steps)
    warm = period * max(1, math.ceil(int(mix["warmup_steps"]) / period))
    t = time.perf_counter()
    for s in range(warm):
        clock.start()
        for handle, b in steps[s % period]:
            system.spmm(handle, b)
        clock.stop()
    step_s = (time.perf_counter() - t) / warm
    cps = int(mix["calls_per_step"])
    drawn = _drawn(seed, max(1, int(seconds / step_s)),
                   lambda s: [op_shapes[o] for o, _ in cycle[s % period]])

    def fresh(s, k, p):
        return traffic.fresh_b(k, p, s, mix, config["b_values"], seed,
                               device)

    def refresh(s):
        for k, p in sorted({(widths_k[o], p) for o, p in cycle[s % period]}):
            pools[k][p].copy_(fresh(s, k, p))

    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    win = _window(steps, system.spmm, seconds, clock, drawn, refresh,
                  spans=traced)
    sync()
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.unfreeze()

    flops_of = [counts.flops(c, n) for c in op_counts]
    step_flops = [sum(flops_of[o] for o, _ in step) for step in cycle]
    done = win["steps"]
    total_flops = sum(step_flops[s % period] for s in range(done))
    calls = done * cps
    attempted = calls + win["failed"]

    segment = None
    if traced and not win["failed"]:
        segment = _traced(steps, system.spmm, sync, step_s, cps, device,
                          work_dir)
    counters = system.counters()
    if counters:
        print(f"launch counters {counters}", file=log)

    # the program's state and the pools go before the reference runs
    del steps, handles, pools
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the drawn steps that the window reached, each against its B as
    # written just before it
    errs, answers = [], 0
    due = {s: picks for s, picks in drawn.items() if s < done}
    if win["kept"]:
        ops = operands.build(config, seed, device, root)
        for s, outs in sorted(win["kept"].items()):
            step = cycle[s % period]
            bs = {}
            for i, c in zip(drawn[s], outs):
                o, p = step[i]
                k = widths_k[o]
                if (k, p) not in bs:
                    bs[(k, p)] = fresh(s, k, p)
                ref = reference.product(ops[o], bs[(k, p)])
                errs.append(reference.max_rel_err(c, ref))
                answers += 1
                del ref
        del ops
    err = max(errs) if errs else math.inf
    limit = float(config["max_rel_err"])
    need = sum(len(picks) for picks in due.values())
    correct = (not win["failed"] and bool(due) and answers >= need
               and err <= limit)
    if win["error"] is not None:
        print(f"a call raised: {win['error']!r}", file=log)

    result_metrics = {}
    if traced:
        least = None
        if segment is not None and card in counts.PEAKS:
            reps = segment.steps // period
            least = reps * sum(
                counts.least_seconds(op_counts[o], n, b_dtype, card)
                for step in cycle for o, _ in step)
        ctx = Context(calls=calls, call_host_s=win["host_s"],
                      first_serve_s=first_serve, segment=segment,
                      least_s=least)
        for metric in cell.per_layer:
            value = spec.reader(metric["name"], root)(ctx)
            if value is not None:
                result_metrics[metric["name"]] = {"value": value,
                                                  "unit": metric["unit"]}
    else:
        elapsed = win["t_end"] - win["t0"]
        e2e = {"gflops": total_flops / elapsed / 1e9 if elapsed > 0 else None,
               "step_ms_p95": (_percentile(win["latency_ms"], 95)
                               if win["latency_ms"] else None),
               "peak_mem_gb": peak_bytes / 1e9 if cuda else None,
               "setup_s": setup_s}
        for metric in cell.end_to_end:
            value = e2e.get(metric["name"].split(".", 1)[0])
            if value is not None:
                result_metrics[metric["name"]] = {"value": value,
                                                  "unit": metric["unit"]}
    print(f"window steps {done} calls {calls} seconds "
          f"{win['t_end'] - win['t0']} setup_s {setup_s}", file=log)
    lat = win["latency_ms"]
    if len(lat) >= 10:
        parts = [lat[i * len(lat) // 10:(i + 1) * len(lat) // 10]
                 for i in range(10)]
        print("step ms p50 / p95 by tenth of the window "
              f"{[(_percentile(p, 50), _percentile(p, 95)) for p in parts]}",
              file=log)

    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(win["failed"]), "metrics": result_metrics,
              "device": dev}
    if segment is not None:
        dev["busy_s"] = segment.busy_s
        dev["window_s"] = segment.window_s
        result["breakdown"] = trace.breakdown(segment)
        print(f"traced steps {segment.steps} calls {segment.calls} "
              f"device ops {len(segment.device_ops)} idle by host activity "
              f"{segment.idle_by_name()[:10]}", file=log)
    result["checks"] = {"max_rel_err": {"value": err, "limit": limit},
                        "answers": {"value": answers, "limit": need}}
    return result
