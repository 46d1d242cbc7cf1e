"""The trace reading and every per-layer reader on a small canned trace."""

import pytest

from spmm_bench import harness, spec, trace


def x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


# two steps of two calls, times in µs: kernels at 10-30, 40-50 (step 1)
# and 110-140, 150-160 (step 2); a memset at 45-48 overlaps the second
CANNED = {"traceEvents": [
    x(trace.STEP, "user_annotation", 0, 100),
    x(trace.CALL, "user_annotation", 2, 6),
    x("aten::empty", "cpu_op", 3, 2),
    x("cudaLaunchKernel", "cuda_runtime", 6, 2),
    x(trace.CALL, "user_annotation", 32, 6),
    x("cudaLaunchKernel", "cuda_runtime", 36, 2),
    x("cudaDeviceSynchronize", "cuda_runtime", 40, 55),
    x(trace.STEP, "user_annotation", 100, 70),
    x(trace.CALL, "user_annotation", 102, 6),
    x(trace.CALL, "user_annotation", 143, 5),
    x("cudaDeviceSynchronize", "cuda_runtime", 148, 20),
    x("spmm_kernel", "kernel", 10, 20),
    x("spmm_kernel", "kernel", 40, 10),
    x("Memset (Device)", "gpu_memset", 45, 3),
    x("spmm_kernel", "kernel", 110, 30),
    x("other_kernel", "kernel", 150, 10),
    # a device-side projection of an annotation is no device operation
    x(trace.STEP, "gpu_user_annotation", 0, 100),
    # outside the traced steps
    x("spmm_kernel", "kernel", 500, 10),
]}


def test_segment_of_the_canned_trace():
    seg = trace.segment(CANNED)
    assert seg.steps == 2 and seg.calls == 4
    assert seg.window_s == pytest.approx(170e-6)
    assert len(seg.device_ops) == 5
    # busy: 10-30, 40-50, 110-140, 150-160 = 70 µs
    assert seg.busy_s == pytest.approx(70e-6)
    # gaps: 0-10, 30-40, 50-110, 140-150, 160-170
    assert sorted(s for _, s in seg.gaps) == pytest.approx(
        sorted([10e-6, 10e-6, 60e-6, 10e-6, 10e-6]))
    names = dict((round(s * 1e6), n) for n, s in seg.gaps)
    assert names[60] == "spmm_bench.step > cudaDeviceSynchronize"
    gaps = {n for n, _ in seg.gaps}
    assert "spmm_bench.call > cudaLaunchKernel" not in gaps
    # at 5 µs the host is in aten::empty inside the first call
    assert "spmm_bench.call > aten::empty" in gaps


def test_breakdown_of_the_canned_trace():
    b = trace.breakdown(trace.segment(CANNED))
    assert b["device_ops"][0] == ["spmm_kernel", pytest.approx(60e-6)]
    assert [n for n, _ in b["device_ops"]] == ["spmm_kernel", "other_kernel",
                                               "Memset (Device)"]
    assert b["idle_gaps"][0][1] == pytest.approx(60e-6)
    assert len(b["idle_gaps"]) <= trace.TOP


def test_a_trace_without_steps_is_refused():
    with pytest.raises(ValueError, match="annotation"):
        trace.segment({"traceEvents": [x("k", "kernel", 0, 1)]})
    with pytest.raises(ValueError, match="no runtime call"):
        trace.segment({"traceEvents": []}, steps=1, calls=1)


# the same two steps traced with the device's activity alone: runtime calls
# and device operations, no annotation and no host operator
DEVICE_ONLY = {"traceEvents": [
    e for e in CANNED["traceEvents"]
    if e["cat"] in ("cuda_runtime", "kernel", "gpu_memset")]}


def test_a_device_only_trace_takes_its_window_from_its_events():
    seg = trace.segment(DEVICE_ONLY, steps=2, calls=4)
    assert seg.steps == 2 and seg.calls == 4
    # the first launch at 6 µs to the kernel outside the steps at 510 µs:
    # a device-only trace holds only what the traced steps ran, so every
    # event counts
    assert seg.window_s == pytest.approx(504e-6)
    assert seg.busy_s == pytest.approx(80e-6)
    in_steps = trace.segment({"traceEvents": DEVICE_ONLY["traceEvents"][:-1]},
                             steps=2, calls=4)
    # 6 µs to the last synchronize's end at 168 µs
    assert in_steps.window_s == pytest.approx(162e-6)
    assert in_steps.busy_s == pytest.approx(70e-6)
    assert len(in_steps.device_ops) == 5


def ctx(segment, **kw):
    base = dict(calls=8, call_host_s=80e-6, first_serve_s=[0.5, 0.25],
                segment=segment, least_s=35e-6)
    base.update(kw)
    return harness.Context(**base)


def read(name, c):
    return spec.reader(name)(c)


def test_every_reader_on_the_canned_trace():
    seg = trace.segment(CANNED)
    c = ctx(seg)
    assert read("api.host_us_per_call", c) == pytest.approx(10.0)
    assert read("plans.first_serve_s", c) == pytest.approx(0.75)
    # least 35 µs over 70 µs of device time
    assert read("spmm_roofline", c) == pytest.approx(50.0)
    assert read("kernels.launches_per_call", c) == pytest.approx(5 / 4)
    assert read("device.idle_frac", c) == pytest.approx(1 - 70 / 170)


def test_readers_return_nothing_without_something_to_read():
    empty = trace.segment({"traceEvents": [x(trace.STEP, "user_annotation",
                                             0, 10)]})
    for name in ("spmm_roofline", "kernels.launches_per_call",
                 "device.idle_frac"):
        assert read(name, ctx(empty)) is None
        assert read(name, ctx(None)) is None
    assert read("spmm_roofline", ctx(trace.segment(CANNED),
                                     least_s=None)) is None
    assert read("api.host_us_per_call", ctx(None, calls=0)) is None
    assert read("plans.first_serve_s", ctx(None, first_serve_s=[])) is None
