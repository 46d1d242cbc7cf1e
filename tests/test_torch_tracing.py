"""The port's spans (``tpuspmm_torch/utils/profiling.py``), on the CPU.

- With no profiler a repeat ``spmm`` enters no span: the hot spans'
  counts do not move, and a recorder that raises is never reached.
- A served handle's build records one ``served.build`` holding one
  ``served.decide`` and one ``served.bind``, once per operand, B width, B
  dtype and row; K6's term planes record once per operand.
- Under ``torch.profiler`` each ``spmm`` call is a ``tpuspmm_torch.spmm``
  range holding its handle's lookup (``tpuspmm_torch.served``) and then
  its launch (``tpuspmm_torch.launch.<route>``) in the Chrome trace, and
  the table counts the same calls; a profiler's warm-up steps record
  nothing.
"""

import json
import sys
import threading

import numpy as np
import pytest
import scipy.sparse
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import tpuspmm_torch
from tpuspmm_torch.kernels import bsr_cuda, bsr_spmm, dispatch
from tpuspmm_torch.utils import profiling

HOT = ("tpuspmm_torch.spmm", "tpuspmm_torch.served")
BUILD = ("tpuspmm_torch.served.build", "tpuspmm_torch.served.decide",
         "tpuspmm_torch.served.bind")
TERM_PLANES = "tpuspmm_torch.bsr.term_planes"


def csr():
    sp = scipy.sparse.random(96, 160, density=0.08, format="csr",
                             random_state=np.random.default_rng(3),
                             dtype=np.float32)
    return tpuspmm_torch.CSR.from_scipy(sp)


def bsr():
    return tpuspmm_torch.BSR.random_blocks(256, 384, (128, 128), 0.5, 7)


OPERANDS = {"csr": csr, "bsr": bsr}


def b_for(a, n=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(n)
    return torch.randn(a.shape[1], n, generator=g).to(dtype)


def counts(names=None) -> dict:
    snap = profiling.snapshot()
    names = snap if names is None else names
    return {name: snap.get(name, (0, 0.0))[0] for name in names}


def grew(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def launch_span(a, b) -> str:
    return f"tpuspmm_torch.launch.{dispatch.route(a, b)}"


@pytest.mark.parametrize("kind", sorted(OPERANDS))
def test_no_profiler_enters_no_span(kind, monkeypatch):
    a = OPERANDS[kind]()
    b = b_for(a)
    want = tpuspmm_torch.spmm(a, b)  # builds the handle
    names = HOT + BUILD + (launch_span(a, b),)
    before = counts(names)

    def refuse(name):
        raise AssertionError(f"span {name!r} entered with no profiler")

    monkeypatch.setattr(profiling, "span", refuse)
    for _ in range(5):
        got = tpuspmm_torch.spmm(a, b)
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert counts(names) == before


def test_a_span_records_a_count_and_its_time():
    name = "tests.tracing.span"
    before = profiling.snapshot().get(name, (0, 0.0))
    with profiling.span(name):
        pass
    with pytest.raises(ValueError):
        with profiling.span(name):
            raise ValueError("a block that raises is recorded too")
    count, seconds = profiling.snapshot()[name]
    assert count == before[0] + 2 and seconds >= before[1]
    # a snapshot is a copy
    profiling.snapshot()[name] = (0, 0.0)
    assert profiling.snapshot()[name] == (count, seconds)


def test_spans_of_many_threads_lose_no_count():
    """Each thread writes a table of its own; the snapshot sums them."""
    name = "tests.tracing.threads"
    before = profiling.snapshot().get(name, (0, 0.0))[0]
    workers, each = 16, 2000

    def work():
        for _ in range(each):
            with profiling.span(name):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.snapshot()[name][0] == before + workers * each


@pytest.mark.parametrize("kind", sorted(OPERANDS))
def test_one_build_per_operand_width_dtype_and_row(kind, monkeypatch):
    a = OPERANDS[kind]()
    before = counts(BUILD)
    tpuspmm_torch.spmm(a, b_for(a, 16))
    tpuspmm_torch.spmm(a, b_for(a, 16))
    assert grew(before, counts(BUILD)) == dict.fromkeys(BUILD, 1)
    tpuspmm_torch.spmm(a, b_for(a, 32))
    assert grew(before, counts(BUILD)) == dict.fromkeys(BUILD, 2)
    tpuspmm_torch.spmm(a, b_for(a, 16, torch.bfloat16))
    tpuspmm_torch.spmm(a, b_for(a, 32))
    assert grew(before, counts(BUILD)) == dict.fromkeys(BUILD, 3)
    monkeypatch.setitem(dispatch.H100_FIT, "serve_panel_us",
                        dispatch.H100_FIT["serve_panel_us"] + 1.0)
    tpuspmm_torch.spmm(a, b_for(a, 16))
    tpuspmm_torch.spmm(a, b_for(a, 16))
    assert grew(before, counts(BUILD)) == dict.fromkeys(BUILD, 4)


def test_term_planes_record_once_per_operand(monkeypatch):
    """K6's binding on the card builds the term planes once per operand
    and device (``bsr_spmm.stream_launch``); the kernel's binding is
    stood in for, as the CPU has no card."""
    monkeypatch.setattr(bsr_cuda, "bind",
                        lambda *args, **kw: (lambda b: None))
    before = counts((TERM_PLANES,))
    a = bsr()
    for n in (16, 16, 32):
        bsr_spmm.stream_launch(a, b_for(a, n))
    assert grew(before, counts((TERM_PLANES,))) == {TERM_PLANES: 1}
    bsr_spmm.stream_launch(bsr(), b_for(a, 16))
    assert grew(before, counts((TERM_PLANES,))) == {TERM_PLANES: 2}


def traced(tmp_path, calls):
    """The Chrome trace's complete events of ``calls()`` under a profiler
    of the CPU, the table's counts before and after."""
    path = str(tmp_path / "trace.json")
    before = counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    return events, grew(before, counts())


def inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] and inner is not outer)


@pytest.mark.parametrize("kind", sorted(OPERANDS))
def test_a_call_is_its_lookup_then_its_launch_in_the_trace(kind, tmp_path):
    a = OPERANDS[kind]()
    b = b_for(a)
    tpuspmm_torch.spmm(a, b)
    launch = launch_span(a, b)
    calls = 3

    def run():
        for _ in range(calls):
            tpuspmm_torch.spmm(a, b)

    events, table = traced(tmp_path, run)
    by_name = {name: [e for e in events if e["name"] == name]
               for name in HOT + (launch,)}
    assert {n: len(v) for n, v in by_name.items()} == dict.fromkeys(
        by_name, calls)
    assert all(e["cat"] == "cpu_op" for v in by_name.values() for e in v)
    assert table == dict.fromkeys(HOT + (launch,), calls)
    for call in by_name["tpuspmm_torch.spmm"]:
        (served,) = [e for e in by_name["tpuspmm_torch.served"]
                     if inside(e, call)]
        (launched,) = [e for e in by_name[launch] if inside(e, call)]
        # siblings: the launch starts after the lookup ends
        assert served["ts"] + served["dur"] <= launched["ts"]


def test_a_build_under_the_profiler_nests_in_the_lookup(tmp_path):
    a = bsr()
    b = b_for(a)
    events, table = traced(tmp_path, lambda: tpuspmm_torch.spmm(a, b))
    assert table == dict.fromkeys(HOT + BUILD + (launch_span(a, b),), 1)
    spans = {e["name"]: e for e in events
             if e["name"] in HOT + BUILD}
    assert inside(spans["tpuspmm_torch.served.build"],
                  spans["tpuspmm_torch.served"])
    for part in BUILD[1:]:
        assert inside(spans[part], spans["tpuspmm_torch.served.build"])


def test_warm_up_steps_record_no_hot_span(tmp_path):
    """The hot spans record in a profiler's active steps only, the steps
    its trace holds."""
    a = csr()
    b = b_for(a)
    tpuspmm_torch.spmm(a, b)
    names = HOT + (launch_span(a, b),)
    before = counts(names)
    plan = schedule(wait=1, warmup=2, active=3, repeat=1)
    with profile(activities=[ProfilerActivity.CPU], schedule=plan) as prof:
        for _ in range(6):
            tpuspmm_torch.spmm(a, b)
            prof.step()
    assert grew(before, counts(names)) == dict.fromkeys(names, 3)
