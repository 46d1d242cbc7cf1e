"""run_engine: one format's verification and timing pass.

Counterpart of ``tpuspmm/engine/runner.py`` (the reference's ``runEngine``,
reference/src/engine/engine.cpp:16-61), with its order and record policy:
the float64 oracle (kernel 0), then every variant (1..N) checked at the
gate (rel 1e-2 / abs 1e-3), then the vendor baseline (kernel -1), one
record each.

- An inadmissible variant gets a ``skipped: inadmissible`` record.
- A variant that raises gets an ``error`` record (``correct`` stays "");
  a CUDA error stops the engine's run, since it poisons the context.
- A verified-only variant's record carries ``verifiedOnly: "1"``: a
  ``correct: "0"`` there documents that the tier does not hold for this
  operand; it is not a failure.

Times, on a CUDA device: the kernel time is the median of CUDA-event
times over back-to-back calls (``utils/timing.cuda_time_ms``); the prolog
is the first call's host time (planning, transfers, the kernel build)
minus the median host time of a synchronised call; the epilog is the
device→host fetch.  On the CPU all three are host-clock times, and every
record names the device it ran on.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from tpuspmm_torch.engine import report
from tpuspmm_torch.engine.registry import Engine
from tpuspmm_torch.kernels.common import round_up
from tpuspmm_torch.ops import oracle as oracle_mod
from tpuspmm_torch.utils.compare import allclose

_GEOM_FAMILIES = {"pallas_panel": "panel", "pallas_panel_split": "panel",
                  "pallas_pair": "pair", "pallas_pair_split": "pair"}
_RESIDENCY = {"pallas_staged_b": "staged", "pallas_c_resident": "cres",
              "pallas_c_resident_split2": "cres"}


def _provenance(name: str, a, b: torch.Tensor, config) -> dict:
    """What a panel / pair record served (its resolved geometry, a cache
    hit after the variant's own run) and the residency rule a staged or
    C-resident record was admitted by."""
    from tpuspmm_torch.formats.tiles import plan_from_container
    from tpuspmm_torch.kernels import (cres_spmm, csr_vmem, pair_spmm,
                                       panel_spmm)

    n_pad = round_up(int(b.shape[1]), 128)
    family = _GEOM_FAMILIES.get(name)
    if family == "panel":
        g = panel_spmm.resolve_panel_geometry(
            a, n_pad, panel_strips=config.panel_strips,
            plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP, device=b.device)
        return {"geometry": {"family": "panel", "tm": int(g.tm),
                             "P": int(g.panel_strips), "tk": int(g.tk),
                             "sm": int(g.sm), "order": g.order_kind,
                             "plan_mb": round(g.plan_bytes / 1e6, 2)}}
    if family == "pair":
        g = pair_spmm.resolve_pair_geometry(
            a, n_pad, plan_bytes_cap=pair_spmm.PLAN_BYTES_CAP,
            device=b.device)
        return {"geometry": {"family": "pair", "CH": int(g.chunk_strips),
                             "sm": int(g.sm), "order": g.order_kind,
                             "plan_mb": round(g.plan_bytes / 1e6, 2)}}
    kind = _RESIDENCY.get(name)
    if kind is None:
        return {}
    plan = plan_from_container(a, tile_m=config.tile_m, tile_k=config.tile_k,
                               chunk=config.chunk_nnz)
    mod = csr_vmem if kind == "staged" else cres_spmm
    return {"residency": mod.residency(plan, b.device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(fn, b_dev: torch.Tensor, repeats: int):
    """(host result, prolog, kernel, epilog, per-call ms) of ``fn(b)``."""
    from tpuspmm_torch.utils.timing import cuda_time_ms

    device = b_dev.device
    _sync(device)
    t0 = time.perf_counter()
    out = fn(b_dev)
    _sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(max(1, repeats)):
        t1 = time.perf_counter()
        out = fn(b_dev)
        _sync(device)
        times.append((time.perf_counter() - t1) * 1e3)
    per_call_ms = float(np.median(times))
    prolog_ms = max(0.0, first_ms - per_call_ms)
    kernel_ms = (cuda_time_ms(lambda: fn(b_dev), warmup=1,
                              iters=max(8, repeats))
                 if device.type == "cuda" else per_call_ms)
    t2 = time.perf_counter()
    host = out.float().cpu().numpy()
    epilog_ms = (time.perf_counter() - t2) * 1e3
    return host, prolog_ms, kernel_ms, epilog_ms, per_call_ms


def run_engine(engine: Engine, a, b, *, testcase: str = "", config=None,
               skip_seq: bool = False, run_vendor: bool = True,
               repeats: int = 3, emit: bool = True,
               device="cuda") -> List[dict]:
    """Run oracle + all variants + vendor on ``device`` and return (and
    with ``emit`` print) one record per run.  ``b`` is a host operand: a
    float32 numpy array or a float32 / bf16 tensor, served in its dtype;
    the oracles compute on its values in float64."""
    from tpuspmm_torch.config import default_config

    config = config or default_config()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_engine: no CUDA device")
    if not isinstance(b, torch.Tensor):
        b = torch.from_numpy(np.ascontiguousarray(b, dtype=np.float32))
    b_host = b.float().numpy()
    b_dev = b.to(device).contiguous()
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    common = dict(testcase=testcase, sparsity=a.sparsity, fmt=engine.fmt,
                  nnz=a.nnz, shape=a.shape, n=b.shape[1], device=device_name)
    records: List[dict] = []

    # ---- kernel 0: the oracle (engine.cpp:30-37) -------------------------
    seq_ms = 0.0
    if skip_seq:
        ref = oracle_mod.spmm_scipy_oracle(a, b_host)
    else:
        t0 = time.perf_counter()
        ref = oracle_mod.spmm_oracle(a, b_host)
        seq_ms = (time.perf_counter() - t0) * 1e3
        records.append(report.make_record(
            kernel_type=0, kernel_name="oracle_numpy_f64", correct=True,
            sequential_ms=seq_ms, **common))

    def timed_record(number, name, fn, extra):
        host, prolog, kernel, epilog, per_call = timed_run(
            fn, b_dev, repeats)
        ok = allclose(host, ref)
        extra = {"perCallLatencyMs": round(per_call, 4),
                 "timer": ("cuda_events" if device.type == "cuda"
                           else "host_clock"), **extra}
        return report.make_record(
            kernel_type=number, kernel_name=name, correct=ok,
            prolog_ms=prolog, kernel_ms=kernel, epilog_ms=epilog,
            sequential_ms=seq_ms, extra=extra, **common)

    def error_record(number, name, e):
        return report.make_record(
            kernel_type=number, kernel_name=name,
            extra={"error": f"{type(e).__name__}: {e}"}, **common)

    # ---- kernels 1..N (engine.cpp:41-43) ---------------------------------
    device_fault = False
    for v in engine.variants:
        if v.admissible is not None and not v.admissible(a, b_dev, config):
            records.append(report.make_record(
                kernel_type=v.number, kernel_name=v.name,
                extra={"skipped": "inadmissible"}, **common))
            continue
        try:
            extra = {}
            if v.verified_only:
                extra["verifiedOnly"] = "1"
            rec = timed_record(v.number, v.name,
                               lambda bb, v=v: v.fn(a, bb, config), extra)
            rec.update(_provenance(v.name, a, b_dev, config))
        except Exception as e:  # recorded, not raised: the sweep goes on
            rec = error_record(v.number, v.name, e)
            if "CUDA error" in str(e):
                rec["device_fault"] = "1"
                device_fault = True
        records.append(rec)
        if device_fault:
            break

    # ---- kernel -1: vendor baseline (engine.cpp:47-55) -------------------
    if run_vendor and engine.supports_vendor and not device_fault:
        from tpuspmm_torch.ops import vendor

        name = "torch_sparse_csr"
        try:
            records.append(timed_record(
                -1, name, lambda bb: vendor.spmm_vendor(a, bb),
                {"vendorLowering": ("cusparse_csr" if device.type == "cuda"
                                    else "torch_cpu_csr")}))
        except Exception as e:
            records.append(error_record(-1, name, e))

    bdt = "bf16" if b.dtype == torch.bfloat16 else "f32"
    for rec in records:
        rec["bDtype"] = bdt
    if emit:
        for rec in records:
            report.emit(rec)
    return records
