#!/usr/bin/env python3
"""Drive tpuspmm_torch's CSR serving path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Prints one JSON object per phase:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off for the plain versions;
2. build: compiles the CUDA kernels of tpuspmm_torch/csrc with nvcc;
3. kernels: on large_25605 at B width 256 (f32 and bf16 B), each kernel's
   entry point against its plain PyTorch version on the same plan, the
   gate against the f64 oracle, and both times (CUDA events); the host
   seconds of the panel and pair geometry searches and plan builds;
4. main path: launch counts are zeroed, then only ``tpuspmm_torch.spmm``
   runs: large_25605 w256 in f32 and bf16 with the default config, and
   again with the panel strip count pinned (``Config(panel_strips=16)``),
   one record in bench.py's shape each; then the corpus dirs large_15120,
   large_21074, medium_2048 and medium_4096, each checked at the gate.
   The counts are read as the main path's launches.  With the model's
   step and strip costs unfitted, pair never prices below panel at the
   default config (it ties), so the default serves panel; the pinned P
   prices panel higher and the dispatcher serves pair;
5. entry points: counts zeroed again, both kernels' entry points on the
   same corpus dirs, each checked at the gate; their counts are read
   apart from the main path's;
6. extreme-value dirs (medium_1484/2880/4000, large_20000): both kernels
   against their plain versions; the gate is printed, not required;
7. the kernels line, the card line, and the final ok line.

Any failed phase raises, and the script exits non-zero.  It exits
non-zero without a result when no CUDA device is present or when the
tpuspmm_torch package is not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = "large_25605"
WIDTH = 256
MAIN_CORPUS = ("large_15120", "large_21074", "medium_2048", "medium_4096")
EXTREME_CORPUS = ("medium_1484", "medium_2880", "medium_4000", "large_20000")
# kernel against its plain version: both sum f32 products (exact for bf16
# operands) in different orders, so they differ by f32 rounding only
PLAIN_TOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import tpuspmm_torch
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.config import Config
    from tpuspmm_torch.kernels import dispatch, pair_spmm, panel_spmm
    from tpuspmm_torch.kernels import strip_cuda
    from tpuspmm_torch.ops import exact, oracle, vendor
    from tpuspmm_torch.utils.compare import allclose, max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    gpu = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. environment ----------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    emit("environment", gpu=gpu, nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device_count=torch.cuda.device_count())

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    strip_cuda.load()
    emit("build", source=os.path.relpath(strip_cuda.SOURCE, REPO),
         seconds=time.perf_counter() - t0,
         flags=" ".join(strip_cuda.NVCC_FLAGS))

    def load(name: str):
        d = data_dir(name)
        check(d is not None, f"corpus dir {name} present")
        a = convert.load_sparse(d, "csr")
        dense = convert.load_dense(d, width=WIDTH)
        return a, dense

    entries = {
        "panel": (panel_spmm.spmm_panel, panel_spmm.panel_spmm_plain),
        "pair": (pair_spmm.spmm_pair, pair_spmm.pair_spmm_plain),
    }

    cap = panel_spmm.PLAN_BYTES_CAP

    def resolved(a, n_pad, panel_strips=None):
        """The panel and pair geometries the dispatcher resolves."""
        return (panel_spmm.resolve_panel_geometry(
                    a, n_pad, panel_strips=panel_strips, plan_bytes_cap=cap,
                    device=dev),
                pair_spmm.resolve_pair_geometry(a, n_pad, plan_bytes_cap=cap,
                                                device=dev))

    def plan_of(a, kernel, geom, n_pad):
        if kernel == "panel":
            return panel_spmm.panel_plan_from_geometry(a, geom)
        return pair_spmm.pair_plan_from_container(
            a, chunk_strips=geom.chunk_strips, n_pad=n_pad, geom=geom,
            device=dev)

    def main_path_plans(a, n_pad):
        """Both kernels' plans at the geometries the dispatcher resolves,
        and the host seconds of each search and build (dispatch order:
        the pair search runs after the panel search)."""
        t0 = time.perf_counter()
        geom = panel_spmm.resolve_panel_geometry(a, n_pad,
                                                 plan_bytes_cap=cap,
                                                 device=dev)
        t1 = time.perf_counter()
        pgeom = pair_spmm.resolve_pair_geometry(a, n_pad, plan_bytes_cap=cap,
                                                device=dev)
        t2 = time.perf_counter()
        plans = {"panel": plan_of(a, "panel", geom, n_pad)}
        t3 = time.perf_counter()
        plans["pair"] = plan_of(a, "pair", pgeom, n_pad)
        t4 = time.perf_counter()
        secs = {"panel_search_s": t1 - t0, "pair_search_s": t2 - t1,
                "panel_build_s": t3 - t2, "pair_build_s": t4 - t3,
                "panel_cost_us": geom.cost_us, "pair_cost_us": pgeom.cost_us}
        return plans, secs

    def geometry(plan) -> dict:
        g = {"tm": plan.tm, "tk": plan.tk, "sm": plan.sm,
             "order": "natural" if plan.row_perm is None else "permuted",
             "plan_mb": plan.plan_bytes / 2 ** 20,
             "plan_bf16": plan.a_dense.dtype == np.uint16}
        if hasattr(plan, "panel_strips"):
            g["P"] = plan.panel_strips
        else:
            g["CH"] = plan.chunk_strips
        return g

    def against_plain(name, plan, b, timed: bool) -> dict:
        """One kernel launch against its plain version on the same plan;
        launches made here are reset by the caller's window."""
        fn, plain = entries[name]
        before = fn.launches
        got = fn(plan, b)
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{name} launch counter rose")
        want = plain(plan, b)
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} output finite, shape {tuple(want.shape)}")
        err = max_abs_err(got, want)
        scale = float(want.abs().max())
        check(err <= PLAIN_TOL * scale,
              f"{name} |kernel - plain| {err} <= {PLAIN_TOL}*{scale}")
        out = {"max_abs_err": err, "max_abs_c": scale, "out": got}
        if timed:
            out["ms"] = cuda_time_ms(lambda: fn(plan, b))
            out["plain_ms"] = cuda_time_ms(lambda: plain(plan, b))
        return out

    # ---- 3. kernels against plain versions -----------------------------
    a, dense = load(HEADLINE)
    b32 = torch.from_numpy(dense.data).to(dev)
    b16 = b32.to(torch.bfloat16)
    refs = {torch.float32: oracle.spmm_scipy_oracle(a, dense.data),
            torch.bfloat16: oracle.spmm_scipy_oracle(
                a, b16.float().cpu().numpy())}
    plans, plan_secs = main_path_plans(a, WIDTH)
    emit("plan_time", testcase=HEADLINE, **plan_secs,
         note="host seconds, first resolve of a fresh container; the "
              "model's costs are plan bytes over bandwidth (step and strip "
              "costs unfitted)")
    stats = {name: {"max_abs_err": 0.0} for name in entries}
    for name, plan in plans.items():
        for b in (b32, b16):
            r = against_plain(name, plan, b, timed=True)
            gate = allclose(r["out"], refs[b.dtype])
            check(gate, f"{name} {b.dtype} gate vs f64 oracle")
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             r["max_abs_err"])
            stats[name][f"ms_{tag}"] = r["ms"]
            stats[name][f"plain_ms_{tag}"] = r["plain_ms"]
            emit("kernel_vs_plain", kernel=name, testcase=HEADLINE,
                 b_dtype=tag, geometry=geometry(plan),
                 max_abs_err=r["max_abs_err"], max_abs_c=r["max_abs_c"],
                 tolerance=f"{PLAIN_TOL}*max|C| (f32 sums in another order)",
                 gate=gate, ms=r["ms"], plain_ms=r["plain_ms"])

    # ---- 4. main path: tpuspmm_torch.spmm only -------------------------
    for fn, _ in entries.values():
        fn.launches = 0

    def served_by(call):
        before = {n: fn.launches for n, (fn, _) in entries.items()}
        out = call()
        torch.cuda.synchronize()
        ran = [n for n, (fn, _) in entries.items()
               if fn.launches > before[n]]
        check(len(ran) == 1, f"one kernel served the call (got {ran})")
        return out, ran[0]

    def modelled_kernel(a, n_pad, config) -> str:
        geom, pgeom = resolved(a, n_pad, config.panel_strips)
        return "pair" if pgeom.cost_us < geom.cost_us else "panel"

    vendor_out = vendor.spmm_vendor(a, b32)
    check(allclose(vendor_out, refs[torch.float32]), "vendor gate")
    vendor_ms = cuda_time_ms(lambda: vendor.spmm_vendor(a, b32))
    m, k = a.shape
    flops = report.spmm_flops(a.nnz, WIDTH)
    bw = dispatch.thresholds(dev)["panel_hbm_gbps"] * 1e9
    sol_s = report.spmm_min_bytes(a.nnz, m, k, WIDTH) / bw
    for config in (Config(), Config(panel_strips=16)):
        out32, kernel = served_by(lambda: tpuspmm_torch.spmm(a, b32,
                                                             config=config))
        check(kernel == modelled_kernel(a, WIDTH, config),
              f"dispatch served the lower modelled time ({kernel})")
        correct = allclose(out32, refs[torch.float32])
        check(correct, f"main path f32 gate vs f64 oracle ({kernel})")
        out16, kernel16 = served_by(lambda: tpuspmm_torch.spmm(
            a, b16, config=config))
        bf16_correct = allclose(out16, refs[torch.bfloat16])
        check(bf16_correct, f"main path bf16 gate vs f64 oracle ({kernel})")
        check(kernel16 == kernel, "same kernel for f32 and bf16 B")
        kernel_ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(a, b32,
                                                            config=config))
        bf16_ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(a, b16,
                                                          config=config))
        geom, pgeom = resolved(a, WIDTH, config.panel_strips)
        plan = plan_of(a, kernel, geom if kernel == "panel" else pgeom, WIDTH)
        plain_fn = entries[kernel][1]
        plain_ms = cuda_time_ms(lambda: plain_fn(plan, b32))
        emit("main_path", **{
            "metric": f"csr_spmm_gflops_{HEADLINE}_w{WIDTH}",
            "config": {"panel_strips": config.panel_strips},
            "kernel": kernel,
            "panel_cost_us": geom.cost_us, "pair_cost_us": pgeom.cost_us,
            "value": flops / (kernel_ms * 1e-3) / 1e9,
            "unit": "GFLOP/s",
            "vs_baseline": vendor_ms / kernel_ms,
            "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "vendor_ms": vendor_ms,
            "nnz_per_s": a.nnz / (kernel_ms * 1e-3),
            "hbm_roofline_frac": sol_s / (kernel_ms * 1e-3),
            "correct": correct,
            "bf16_serving_ms": bf16_ms,
            "bf16_serving_correct": bf16_correct,
            "geometry": geometry(plan),
            "gpu": gpu,
            "power_limit": card.split(",")[-1].strip(),
            "bCols": WIDTH, "bDtype": "f32", "bSource": dense.b_source,
        })
        del out32, out16

    corpus = {}
    for name in MAIN_CORPUS:
        ca, cdense = load(name)
        check(not (exact.needs_compensated(ca)
                   and exact.exact_admissible(ca)),
              f"{name} is served by the panel / pair path")
        b = torch.from_numpy(cdense.data).to(dev)
        ref = oracle.spmm_scipy_oracle(ca, cdense.data)
        out, served = served_by(lambda: tpuspmm_torch.spmm(ca, b))
        check(allclose(out, ref), f"{name} dispatch gate")
        ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(ca, b))
        emit("corpus", **report.make_record(
            testcase=name, sparsity=ca.sparsity, fmt="csr", kernel_type=0,
            kernel_name=served, correct=True, kernel_ms=ms, n=b.shape[1],
            extra={"bSource": cdense.b_source}))
        corpus[name] = (ca, b, ref)
        del out

    launches = {n: fn.launches for n, (fn, _) in entries.items()}
    emit("main_path_launches", **launches,
         note="tpuspmm_torch.spmm calls only (serves, timing loops)")
    for name, count in launches.items():
        check(count > 0, f"{name} kernel launched on the main path")

    # ---- 5. entry points, counted apart ---------------------------------
    for fn, _ in entries.values():
        fn.launches = 0
    for name in MAIN_CORPUS:
        ca, b, ref = corpus.pop(name)
        gates = {kname: allclose(fn(ca, b), ref)
                 for kname, (fn, _) in entries.items()}
        torch.cuda.synchronize()
        check(all(gates.values()), f"{name} entry-point gates {gates}")
        emit("entry_points", testcase=name, gates=gates)
        del b
    entry_launches = {n: fn.launches for n, (fn, _) in entries.items()}
    emit("entry_point_launches", **entry_launches)
    for name, count in entry_launches.items():
        check(count > 0, f"{name} kernel launched through its entry point")

    # ---- 6. extreme-value dirs: kernels against plain versions ----------
    for name in EXTREME_CORPUS:
        ca, cdense = load(name)
        b = torch.from_numpy(cdense.data).to(dev)
        ref = oracle.spmm_scipy_oracle(ca, cdense.data)
        cplans, _ = main_path_plans(ca, ((b.shape[1] + 127) // 128) * 128)
        rec = {"needs_compensated": exact.needs_compensated(ca),
               "exact_admissible": exact.exact_admissible(ca),
               "bCols": int(b.shape[1])}
        for kname, plan in cplans.items():
            # held to PLAIN_TOL·max|C| inside against_plain; the kernels
            # line reports the headline's absolute errors, not these
            # (|C| reaches 1e16 here)
            r = against_plain(kname, plan, b, timed=False)
            rec[kname] = {"max_abs_err": r["max_abs_err"],
                          "max_abs_c": r["max_abs_c"],
                          "gate": allclose(r["out"], ref)}
            del r
        emit("extreme_values", testcase=name, **rec,
             note="|values| beyond the 2e4 cut-off: a plain-f32 result "
                  "passes the gate only by luck of the operand, so the "
                  "gate is printed, not required; tpuspmm serves these "
                  "with its compensated path where admissible")
        del b

    # ---- 7. kernels line, card, ok ---------------------------------------
    replaces = {"panel": "tpuspmm/kernels/panel_spmm.py:1050",
                "pair": "tpuspmm/kernels/pair_spmm.py:267"}
    print(json.dumps({"kernels": [
        {"name": f"{name}_strip_spmm", "route": "cuda",
         "source": "tpuspmm_torch/csrc/strip_spmm.cu",
         "replaces": replaces[name], "launches": launches[name],
         "launches_window": "main_path (tpuspmm_torch.spmm only)",
         "entry_point_launches": entry_launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms_f32"], "plain_ms": stats[name]["plain_ms_f32"],
         "ms_bf16": stats[name]["ms_bf16"],
         "plain_ms_bf16": stats[name]["plain_ms_bf16"]}
        for name in entries]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
