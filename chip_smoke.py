#!/usr/bin/env python3
"""Drive tpuspmm_torch's serving path and its CSR / COO engine on one
NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Prints one JSON object per phase:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off for the plain versions;
2. build: compiles both CUDA sources of tpuspmm_torch/csrc with nvcc, one
   process each, started together;
3. kernels: on large_25605 at B width 256 (f32 and bf16 B), the panel and
   pair kernels' entry points against their plain PyTorch versions on the
   same plan at "highest" and "split2", the gate against the f64 oracle
   at "highest", and both times (CUDA events); the host seconds of the
   panel and pair geometry searches;
4. tile kernels: launch counts of the tile-plan kernels zeroed, then on
   the same operands K3 tile, K4 staged, K5a C-resident and K5b
   C-resident k-loop against their plain versions on one tile plan, at
   the "split" and "split2" tiers; the gate against the f64 oracle at
   "split"; times of kernel and plain; the plan's chunk count, sentinel
   shares and slab count.  K5b's count is read here: no engine variant
   reaches it, as in the JAX package.  In phases 3 and 4 a "split2"
   result is held to SPLIT2_TOL·max|C|, and at f32 B the f32-tier output
   must differ from the split2 plain by more than that (the control).
   K5a's and K5b's outputs must equal K3's bit for bit: on the card the
   three are one owner walk over the row-major plan;
5. serving path: launch counts zeroed, then only ``tpuspmm_torch.spmm``
   runs: large_25605 w256 in f32 and bf16 with the default config, and
   again with the panel strip count pinned (``Config(panel_strips=16)``),
   one record in bench.py's shape each; then the corpus dirs large_15120,
   large_21074, medium_2048 and medium_4096, each checked at the gate.
   The counts are read as this path's launches.  With the model's step
   and strip costs unfitted, pair never prices below panel at the default
   config (it ties), so the default serves panel; the pinned P prices
   panel higher and the dispatcher serves pair;
6. engine: every launch count zeroed, then ``tpuspmm_torch.cli.main``
   runs ``--csr --coo`` on large_25605 ``--width 256`` in f32 and bf16 B,
   and ``--csr`` on medium_2048 and medium_4096 at their on-disk widths
   (B 2048 and 4096 wide: the staged kernel slabs).  Every variant record
   is admitted and checked, or skipped as inadmissible; none carries an
   error; every variant that is not verified-only passes the gate.  The
   counts are read as the engine's launches: panel, pair, tile, staged
   and C-resident each rose.  The full records go to
   ``build/engine_records.jsonl``;
7. dispatch routes: ``tpuspmm_torch.spmm`` on small_32x32 (densify) and
   medium_1484 (compensated), each at the gate;
8. entry points: counts zeroed again, the panel and pair entry points on
   the serving corpus, each checked at the gate; counted apart;
9. extreme-value dirs (medium_1484/2880/4000, large_20000): the panel and
   pair kernels against their plain versions; the gate is printed, not
   required (the dispatcher serves these by the compensated path);
10. the kernels line, the card line, and the final ok line.

Any failed phase raises, and the script exits non-zero.  It exits
non-zero without a result when no CUDA device is present or when the
tpuspmm_torch package is not beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = "large_25605"
WIDTH = 256
MAIN_CORPUS = ("large_15120", "large_21074", "medium_2048", "medium_4096")
EXTREME_CORPUS = ("medium_1484", "medium_2880", "medium_4000", "large_20000")
# engine runs: (cli arguments, what the run must show)
ENGINE_RUNS = (
    ["--csr", "--coo", "-d", HEADLINE, "--width", str(WIDTH)],
    ["--csr", "--coo", "-d", HEADLINE, "--width", str(WIDTH),
     "--b-dtype", "bf16"],
    ["--csr", "-d", "medium_2048"],
    ["--csr", "-d", "medium_4096"],
)
ROUTES = {"small_32x32": "densify", "medium_1484": "exact"}
# kernel against its plain version: both sum f32 products (exact for bf16
# operands) in different orders, so they differ by f32 rounding only
PLAIN_TOL = 1e-4
# at "split2" both run the 2-term tier term for term, so they differ by f32
# rounding only, held below the tier's own error (~2^-17·max|C|): a kernel
# that computed plain f32 products there fails, and each phase shows it
# (the f32-tier output against the split2 plain must exceed this)
SPLIT2_TOL = 2.0 ** -20


def plain_tol(mode: str) -> float:
    return SPLIT2_TOL if mode == "split2" else PLAIN_TOL


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
    from tpuspmm_torch import cli
    from tpuspmm_torch.formats import tiles
    from tpuspmm_torch.kernels import (chunk_cuda, cres_spmm, csr_vmem,
                                       cuda_build, dispatch, pair_spmm,
                                       panel_spmm, strip_cuda, tile_spmm)
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
    libraries = (strip_cuda.LIBRARY, chunk_cuda.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    emit("build", sources=[os.path.relpath(lib.source, REPO)
                           for lib in libraries],
         seconds=time.perf_counter() - t0,
         flags=" ".join(cuda_build.NVCC_FLAGS))

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

    def against_plain(name, plan, b, timed: bool,
                      mode: str = "highest") -> dict:
        """One kernel launch against its plain version on the same plan;
        launches made here are reset by the caller's window."""
        fn, plain = entries[name]
        before = fn.launches
        got = fn(plan, b, mode)
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{name} launch counter rose")
        want = plain(plan, b, mode)
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} output finite, shape {tuple(want.shape)}")
        err = max_abs_err(got, want)
        scale = float(want.abs().max())
        tol = plain_tol(mode)
        check(err <= tol * scale,
              f"{name} {mode} |kernel - plain| {err} <= {tol}*{scale}")
        out = {"max_abs_err": err, "max_abs_c": scale, "out": got,
               "want": want}
        if timed:
            out["ms"] = cuda_time_ms(lambda: fn(plan, b, mode))
            out["plain_ms"] = cuda_time_ms(lambda: plain(plan, b, mode))
        return out

    def split2_control(name, f32_tier_out, split2_plain) -> dict:
        """At f32 B the f32-tier output differs from the split2 plain by
        more than SPLIT2_TOL·max|C|: that tolerance tells the tiers apart,
        so a kernel ignoring "split2" would fail it."""
        gap = max_abs_err(f32_tier_out, split2_plain)
        scale = float(split2_plain.abs().max())
        check(gap > SPLIT2_TOL * scale,
              f"{name} control: |f32 tier - split2 plain| {gap} > "
              f"{SPLIT2_TOL}*{scale}")
        return {"f32_tier_vs_split2_plain": gap,
                "limit": SPLIT2_TOL * scale}

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
            r2 = against_plain(name, plan, b, timed=False, mode="split2")
            control = (split2_control(name, r["out"], r2["want"])
                       if b.dtype == torch.float32 else None)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             r["max_abs_err"])
            stats[name]["max_abs_err_split2"] = max(
                stats[name].get("max_abs_err_split2", 0.0),
                r2["max_abs_err"])
            stats[name][f"ms_{tag}"] = r["ms"]
            stats[name][f"plain_ms_{tag}"] = r["plain_ms"]
            emit("kernel_vs_plain", kernel=name, testcase=HEADLINE,
                 b_dtype=tag, geometry=geometry(plan),
                 max_abs_err=r["max_abs_err"], max_abs_c=r["max_abs_c"],
                 tolerance=f"{PLAIN_TOL}*max|C| (f32 sums in another order)",
                 gate=gate, ms=r["ms"], plain_ms=r["plain_ms"],
                 split2={"max_abs_err": r2["max_abs_err"],
                         "max_abs_c": r2["max_abs_c"],
                         "tolerance": f"{SPLIT2_TOL}*max|C|",
                         "control": control})
            del r, r2

    # ---- 4. tile-plan kernels against plain versions --------------------
    tile_entries = {
        "tile": (tile_spmm.spmm_tiles,
                 lambda p, b, m: tile_spmm.spmm_tiles(p, b, mode=m),
                 tile_spmm.tile_spmm_plain, ("split", "split2")),
        "staged": (csr_vmem.spmm_staged,
                   lambda p, b, m: csr_vmem.spmm_staged(p, b, mode=m),
                   lambda p, b, m: csr_vmem.staged_spmm_plain(
                       p, b, *csr_vmem.slab_geometry(p, b.device), m),
                   ("split", "split2")),
        "cres": (cres_spmm.spmm_cres,
                 lambda p, b, m: cres_spmm.spmm_cres(p, b, mode=m),
                 lambda p, b, m: cres_spmm.cres_spmm_plain(p, b, m,
                                                           "block8"),
                 ("split", "split2")),
        "cres_kloop": (cres_spmm.spmm_cres_kloop,
                       lambda p, b, m: cres_spmm.spmm_cres_kloop(p, b, m),
                       lambda p, b, m: cres_spmm.cres_spmm_plain(p, b, m,
                                                                 "kloop"),
                       ("split", "split2")),
    }
    for counter, *_ in tile_entries.values():
        counter.launches = 0
    tplan = tiles.plan_from_container(a)
    blk = cres_spmm._kmajor_blocks(tplan)
    num_slabs, slab_k = csr_vmem.slab_geometry(tplan, dev)
    emit("tile_plan", testcase=HEADLINE, chunks=tplan.num_chunks,
         nnz_per_chunk=a.nnz / tplan.num_chunks,
         sentinel_slot_share=float((tplan.rows < 0).mean()),
         block8_sentinel_chunk_share=float((blk["rt8"] < 0).mean()),
         num_slabs=num_slabs, slab_k=slab_k,
         residency={"staged": csr_vmem.residency(tplan, dev),
                    "cres": cres_spmm.residency(tplan, dev)})
    # K3, K5a and K5b run one owner walk over the row-major plan on the
    # card: their outputs must be bit-identical
    tile_out = {}
    for name, (counter, fn, plain, modes) in tile_entries.items():
        stats[name] = {"max_abs_err": 0.0}
        for b in (b32, b16):
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            f32_tier = None
            for mode in modes:
                before = counter.launches
                got = fn(tplan, b, mode)
                torch.cuda.synchronize()
                check(counter.launches == before + 1,
                      f"{name} launch counter rose")
                want = plain(tplan, b, mode)
                torch.cuda.synchronize()
                check(got.shape == want.shape
                      and bool(torch.isfinite(got).all()),
                      f"{name} output finite, shape {tuple(want.shape)}")
                err = max_abs_err(got, want)
                scale = float(want.abs().max())
                tol = plain_tol(mode)
                check(err <= tol * scale,
                      f"{name} {mode} |kernel - plain| {err} <= "
                      f"{tol}*{scale}")
                gate = allclose(got, refs[b.dtype])
                rec = {"max_abs_err": err, "max_abs_c": scale, "gate": gate,
                       "tolerance": f"{tol}*max|C|"}
                if mode == "split2" and b.dtype == torch.float32:
                    rec["control"] = split2_control(name, f32_tier, want)
                if name == "tile":
                    tile_out[tag, mode] = got
                elif name in ("cres", "cres_kloop"):
                    rec["bit_identical_to_tile"] = bool(
                        torch.equal(got, tile_out[tag, mode]))
                    check(rec["bit_identical_to_tile"],
                          f"{name} {tag} {mode} output equals K3's")
                if mode == "split":
                    stats[name]["max_abs_err"] = max(
                        stats[name]["max_abs_err"], err)
                    check(gate, f"{name} {tag} gate vs f64 oracle")
                    rec["ms"] = cuda_time_ms(lambda: fn(tplan, b, mode))
                    rec["plain_ms"] = cuda_time_ms(
                        lambda: plain(tplan, b, mode))
                    stats[name][f"ms_{tag}"] = rec["ms"]
                    stats[name][f"plain_ms_{tag}"] = rec["plain_ms"]
                    f32_tier = got  # on the card "split" is f32 FMAs
                else:
                    stats[name]["max_abs_err_split2"] = max(
                        stats[name].get("max_abs_err_split2", 0.0), err)
                emit("tile_kernel_vs_plain", kernel=name, testcase=HEADLINE,
                     b_dtype=tag, mode=mode, **rec)
                del got, want
            del f32_tier
    del tile_out
    tile_window = {name: counter.launches
                   for name, (counter, *_) in tile_entries.items()}
    emit("tile_kernel_launches", **tile_window)

    # ---- 5. serving path: tpuspmm_torch.spmm only -----------------------
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
            device=gpu, extra={"bSource": cdense.b_source}))
        corpus[name] = (ca, b, ref)
        del out

    launches = {n: fn.launches for n, (fn, _) in entries.items()}
    emit("serving_path_launches", **launches,
         note="tpuspmm_torch.spmm calls only (serves, timing loops)")
    for name, count in launches.items():
        check(count > 0, f"{name} kernel launched on the serving path")

    # ---- 6. engine: tpuspmm_torch.cli ------------------------------------
    counters = {"panel": panel_spmm.spmm_panel, "pair": pair_spmm.spmm_pair,
                **{n: c for n, (c, *_) in tile_entries.items()}}
    for counter in counters.values():
        counter.launches = 0
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    records_path = os.path.join(REPO, "build", "engine_records.jsonl")
    with open(records_path, "w"):
        pass
    for args in ENGINE_RUNS:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            status = cli.main(args)
        secs = time.perf_counter() - t0
        recs = [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]
        with open(records_path, "a") as f:
            f.write(out.getvalue())
        check(status == 0, f"engine {args} exit status {status}")
        check(recs, f"engine {args} printed records")
        for r in recs:
            what = f"engine {args} {r['format']} {r['kernelType']} " \
                   f"{r['kernelName']}"
            check("error" not in r, f"{what}: {r.get('error')}")
            check(r.get("skipped") == "inadmissible" or r["correct"] in
                  ("0", "1"), f"{what} checked or skipped")
            if r.get("verifiedOnly") != "1" and "skipped" not in r:
                check(r["correct"] == "1", f"{what} passes the gate")
        emit("engine", args=" ".join(args), seconds=secs, records=[
            {"fmt": r["format"], "k": int(r["kernelType"]),
             "name": r["kernelName"],
             "correct": r.get("skipped") or r["correct"],
             "ms": r["cudaKernelTimeMs"],
             **({"verifiedOnly": 1} if r.get("verifiedOnly") else {})}
            for r in recs])
    engine_launches = {n: c.launches for n, c in counters.items()}
    emit("engine_launches", **engine_launches,
         note="tpuspmm_torch.cli.main runs only; no engine variant "
              "reaches the k-loop schedule, as in the JAX package")
    for name in ("panel", "pair", "tile", "staged", "cres"):
        check(engine_launches[name] > 0, f"{name} launched by the engine")

    # ---- 7. dispatch routes ----------------------------------------------
    for name, want in ROUTES.items():
        ra, rdense = load(name)
        rb = torch.from_numpy(rdense.data).to(dev)
        got_route = dispatch.route(ra, rb)
        check(got_route == want, f"{name} routes to {want} ({got_route})")
        out = tpuspmm_torch.spmm(ra, rb)
        gate = allclose(out, oracle.spmm_scipy_oracle(ra, rdense.data))
        check(gate, f"{name} {want} route gate vs f64 oracle")
        emit("dispatch_route", testcase=name, route=got_route, gate=gate,
             bCols=int(rb.shape[1]),
             ms=cuda_time_ms(lambda: tpuspmm_torch.spmm(ra, rb)))
        del rb, out

    # ---- 8. entry points, counted apart ---------------------------------
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

    # ---- 9. extreme-value dirs: kernels against plain versions ----------
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
                  "gate is printed, not required; the dispatcher serves "
                  "these by the compensated path where admissible")
        del b

    # ---- 10. kernels line, card, ok --------------------------------------
    kernels = {  # name: (C entry, source, TPU kernel body it replaces)
        "panel": ("panel_strip_spmm", "strip_spmm.cu",
                  "tpuspmm/kernels/panel_spmm.py:1050"),
        "pair": ("pair_strip_spmm", "strip_spmm.cu",
                 "tpuspmm/kernels/pair_spmm.py:267"),
        "tile": ("tile_chunk_spmm", "chunk_spmm.cu",
                 "tpuspmm/kernels/tile_spmm.py:43"),
        "staged": ("staged_chunk_spmm", "chunk_spmm.cu",
                   "tpuspmm/kernels/csr_vmem.py:89"),
        "cres": ("cres_chunk_spmm", "chunk_spmm.cu",
                 "tpuspmm/kernels/cres_spmm.py:53"),
        "cres_kloop": ("cres_kloop_chunk_spmm", "chunk_spmm.cu",
                       "tpuspmm/kernels/cres_spmm.py:163"),
    }
    lines = []
    for name, (entry, source, replaces) in kernels.items():
        if name == "cres_kloop":
            count, window = tile_window[name], "tile_kernels_vs_plain"
        else:
            count, window = engine_launches[name], "engine (cli.main)"
        line = {"name": entry, "route": "cuda",
                "source": f"tpuspmm_torch/csrc/{source}",
                "replaces": replaces, "launches": count,
                "launches_window": window,
                "max_abs_err": stats[name]["max_abs_err"],
                "max_abs_err_split2": stats[name].get("max_abs_err_split2"),
                "ms": stats[name]["ms_f32"],
                "plain_ms": stats[name]["plain_ms_f32"],
                "ms_bf16": stats[name]["ms_bf16"],
                "plain_ms_bf16": stats[name]["plain_ms_bf16"]}
        if name in ("cres", "cres_kloop"):
            line["note"] = ("the owner walk of tile_chunk_spmm over the "
                            "row-major plan: output bit-identical to K3's")
        if name in launches:
            line["serving_path_launches"] = launches[name]
            line["entry_point_launches"] = entry_launches[name]
        lines.append(line)
    print(json.dumps({"kernels": lines}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
