#!/usr/bin/env python3
"""Time variants of the strip-owner kernel (csrc/strip_spmm.cu) and of the
tile-owner routine (csrc/chunk_spmm.cu) on one NVIDIA GPU.

Run from the repository root:

    python3 strip_sweep.py [--variants NAME,NAME,...]
    python3 strip_sweep.py --chunk [--variants NAME,NAME,...]
    python3 strip_sweep.py --bsr [--variants NAME,...]
    python3 strip_sweep.py --profile-host

Each variant is a copy of the source with some of its lines replaced
(VARIANTS; "serving" is the source as it stands), written to and built in
build/strip_sweep/, one nvcc each, all started together.  The serving
code carries no options: a patch whose text is not in the source exactly
once makes that variant's build record an error.  Every variant runs the
panel plan the dispatcher resolves for each case below, is held against
the plain version (1e-4·max|C|) and timed with CUDA events (median of 20,
L2 warm), in turns with the other variants: ``ms`` replays the launch
captured in a CUDA graph (device time), ``call_ms`` calls the wrapper
(device time, or the wrapper's host time where that is longer).  Prints
the card line, one JSON line per variant with ptxas's registers and spills
per kernel, and one JSON line per (case, B dtype) with each variant's ms.
``--profile-host`` instead profiles the host side of serving calls.

``--bsr`` sweeps the block-streaming kernel K6 (csrc/bsr_spmm.cu):
BSR_VARIANTS patch its source (column tile 64 or 128, ring depths, block
rows in index order against heaviest first, B staged by plain loads
against cp.async, and two controls, which are not held to the tolerance:
three f32-B products instead of six, and 1 KB of a step's A planes copied
instead of all) on BSR_CASES, chip_smoke.py's pruned weights.  Each
variant runs through ``spmm_bsr_stream`` with the variant's library, is
held against the plain version (K6_TOL, 2e-6·max|C|, chip_smoke.py's
limit for K6, which the three-product control must miss with f32 B) and
timed as above.

``--chunk`` sweeps the tile-owner routine (K3, K4, K5a, K5b) instead:
CHUNK_VARIANTS patch its source (column tile, ring depth, launch order,
gathered rows in flight) or change what the host hands it (the dense
path's threshold, with every tile gathered and every tile dense as
controls; a 64-row tile, which runs 4 warps a block), on CHUNK_CASES.
Each variant runs K3's entry on the tile plan, is held against the plain
version on a 128-column slice of B (1e-4·max|C|) and timed as above
(``ms``: graph replay; ``call_ms``: the wrapper).
"""

from __future__ import annotations

import argparse
import ctypes
import io
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "strip_sweep")
NARROW = "const bool narrow = (long long)n_groups * ((n + 127) / 128) < sms;"
WARPS = ("static constexpr int WTM = SPLIT_B ? 64 : 32;",
         "static constexpr int WTN = SPLIT_B ? 16 : 32;")


def warps(m: int, n: int) -> list:
    return [(WARPS[0], f"static constexpr int WTM = {m};"),
            (WARPS[1], f"static constexpr int WTN = {n};")]


def const(name: str, old: int, new: int) -> tuple:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# name: [(text of the source, its replacement), ...].  128-row groups run
# 16 warps a block, so one block an SM keeps their registers at 128
VARIANTS = {
    "serving": [],
    "tn128": [(NARROW, "const bool narrow = false;")],
    "tn64": [(NARROW, "const bool narrow = true;")],
    "group_order": [("if (unit >= sms &&", "if (false &&"),
                    ("group_order[unit / ncol]", "unit / ncol")],
    "warps_64x16": warps(64, 16),
    "warps_32x32": warps(32, 32),
    "one_block_per_sm": [const("BLOCKS", 2, 1)],
    "two_stages": [const("MAX_STAGES", 8, 2)],
    "kc32": [const("KC", 64, 32), const("MAX_STAGES", 8, 16)],
    "rows128": [const("GROUP_ROWS", 64, 128), const("BLOCKS", 2, 1)],
}
# name: ([(text of chunk_spmm.cu, its replacement), ...], dense threshold
# in nonzeros per tile_k (None: the routine's, tile_spmm.DENSE_PER_TILE_K),
# tile_m)
CHUNK_WIDE = ("const int wide = (long long)num_tiles * ((n + WIDE_TN - 1) / "
              "WIDE_TN) >= sms;")
# the gather's loads back to back, and each after its own shuffles
CHUNK_LOADS = """#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j + u < cnt)
          load_b<VEC>(raw[u], b + (size_t)kr[u] * n, col, n, vec);"""
CHUNK_LOADS_INTERLEAVED = """#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        kr[u] = __shfl_sync(FULL, my_col, (j + u) & 31);
        vv[u] = __shfl_sync(FULL, my_val, (j + u) & 31);
        if (j + u < cnt)
          load_b<VEC>(raw[u], b + (size_t)kr[u] * n, col, n, vec);
      }"""
CHUNK_VARIANTS = {
    "serving": ([], None, 128),
    "gather_only": ([], math.inf, 128),
    "dense_only": ([], 0.0, 128),
    "dense_1x": ([], 1.0, 128),
    "dense_4x": ([], 4.0, 128),
    "dense_32x": ([], 32.0, 128),
    "tn64": ([(CHUNK_WIDE, "const int wide = 0;")], None, 128),
    "tn128": ([(CHUNK_WIDE, "const int wide = 1;")], None, 128),
    "warps4_tm64": ([], None, 64),
    "two_stages": ([const("MAX_STAGES", 4, 2)], None, 128),
    "index_order": ([("const int rt = ix.order[blockIdx.x / ncol];",
                      "const int rt = blockIdx.x / ncol;")], None,
                    128),
    "unroll4": ([const("UNROLL", 8, 4)], None, 128),
    "unroll16": ([const("UNROLL", 8, 16)], None, 128),
    "smem_always": ([("n_dense > 0 ? C::SMEM : 0", "C::SMEM")],
                    None, 128),
    "shuffle_each_load": ([(CHUNK_LOADS, CHUNK_LOADS_INTERLEAVED)],
                          None, 128),
}
# (operand, B width or None for the on-disk width, B dtypes); "pruned_a"
# is chip_smoke.py's pruned weight (a) as CSR, B drawn as there
CHUNK_CASES = (("large_25605", 256, ("f32", "bf16")),
               ("pruned_a", 512, ("f32", "bf16")),
               ("medium_4096", None, ("f32",)),
               ("medium_2048", None, ("f32",)))
# name: [(text of bsr_spmm.cu, its replacement), ...]
BSR_VARIANTS = {
    "serving": [],
    "tn128": [const("WARPGROUPS", 1, 2)],
    "two_stages": [const("MAX_STAGES", 3, 2)],
    "small_tiles_3_stages": [const("SMALL_STAGES", 2, 3)],
    "small_tiles_4_stages": [const("SMALL_STAGES", 2, 4)],
    "index_order": [("const int br = row_order[unit / subs];",
                     "const int br = unit / subs;")],
    "b_plain_loads": [("cudaStream_t s) {\n#define K6_ARGS",
                       "cudaStream_t s) {\n  b_vec = 0;\n#define K6_ARGS")],
    "products3": [const("F32_PRODUCTS", 6, 3)],
    # control: each step copies 1 KB of its A planes, not 3-48 KB
    "a_planes_1k": [("mbar_expect_tx(&bar[st], G::A_BYTES);",
                     "mbar_expect_tx(&bar[st], 1024);"),
                    ("G::A_BYTES, &bar[st]);", "1024, &bar[st]);")],
}
BSR_CONTROLS = ("products3", "a_planes_1k")
# (weight, rows, cols, block, block density, seed, B width): chip_smoke.py's
# pruned weights (a) and (b), B drawn as there
BSR_CASES = (("a", 4096, 4096, (128, 128), 0.1, 0, 512),
             ("b", 4096, 4096, (8, 128), 0.02, 1, 512))
# (corpus dir, B width or None for the on-disk width, B dtypes)
CASES = (("large_25605", 256, ("f32", "bf16")),
         ("large_21074", 256, ("f32", "bf16")),
         ("medium_4096", None, ("f32",)))
PLAIN_TOL = 1e-4
K6_TOL = 2e-6


def build(name: str, patches: list, nvcc: str, flags, source: str,
          out: str = OUT) -> dict:
    """Build the source with ``patches`` applied into ``out`` (OUT for the
    strip variants, its ``chunk`` folder for the chunk variants, whose
    names overlap); the record holds the library's path, its group rows
    and ptxas's report."""
    with open(source) as f:
        text = f.read()
    for old, new in patches:
        if text.count(old) != 1:
            return {"name": name, "error": f"{old!r} is not in the source "
                                           "exactly once"}
        text = text.replace(old, new)
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    path = os.path.join(out, f"lib{name}.so")
    res = subprocess.run([nvcc, *flags, "-I", os.path.dirname(source), "-o",
                          path, src], capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        return {"name": name, "error": log[-2000:]}
    rows = re.search(r"constexpr int GROUP_ROWS = (\d+);", text)
    return {"name": name, "path": path, "patches": patches,
            "group_rows": int(rows.group(1)) if rows else None,
            "registers": [int(r) for r in re.findall(r"Used (\d+) registers",
                                                     log)],
            "spill_store_bytes": [int(s) for s in re.findall(
                r"(\d+) bytes spill stores", log)]}


def profile_host() -> int:
    """cProfile of the host work of ``tpuspmm_torch.spmm`` and of the
    panel and tile (K3) entry points on a prebuilt plan, large_25605 w256
    with bf16 B (the device time is below the host time there), and of
    ``spmm`` on BSR_CASES' weight (a) with bf16 B (K6)."""
    import cProfile
    import pstats

    import tpuspmm_torch
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import BSR, convert, tiles
    from tpuspmm_torch.kernels import panel_spmm, tile_spmm

    a = convert.load_sparse(data_dir("large_25605"), "csr")
    dense = convert.load_dense(data_dir("large_25605"), width=256)
    b = torch.from_numpy(dense.data).cuda().to(torch.bfloat16)
    geom = panel_spmm.resolve_panel_geometry(
        a, 256, plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP, device=b.device)
    plan = panel_spmm.panel_plan_from_geometry(a, geom)
    tplan = tiles.plan_from_container(a)
    _, rows, cols, block, density, seed, width = BSR_CASES[0]
    w = BSR.random_blocks(rows, cols, block, density, seed)
    wb = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (cols, width)) * 0.05).astype(np.float32)).cuda().to(torch.bfloat16)
    for name, call in (("spmm", lambda: tpuspmm_torch.spmm(a, b)),
                       ("spmm_panel", lambda: panel_spmm.spmm_panel(plan,
                                                                    b)),
                       ("spmm_tiles", lambda: tile_spmm.spmm_tiles(tplan,
                                                                   b)),
                       ("spmm_bsr", lambda: tpuspmm_torch.spmm(w, wb))):
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(200):
            call()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
        print(f"== {name}: 200 calls", flush=True)
        print(out.getvalue(), flush=True)
    return 0


def chunk_operand(case: str, width):
    """(CSR container, f32 B as numpy) of a CHUNK_CASES operand."""
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import BSR, CSR, convert

    if case == "pruned_a":
        w = BSR.random_blocks(4096, 4096, (128, 128), 0.1, 0)
        b = np.random.default_rng(0).standard_normal((4096, width)) * 0.05
        return CSR.from_scipy(w.to_scipy().tocsr()), b.astype(np.float32)
    return (convert.load_sparse(data_dir(case), "csr"),
            convert.load_dense(data_dir(case), width=width).data)


def chunk_sweep(names: list) -> int:
    """Build and time CHUNK_VARIANTS on CHUNK_CASES (see the module
    docstring); prints one JSON line per variant build and one per (case,
    B dtype)."""
    from tpuspmm_torch.formats import tiles
    from tpuspmm_torch.kernels import chunk_cuda, cuda_build, tile_spmm
    from tpuspmm_torch.utils.compare import max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(
            lambda name: build(name, CHUNK_VARIANTS[name][0],
                               cuda_build.nvcc(), cuda_build.NVCC_FLAGS,
                               chunk_cuda.SOURCE,
                               os.path.join(OUT, "chunk")), names))
    libs = {}
    for rec in built:
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("path", "group_rows")}), flush=True)
        if "path" in rec:
            libs[rec["name"]] = ctypes.CDLL(rec["path"])
            chunk_cuda._bind(libs[rec["name"]])
    dev = torch.device("cuda")
    for case, width, dtypes in CHUNK_CASES:
        a, b_np = chunk_operand(case, width)
        b32 = torch.from_numpy(b_np).to(dev)

        def plan_of(name):
            return tiles.plan_from_container(
                a, tile_m=CHUNK_VARIANTS[name][2])

        def index(name):
            _, per_k, _ = CHUNK_VARIANTS[name]
            per_k = tile_spmm.DENSE_PER_TILE_K if per_k is None else per_k
            plan = plan_of(name)
            # per_k·tile_k nonzeros, where the routine takes dense tiles
            takes = math.isfinite(tile_spmm.dense_min(plan.tile_k, False))
            return plan, tile_spmm.index_arrays(
                plan, dev, per_k * plan.tile_k if takes else math.inf)

        for tag in dtypes:
            b = b32 if tag == "f32" else b32.to(torch.bfloat16)
            b_slice = b[:, :128].contiguous()

            def run(name, operand):
                # K3's wrapper, launching this variant's library
                plan, idx = index(name)
                chunk_cuda.load = lambda: libs[name]
                return chunk_cuda.launch("tile_chunk_spmm", idx, operand,
                                         plan.shape[0], plan.tile_m,
                                         plan.tile_k, False)

            serving = tile_spmm.host_index(
                plan_of("serving"), tile_spmm.dense_min(128, False))
            rec = {"case": case, "b": tag, "width": int(b.shape[1]),
                   "nnz": int(a.nnz), "tiles": len(serving["tile_nnz"]),
                   "dense_tiles": int(serving["tile_dense"].sum()),
                   "err": {}, "ms": {}, "call_ms": {}}
            plains = {}
            for name in libs:
                tm = CHUNK_VARIANTS[name][2]
                if tm not in plains:
                    plains[tm] = tile_spmm.tile_spmm_plain(plan_of(name),
                                                           b_slice, "split")
                got = run(name, b_slice)
                torch.cuda.synchronize()
                rec["err"][name] = (max_abs_err(got, plains[tm])
                                    / float(plains[tm].abs().max()))
            graphs = {}
            for name in libs:
                run(name, b)  # the index on the device before capture
                graphs[name] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[name]):
                    run(name, b)
            torch.cuda.synchronize()
            times = {name: [] for name in libs}
            calls = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(cuda_time_ms(graphs[name].replay))
                calls[name].append(cuda_time_ms(lambda: run(name, b)))
            rec["ms"] = {k: min(v) for k, v in times.items()}
            rec["call_ms"] = {k: min(v) for k, v in calls.items()}
            rec["ok"] = all(e <= PLAIN_TOL for e in rec["err"].values())
            print(json.dumps(rec), flush=True)
            del graphs, plains
    return 0


def bsr_sweep(names: list) -> int:
    """Build and time BSR_VARIANTS on BSR_CASES
    (see the module docstring); prints one JSON line per build and one per
    (case, B dtype)."""
    from tpuspmm_torch.formats import BSR
    from tpuspmm_torch.kernels import bsr_cuda, bsr_spmm, cuda_build
    from tpuspmm_torch.utils.compare import max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    out_dir = os.path.join(OUT, "bsr")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(
            lambda name: build(name, BSR_VARIANTS[name], cuda_build.nvcc(),
                               cuda_build.NVCC_FLAGS, bsr_cuda.SOURCE,
                               out_dir), names))
    libs = {}
    for rec in built:
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("path", "group_rows")}), flush=True)
        if "path" in rec:
            libs[rec["name"]] = ctypes.CDLL(rec["path"])
            bsr_cuda._bind(libs[rec["name"]])
    dev = torch.device("cuda")
    for wname, rows, cols, block, density, seed, width in BSR_CASES:
        w = BSR.random_blocks(rows, cols, block, density, seed)
        b32 = torch.from_numpy((np.random.default_rng(seed).standard_normal(
            (cols, width)) * 0.05).astype(np.float32)).to(dev)
        counts = np.diff(w.indptr)
        for tag in ("f32", "bf16"):
            b = b32 if tag == "f32" else b32.to(torch.bfloat16)

            def run(name):
                bsr_cuda.load = lambda: libs[name]
                return bsr_spmm.spmm_bsr_stream(w, b)

            want = bsr_spmm.bsr_spmm_plain(w, b)
            scale = float(want.abs().max())
            rec = {"case": wname, "b": tag, "width": width,
                   "block": list(block), "nblocks": w.nblocks,
                   "most_blocks_in_a_row": int(counts.max()),
                   "empty_block_rows": int((counts == 0).sum()),
                   "max_abs_c": scale, "err": {}, "ms": {}, "call_ms": {}}
            for name in libs:
                got = run(name)
                torch.cuda.synchronize()
                rec["err"][name] = max_abs_err(got, want) / scale
            graphs = {}
            for name in libs:
                graphs[name] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[name]):
                    run(name)
            torch.cuda.synchronize()
            times = {name: [] for name in libs}
            calls = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(cuda_time_ms(graphs[name].replay))
                calls[name].append(cuda_time_ms(lambda: run(name)))
            rec["ms"] = {k: min(v) for k, v in times.items()}
            rec["call_ms"] = {k: min(v) for k, v in calls.items()}
            rec["ok"] = (all(e <= K6_TOL for n, e in rec["err"].items()
                             if n not in BSR_CONTROLS)
                         and (tag == "bf16"
                              or rec["err"].get("products3", 1.0) > K6_TOL))
            print(json.dumps(rec), flush=True)
            del graphs, want
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("strip_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import cuda_build, panel_spmm, strip_cuda
    from tpuspmm_torch.utils.compare import max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None,
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--chunk", action="store_true",
                    help="sweep the tile-owner routine's CHUNK_VARIANTS")
    ap.add_argument("--bsr", action="store_true",
                    help="sweep the block-streaming kernel's BSR_VARIANTS")
    ap.add_argument("--profile-host", action="store_true",
                    help="only profile the host side of 200 serves of "
                         "large_25605 w256 with bf16 B (cProfile)")
    args = ap.parse_args()
    if args.profile_host:
        return profile_host()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    variants = (BSR_VARIANTS if args.bsr else CHUNK_VARIANTS if args.chunk
                else VARIANTS)
    names = (args.variants.split(",") if args.variants else list(variants))
    if args.bsr:
        return bsr_sweep(names)
    if args.chunk:
        return chunk_sweep(names)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(
            lambda name: build(name, VARIANTS[name], cuda_build.nvcc(),
                               cuda_build.NVCC_FLAGS, strip_cuda.SOURCE),
            names))
    libs = {}
    for rec in built:
        print(json.dumps({k: v for k, v in rec.items() if k != "path"}),
              flush=True)
        if "path" in rec:
            lib = ctypes.CDLL(rec["path"])
            strip_cuda._bind(lib)
            libs[rec["name"]] = (lib, rec["group_rows"])

    dev = torch.device("cuda")
    for case, width, dtypes in CASES:
        a = convert.load_sparse(data_dir(case), "csr")
        dense = convert.load_dense(data_dir(case), width=width)
        n = dense.data.shape[1]
        geom = panel_spmm.resolve_panel_geometry(
            a, -(-n // 128) * 128, plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP,
            device=dev)
        plan = panel_spmm.panel_plan_from_geometry(a, geom)
        arrs = {}
        for gr in {g for _, g in libs.values()}:
            arrs[gr] = dict(plan.device_arrays(dev))
            index = panel_spmm.group_arrays(plan, gr // plan.tm)
            arrs[gr].update({k: v.to(dev) for k, v in index.items()})
        b32 = torch.from_numpy(dense.data).to(dev)
        for tag in dtypes:
            b = b32 if tag == "f32" else b32.to(torch.bfloat16)
            want = panel_spmm.panel_spmm_plain(plan, b)
            scale = float(want.abs().max())

            def run(name):
                # the wrapper, launching this variant's library on an
                # index over its group rows
                lib, gr = libs[name]
                strip_cuda.load = lambda: lib
                strip_cuda.GROUP_ROWS = gr
                out = strip_cuda.strip_spmm(
                    "panel_strip_spmm", arrs[gr], b, plan.n_out_strips,
                    plan.tm, plan.tk)
                return panel_spmm.finish_panel_output(out, plan, arrs[gr], n)

            rec = {"case": case, "b": tag, "width": n,
                   "tm": plan.tm, "tk": plan.tk,
                   "plan_bf16": plan.a_dense.dtype == np.uint16,
                   "max_abs_c": scale, "ms": {}, "err": {}}
            for name in libs:
                got = run(name)
                torch.cuda.synchronize()
                rec["err"][name] = max_abs_err(got, want)
            # device time: each variant's launch captured in a CUDA graph
            # and replayed, so the wrapper's host work does not show
            graphs = {}
            for name in libs:
                graphs[name] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[name]):
                    run(name)
            torch.cuda.synchronize()
            order = list(libs) + list(libs)[::-1]
            times = {name: [] for name in libs}
            calls = {name: [] for name in libs}
            for name in order:
                times[name].append(cuda_time_ms(graphs[name].replay))
                calls[name].append(cuda_time_ms(lambda: run(name)))
            rec["ms"] = {k: min(v) for k, v in times.items()}
            rec["call_ms"] = {k: min(v) for k, v in calls.items()}
            del graphs
            rec["ok"] = all(e <= PLAIN_TOL * scale
                            for e in rec["err"].values())
            print(json.dumps(rec), flush=True)
            del want
        del b32
    return 0


if __name__ == "__main__":
    sys.exit(main())
