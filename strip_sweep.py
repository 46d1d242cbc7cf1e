#!/usr/bin/env python3
"""Time variants of the strip-owner kernel (csrc/strip_spmm.cu) and of the
tile-owner routine (csrc/chunk_spmm.cu) on one NVIDIA GPU.

Run from the repository root:

    python3 strip_sweep.py [--variants NAME,NAME,...]
    python3 strip_sweep.py --chunk [--variants NAME,NAME,...]
    python3 strip_sweep.py --bsr [--variants NAME,...] [--cases WEIGHT,...]
        [--rounds N]
    python3 strip_sweep.py --profile-host

Each variant is a copy of the source with some of its lines replaced
(VARIANTS; "serving" is the source as it stands; "running_sums", in both
sweeps, adds every term product straight into the running sums, as the
routines did before their k-steps got a fresh accumulator), written to
and built in build/strip_sweep/, one nvcc each, all started together.
Every record also gives each variant's ``gate_ratio`` against the f64
oracle (at most 1 where the gate passes).  The serving
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
against cp.async, and controls, which are not held to the tolerance:
three f32-B products instead of six, 1 KB of a step's A planes copied
instead of all, the ring's copies alone, and the step's products alone on
stages filled once; the last two patch the loop that f32 B and unaligned
bf16 B run), and BSR_OVERRIDES set the launch rules' constants of
``kernels/bsr_cuda.py`` for the variant's bindings, on the serving
library (the warp-specialised build's consumers, two whenever B is wider
than a column tile or one always; its grid persistent from 1, 2, 3 or 4
waves of 128-row tiles or never), on BSR_CASES: chip_smoke.py's pruned
weights, and an Olmo-Hybrid-7B gate and down weight as the benchmark
draws them, at w512 and w16 (``--cases olmo_gate,olmo_down`` for those
alone), and a DeepSeek-V3 expert's gate [2048, 7168] and down [7168, 2048] weight at
w4096 (the gate also at w4093, a routed width that takes the register
build) and its dense layers' gate [18432, 7168] and down [7168, 18432] at
w4096 (``--cases dsv3_gate,dsv3_down,dsv3_dense_gate,dsv3_dense_down``).  Each
variant runs through ``spmm_bsr_stream`` with the variant's library (an
override variant through its own bindings on the same arrays), is
held against the plain version (K6_TOL, 2e-6·max|C|, chip_smoke.py's
limit for K6, which the three-product control must miss with f32 B) and
timed as above.

``--chunk`` sweeps the tile-owner routine (K3, K4, K5a, K5b) instead:
CHUNK_VARIANTS patch its source (ring depth, launch order, gathered rows
in flight) or change what the host hands it (the dense path's threshold,
with every tile gathered and every tile dense as controls; a 64-row tile,
which runs 4 warps a block; for the gather build, which an index with no
dense tile takes, its loads in flight, the warps an SM's registers are
budgeted for, and its round's order), and CHUNK_OVERRIDES set
``chunk_cuda``'s column tiles (64 or 128 always) or the gather build's
rows a warp, warps a block and f32 passes for the variant's bindings, on
CHUNK_CASES; ROUTINE_CONTROLS launch the owner routine or its cluster
launch whatever the index holds, as the parent commit did.
Each variant runs K3's entry on the tile plan, is held against the plain
version on a 128-column slice of B (1e-4·max|C|), must give the serving
bits where it shares its sum order, and is timed in CUDA graphs: ``ms``
one launch on one B (warm), ``cold_ms`` a launch on each of B's copies
twice the L2 in turn (``rotation``), ``call_ms`` the wrapper; with
``--rounds`` the capture order turns by one each round and each time is
the median of the rounds' least.  Each record holds each variant's
``Launch.shape``; each build record ptxas's registers and spills by
kernel.  CLUSTER_VARIANTS run
the C-resident kernels' cluster launch (K5a's) at 2, 4 and 8 row tiles a
cluster against "serving", the owner routine (R = 1), with controls
(the launch at R = 1; at R = 2 with the fetch after the products, with
the remote arrivals released at cluster scope, or with one thread
waiting for a stage; at R = 1 and 2 with B staged by each member's
cp.async, no bulk copy, whose multicast count is not held): each must
give
K3's bits (``same_bits``) and its multicast count (``issues``, the
device counter) must equal the schedule's (``want_issues``); its build
record has the clusters the card holds at once (``max_active_clusters``).
"""

from __future__ import annotations

import argparse
import contextlib
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
# the products of a k-step with more than one term pair: into a fresh
# accumulator, added into the sums in f32 (serving), or each straight
# into the running sums, as the routines once did (the "running_sums"
# control, which misses the gate where C cancels: the tensor cores' sums
# are not rounded to nearest)
STRIP_FRESH = """      // A's terms one m16 tile at a time (an f32 A's three terms of all
      // WMT tiles at once would leave no registers to overlap products)
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        if (!((mask >> mt) & 1)) continue;  // no strip in these 16 rows
        uint32_t af[A_BF16 ? 1 : 3][4];  // [term][register]
        if constexpr (A_BF16) {
          tc::ldmatrix_x4(af[0], sa + (mt * 16 + lane % 16) * T::A_LD + ks +
                                     (lane / 16) * 8);
        } else {
          const float* r0 = reinterpret_cast<const float*>(sa) +
                            (mt * 16 + gid) * T::A_LD + ks + 2 * t4;
          const float2 x0 = *reinterpret_cast<const float2*>(r0);
          const float2 x1 =
              *reinterpret_cast<const float2*>(r0 + 8 * T::A_LD);
          const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 x3 =
              *reinterpret_cast<const float2*>(r0 + 8 * T::A_LD + 8);
          float v[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
#pragma unroll
          for (int ia = 0; ia < 3; ++ia)
            if (ia < na)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                af[ia][q] = tc::bf16x2_term(v[2 * q], v[2 * q + 1]);
        }
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) {
          if (nprod == 1) {  // one product a pair: straight into the sums
            tc::mma_bf16(acc[mt][nt], af[0], bf[0][nt][0], bf[0][nt][1]);
            continue;
          }
          // several term products: this k-step's into a fresh accumulator,
          // smallest (i + j largest) first and hi·hi last, then one
          // rounded f32 add into the sums.  The tensor cores' sums are not
          // rounded to nearest: each product added into the running sums
          // would cost a biased error of the sums' own size, ~6·K/16 of
          // them a value, which misses the gate where C cancels (entry()'s
          // operand); this way a k-step costs one, of its own partial's size
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 4; d >= 0; --d)
#pragma unroll
            for (int ia = 0; ia < (A_BF16 ? 1 : 3); ++ia) {
              const int ib = d - ia;
              if (ib >= 0 && ib < (B_BF16 ? 1 : 3) && ia < na && ib < nb &&
                  d < nprod)
                tc::mma_bf16(part, af[ia], bf[ib][nt][0], bf[ib][nt][1]);
            }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
        }
      }
"""
STRIP_RUNNING = """      uint32_t af[A_BF16 ? 1 : 3][WMT][4];  // [term][m16 tile][register]
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        if (!((mask >> mt) & 1)) continue;  // no strip in these 16 rows
        if constexpr (A_BF16) {
          tc::ldmatrix_x4(af[0][mt], sa + (mt * 16 + lane % 16) * T::A_LD +
                                         ks + (lane / 16) * 8);
        } else {
          const float* r0 = reinterpret_cast<const float*>(sa) +
                            (mt * 16 + gid) * T::A_LD + ks + 2 * t4;
          const float2 x0 = *reinterpret_cast<const float2*>(r0);
          const float2 x1 =
              *reinterpret_cast<const float2*>(r0 + 8 * T::A_LD);
          const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 x3 =
              *reinterpret_cast<const float2*>(r0 + 8 * T::A_LD + 8);
          float v[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
#pragma unroll
          for (int ia = 0; ia < 3; ++ia)
            if (ia < na)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                af[ia][mt][q] = tc::bf16x2_term(v[2 * q], v[2 * q + 1]);
        }
      }
      // term pairs outermost: consecutive products go to different
      // accumulators, so no product waits on the one before it
#pragma unroll
      for (int ia = 0; ia < (A_BF16 ? 1 : 3); ++ia)
#pragma unroll
        for (int ib = 0; ib < (B_BF16 ? 1 : 3); ++ib)
          if (ia < na && ib < nb && ia + ib < nprod)
#pragma unroll
            for (int mt = 0; mt < WMT; ++mt)
              if ((mask >> mt) & 1)
#pragma unroll
                for (int nt = 0; nt < WNT; ++nt)
                  tc::mma_bf16(acc[mt][nt], af[ia][mt], bf[ib][nt][0],
                               bf[ib][nt][1]);
"""
VARIANTS = {
    "serving": [],
    "running_sums": [(STRIP_FRESH, STRIP_RUNNING)],
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
# the dense tiles' products, as STRIP_FRESH / STRIP_RUNNING
CHUNK_FRESH_BF16 = """#pragma unroll
            for (int nt = 0; nt < TN / 8; ++nt) {
              uint32_t r[2];
              tc::ldmatrix_x2_trans(r, sb + (ks + lane % 16) * G::B_LD +
                                           nt * 8);
              float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int ia = 2; ia >= 0; --ia)  // smallest term first
                tc::mma_bf16(part, af[ia], r[0], r[1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] += part[q];
            }
"""
CHUNK_RUNNING_BF16 = """#pragma unroll
            for (int p = 0; p < TN / 16; ++p) {
              uint32_t r[4];
              tc::ldmatrix_x4_trans(r, sb + (ks + lane % 16) * G::B_LD +
                                           p * 16 + (lane / 16) * 8);
#pragma unroll
              for (int ia = 0; ia < 3; ++ia) {
                tc::mma_bf16(acc[2 * p], af[ia], r[0], r[1]);
                tc::mma_bf16(acc[2 * p + 1], af[ia], r[2], r[3]);
              }
            }
"""
CHUNK_FRESH_F32 = """              uint32_t bt[3][2];  // B's terms, in order
#pragma unroll
              for (int ib = 0; ib < 3; ++ib) {
                bt[ib][0] = tc::bf16x2_term(v[0], v[1]);
                bt[ib][1] = tc::bf16x2_term(v[2], v[3]);
              }
              // products (i, j) with i + j < 3, smallest first
              float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int d = 2; d >= 0; --d)
#pragma unroll
                for (int ia = 0; ia <= d; ++ia)
                  tc::mma_bf16(part, af[ia], bt[d - ia][0], bt[d - ia][1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] += part[q];
"""
CHUNK_RUNNING_F32 = """              // B's terms in order, each used as it is made: products
              // (i, j) with i + j < 3
#pragma unroll
              for (int ib = 0; ib < 3; ++ib) {
                const uint32_t b0 = tc::bf16x2_term(v[0], v[1]);
                const uint32_t b1 = tc::bf16x2_term(v[2], v[3]);
#pragma unroll
                for (int ia = 0; ia < 3 - ib; ++ia)
                  tc::mma_bf16(acc[nt], af[ia], b0, b1);
              }
"""
# the gather build's round: its values shuffled before its loads and held
# in registers while they fly (the "gather_early_values" control)
GATHER_EARLY_VALUES = [
    ("      Raw<TB, VEC> raw[NZ][PASSES];\n",
     "      float vv[NZ];\n      Raw<TB, VEC> raw[NZ][PASSES];\n"),
    ("        const int kr = __shfl_sync(FULL, my_col, (j + u) & 31);\n",
     "        const int kr = __shfl_sync(FULL, my_col, (j + u) & 31);\n"
     "        vv[u] = __shfl_sync(FULL, my_val, (j + u) & 31);\n"),
    ("        const float v = __shfl_sync(FULL, my_val, (j + u) & 31);\n",
     "        const float v = vv[u];\n")]
CHUNK_VARIANTS = {
    "serving": ([], None, 128),
    "running_sums": ([(CHUNK_FRESH_BF16, CHUNK_RUNNING_BF16),
                      (CHUNK_FRESH_F32, CHUNK_RUNNING_F32)], None, 128),
    "gather_only": ([], math.inf, 128),
    "dense_only": ([], 0.0, 128),
    "dense_1x": ([], 1.0, 128),
    "dense_4x": ([], 4.0, 128),
    "dense_32x": ([], 32.0, 128),
    "warps4_tm64": ([], None, 64),
    "two_stages": ([const("MAX_STAGES", 4, 2)], None, 128),
    "index_order": ([("rt = ix.order[blockIdx.x / ncol];",
                      "rt = blockIdx.x / ncol;")], None, 128),
    "unroll4": ([const("UNROLL", 8, 4)], None, 128),
    "unroll16": ([const("UNROLL", 8, 16)], None, 128),
    "smem_always": ([("n_dense > 0 ? C::SMEM : 0", "C::SMEM")],
                    None, 128),
    "shuffle_each_load": ([(CHUNK_LOADS, CHUNK_LOADS_INTERLEAVED)],
                          None, 128),
    # the gather build: 16-byte loads a lane issues before their FMAs,
    # and the warps an SM's registers are budgeted for
    "gather_loads2": ([const("GATHER_LOADS", 4, 2)], None, 128),
    "gather_loads6": ([const("GATHER_LOADS", 4, 6)], None, 128),
    "gather_loads8": ([const("GATHER_LOADS", 4, 8)], None, 128),
    "gather_sm16": ([const("GATHER_SM_WARPS", 32, 16)], None, 128),
    "gather_sm24": ([const("GATHER_SM_WARPS", 32, 24)], None, 128),
    "gather_sm48": ([const("GATHER_SM_WARPS", 32, 48)], None, 128),
    "gather_loads8_sm16": ([const("GATHER_LOADS", 4, 8),
                            const("GATHER_SM_WARPS", 32, 16)], None, 128),
    # half the loads a round where B's rows are not 16-byte aligned
    "gather_unaligned_loads2": ([(
        "constexpr int NZ = GATHER_LOADS / PASSES;",
        "constexpr int NZ = (ALIGNED ? GATHER_LOADS : GATHER_LOADS / 2)"
        " / PASSES;")], None, 128),
    # the round's values shuffled with its columns, before the loads
    "gather_early_values": (GATHER_EARLY_VALUES, None, 128),
}
# name: {constant of chunk_cuda: its value for the variant's bindings},
# on the serving library: the column tile 64 or 128 always; the gather
# build's rows a warp (where one a warp would not fill one wave; 2 always),
# warps a block, and one pass over f32 B
CHUNK_OVERRIDES = {"tn64": {"COLUMN_TILES": (64, 64)},
                   "tn128": {"COLUMN_TILES": (128, 128)},
                   "gather_rows1": {"GATHER_ROWS": 1},
                   "gather_rows2": {"GATHER_ROWS": 2, "GATHER_SM_WARPS": 0},
                   "gather_rows4": {"GATHER_ROWS": 4},
                   "gather_warps4": {"GATHER_WARPS": 4},
                   "gather_rows1_warps4": {"GATHER_ROWS": 1,
                                           "GATHER_WARPS": 4},
                   "gather_one_pass": {"GATHER_F32_PASSES": 1}}
# controls on the serving library: an index's launch by the owner routine
# (False) or its cluster launch (True) whatever the index holds, as the
# parent commit launched an index with no dense tile
ROUTINE_CONTROLS = {"owner_routine": False, "cluster_routine": True}
# the C-resident cluster launch (cres_cluster_spmm) at R row tiles a
# cluster, each a copy of the source built with CLUSTER = R (and the
# patches listed), run through K5a's launcher; "serving" (K3, the owner
# routine) is R = 1.  Controls: the cluster launch at R = 1 (its protocol
# without a peer), and at R = 2 with each ring step's products before the
# next stage's fetch (the leader's first warp then waits for its peers'
# frees and issues the multicast after its products, not before)
RING_STEP = """        const int next = it + G::STAGES - 1;
        if (next < items) fetch(next, next % G::STAGES);
        tc::cp_async_commit();
        if (!CLUSTERED || tile_of(it / chunks) >= 0)
          compute(it % G::STAGES);"""
RING_STEP_FETCH_AFTER = """        if (!CLUSTERED || tile_of(it / chunks) >= 0)
          compute(it % G::STAGES);
        const int next = it + G::STAGES - 1;
        if (next < items) fetch(next, next % G::STAGES);
        tc::cp_async_commit();"""
# control: no bulk copy, each member stages its B chunks with cp.async
# under the same barriers
NO_BULK = ("const bool bulk = b_async && n0 + TN <= n && krow0 + KC <= k;",
           "const bool bulk = false;")
CLUSTER_VARIANTS = {"cluster2": (2, []), "cluster4": (4, []),
                    "cluster8": (8, []), "cluster1": (1, []),
                    "cluster2_fetch_after_compute": (
                        2, [(RING_STEP, RING_STEP_FETCH_AFTER)]),
                    "cluster1_no_bulk": (1, [NO_BULK]),
                    "cluster2_no_bulk": (2, [NO_BULK])}
# the two remote arrivals released at cluster scope
# (mbarrier.arrive.release.cluster) instead of mbarrier.arrive's default,
# release at CTA scope (tensor_core.cuh: mbar_arrive_cluster)
RELEASE_CLUSTER = [
    ("namespace {\n", "namespace {\n" + '''
__device__ __forceinline__ void arrive_remote(uint64_t* bar, uint32_t r) {
  asm volatile(
      "{\\n.reg .b32 remote;\\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];"
      "\\n}\\n" ::"r"(tc::smem_addr(bar)), "r"(r) : "memory");
}
'''),
    ("tc::mbar_arrive_cluster(&full[s], lane);",
     "arrive_remote(&full[s], lane);"),
    ("tc::mbar_arrive_cluster(&empty[(it - 1) % G::STAGES], 0);",
     "arrive_remote(&empty[(it - 1) % G::STAGES], 0);")]
# one thread waits for a stage to land, the block barrier passes it on
ONE_WAITER = ("          tc::mbar_wait(&full[it % G::STAGES], it / G::STAGES & 1);",
              "          if (tid == 0)\n"
              "            tc::mbar_wait(&full[it % G::STAGES], "
              "it / G::STAGES & 1);")
CLUSTER_VARIANTS.update({
    "cluster2_release_cluster": (2, RELEASE_CLUSTER),
    "cluster2_one_waiter": (2, [ONE_WAITER])})
# controls whose multicast count is not the schedule's (no multicast)
CLUSTER_CONTROLS = ("cluster1_no_bulk", "cluster2_no_bulk")
# (operand, B width or None for the on-disk width, B dtypes); "pruned_a"
# is chip_smoke.py's pruned weight (a) as CSR, B drawn as there
CHUNK_CASES = (("large_25605", 256, ("f32", "bf16")),
               ("pruned_a", 512, ("f32", "bf16")),
               ("pruned_a", 1024, ("f32", "bf16")),
               ("medium_4096", None, ("f32", "bf16")),
               ("medium_2048", None, ("f32", "bf16")),
               ("random_2048", 1024, ("f32", "bf16")),
               ("large_25605", 512, ("f32", "bf16")),
               ("large_25605", 16, ("f32", "bf16")),
               ("large_25605", 77, ("f32", "bf16")),
               ("large_25605", 130, ("f32", "bf16")),
               ("large_21074", 256, ("f32", "bf16")))
# the serving ring's refill of a stage, inside its step loop
RING_REFILL = ("    if (t + S - 1 < steps) issue(t + S - 1);\n"
              "    tc::cp_async_commit();\n")
# the warp-specialised build: its producer's refill, its consumer's wait
# for a stage and its products
WS_REFILL = "        if (t >= S) tc::mbar_wait(&empty[st], (t / S - 1) & 1);"
WS_FULL = "      tc::mbar_wait(&full[st], (t / S) & 1);"
WS_PRODUCTS = ("#pragma unroll\n      for (int kk = 0; kk < KC / 16; ++kk)\n"
               "#pragma unroll\n        for (int i = 0; i < TERMS; ++i)\n"
               "          wgmma_ss")
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
                       "cudaStream_t s) {\n  b_vec = 0;\n  consumers = 0;\n"
                       "#define K6_ARGS")],
    "products3": [const("F32_PRODUCTS", 6, 3)],
    # control: each step copies 1 KB of its A planes, not 3-48 KB
    "a_planes_1k": [("mbar_expect_tx(&bar[st], G::A_BYTES);",
                     "mbar_expect_tx(&bar[st], 1024);"),
                    ("G::A_BYTES, &bar[st]);", "1024, &bar[st]);")],
    # the persistent grid's blocks taking tiles c, c + grid, ... (no
    # reversal on odd rounds)
    "ws_round_robin": [(
        "base + ((r & 1) ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);",
        "base + (int)blockIdx.x;")],
    # controls of the warp-specialised build: its copies alone (no
    # products); its products alone on the stages filled once
    "ws_copy_only": [(WS_PRODUCTS, "      if (false)\n" + WS_PRODUCTS)],
    "ws_math_only": [(WS_REFILL, "        if (t >= S) continue;"),
                     (WS_FULL,
                      "      if (t < S) tc::mbar_wait(&full[st], 0);")],
    # control: the ring as it is, with no products and no adds (the floor
    # of its copies)
    "copy_only": [(RING_REFILL, RING_REFILL + "    continue;\n")],
    # control: the first S - 1 steps staged once, then every step's
    # fragments and products on a stage already there (the floor of the
    # step's chain without its copies)
    "math_only": [(RING_REFILL, "    tc::cp_async_commit();\n"),
                  ("    const int st = t % S;\n"
                   "    tc::cp_async_wait<S - 2>();\n"
                   "    tc::mbar_wait(&bar[st], (t / S) & 1);",
                   "    const int st = t % (S - 1);\n"
                   "    tc::cp_async_wait<0>();\n"
                   "    if (t < S - 1) tc::mbar_wait(&bar[st], 0);")],
}
# name: {constant of bsr_cuda: its value for the variant's bindings}, on
# the serving library.  The warp-specialised build's consumers: two
# whenever B is wider than one column tile, or one always; its grid at
# 128-row tiles: persistent (a block an SM walking tiles) wherever the
# tiles fill the SMs once, or 2 or 4 times (3 serves); or one block a tile
# always
BSR_OVERRIDES = {"ws_waves0": {"WS_WAVES": 0},
                 "ws_one_consumer": {"CONSUMER_WARPGROUPS": 1},
                 "ws_persistent": {"PERSIST_WAVES": 1},
                 "persist_waves2": {"PERSIST_WAVES": 2},
                 "persist_waves4": {"PERSIST_WAVES": 4},
                 "ws_no_persist": {"PERSIST_WAVES": 1 << 20}}
BSR_CONTROLS = ("products3", "a_planes_1k", "copy_only", "math_only",
                "ws_copy_only", "ws_math_only")
# (weight, rows, cols, block, block density, seed, B width): chip_smoke.py's
# pruned weights (a) and (b), B drawn as there; and an Olmo-Hybrid-7B gate
# and down weight and a DeepSeek-V3 expert's gate and down weight at a
# 4096-token chunk, as spmm_bench's pruned_ffn generator draws them
# (DRAWN), ROTATE distinct weights a case launched in turn, so that one
# call's planes are not in L2 from the call before, as in the benchmark
BSR_CASES = (("a", 4096, 4096, (128, 128), 0.1, 0, 512),
             ("b", 4096, 4096, (8, 128), 0.02, 1, 512),
             ("olmo_gate", 11008, 3840, (128, 128), 0.1, 0, 512),
             ("olmo_gate", 11008, 3840, (128, 128), 0.1, 0, 16),
             ("olmo_down", 3840, 11008, (128, 128), 0.1, 0, 512),
             ("olmo_down", 3840, 11008, (128, 128), 0.1, 0, 16),
             ("dsv3_gate", 2048, 7168, (128, 128), 0.1, 0, 4096),
             ("dsv3_gate", 2048, 7168, (128, 128), 0.1, 0, 4093),
             ("dsv3_down", 7168, 2048, (128, 128), 0.1, 0, 4096),
             ("dsv3_dense_gate", 18432, 7168, (128, 128), 0.1, 0, 4096),
             ("dsv3_dense_down", 7168, 18432, (128, 128), 0.1, 0, 4096))
DRAWN = ("olmo_gate", "olmo_down", "dsv3_gate", "dsv3_down",
         "dsv3_dense_gate", "dsv3_dense_down")
ROTATE = 4
# (corpus dir, B width or None for the on-disk width, B dtypes)
CASES = (("large_25605", 256, ("f32", "bf16")),
         ("large_21074", 256, ("f32", "bf16")),
         ("medium_4096", None, ("f32",)),
         ("entry", 256, ("f32",)))
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
                r"(\d+) bytes spill stores", log)],
            "kernels": re.findall(r"Compiling entry function '(\w+)'", log)}


@contextlib.contextmanager
def overridden(module, values: dict):
    """``module``'s constants set to ``values`` inside the block (a
    variant of BSR_OVERRIDES or CHUNK_OVERRIDES binding its launches)."""
    old = {name: getattr(module, name) for name in values}
    for name, value in values.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


def to_build(names: list, overrides: dict) -> list:
    """The variants of ``names`` whose library is built: each that patches
    the source, and "serving", whose library a variant that only
    overrides constants runs."""
    built = [name for name in names if name not in overrides]
    if len(built) < len(names) and "serving" not in built:
        built.insert(0, "serving")
    return built


def add_overrides(libs: dict, names: list, overrides: dict) -> None:
    """Give each override variant of ``names`` the serving library, with
    a record of its constants."""
    for name in names:
        if name in overrides and "serving" in libs:
            libs[name] = libs["serving"]
            print(json.dumps({"name": name, "overrides": overrides[name]}),
                  flush=True)


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


def operand(case: str, width):
    """(CSR container, f32 B as numpy) of a CASES or CHUNK_CASES operand:
    a corpus dir, chip_smoke.py's pruned weight (a) as CSR ("pruned_a"),
    ``tpuspmm_torch.entry``'s operand ("entry", ±100 values) or
    profile_variants' ``--random 2048x2048x0.1`` ("random_2048")."""
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import BSR, CSR, convert

    if case == "pruned_a":
        w = BSR.random_blocks(4096, 4096, (128, 128), 0.1, 0)
        b = np.random.default_rng(0).standard_normal((4096, width)) * 0.05
        return CSR.from_scipy(w.to_scipy().tocsr()), b.astype(np.float32)
    if case == "entry":
        b = np.random.default_rng(1).standard_normal((1024, width))
        return CSR.random(1024, 1024, 0.10, seed=0), b.astype(np.float32)
    if case == "random_2048":
        b = np.random.default_rng(1).uniform(-1, 1, (2048, width))
        return CSR.random(2048, 2048, 0.1, seed=0), b.astype(np.float32)
    return (convert.load_sparse(data_dir(case), "csr"),
            convert.load_dense(data_dir(case), width=width).data)


def gate_ratio(result, a, b) -> float:
    """max |C - oracle| / (1e-3 + 1e-2·|oracle|) against the f64 oracle of
    A and B as the kernel read it: at most 1 where the gate passes."""
    from tpuspmm_torch.ops import oracle

    ref = oracle.spmm_scipy_oracle(a, b.float().cpu().numpy())
    got = result.double().cpu().numpy()
    return float(np.max(np.abs(got - ref) / (1e-3 + 1e-2 * np.abs(ref)),
                        initial=0.0))


def rotation(b: torch.Tensor) -> list:
    """b and copies of it, at least twice the card's L2 in all (2 to 128
    tensors), launched in turn so that each launch reads B from HBM."""
    l2 = torch.cuda.get_device_properties(b.device).L2_cache_size
    count = min(128, max(2, math.ceil(2 * l2 / (b.numel()
                                                * b.element_size()))))
    return [b] + [b.clone() for _ in range(count - 1)]


def chunk_sweep(names: list, rounds: int = 1) -> int:
    """Build and time CHUNK_VARIANTS, CHUNK_OVERRIDES, ROUTINE_CONTROLS
    and CLUSTER_VARIANTS on CHUNK_CASES (see the module docstring); prints
    one JSON line per variant build and one per (case, B dtype)."""
    from tpuspmm_torch.formats import tiles
    from tpuspmm_torch.kernels import (chunk_cuda, cres_spmm, cuda_build,
                                       tile_spmm)
    from tpuspmm_torch.utils.compare import max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    variants = dict(CHUNK_VARIANTS)
    for name, (r, patches) in CLUSTER_VARIANTS.items():
        variants[name] = ([const("CLUSTER", chunk_cuda.CLUSTER, r),
                           *patches], None, 128)
    on_serving = {**CHUNK_OVERRIDES, **ROUTINE_CONTROLS}
    variants.update({name: ([], None, 128) for name in on_serving})
    builds = to_build(names, on_serving)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(
            lambda name: build(name, variants[name][0],
                               cuda_build.nvcc(), cuda_build.NVCC_FLAGS,
                               chunk_cuda.SOURCE,
                               os.path.join(OUT, "chunk")), builds))
    libs = {}
    for rec in built:
        if "path" in rec:
            libs[rec["name"]] = ctypes.CDLL(rec["path"])
            chunk_cuda._bind(libs[rec["name"]])
            chunk_cuda.load = lambda: libs[rec["name"]]
            if rec["name"] in CLUSTER_VARIANTS:
                rec["max_active_clusters"] = {
                    f"{'bf16' if bb else 'f32'}_B_tn{128 if wide else 64}":
                    chunk_cuda.max_active_clusters(bb, wide, False)
                    for bb in (False, True) for wide in (False, True)}
            rec["gather_blocks_per_sm"] = {
                f"{'bf16' if bb else 'f32'}_B_passes{p}_warps{w}":
                chunk_cuda.gather_blocks(bb, p, w)
                for bb in (False, True) for p in ((1,) if bb else (1, 2))
                for w in (4, 8)}
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("path", "group_rows")}), flush=True)
    add_overrides(libs, names, CHUNK_OVERRIDES)
    add_overrides(libs, names, ROUTINE_CONTROLS)
    dev = torch.device("cuda")
    for case, width, dtypes in CHUNK_CASES:
        a, b_np = operand(case, width)
        b32 = torch.from_numpy(b_np).to(dev)

        def plan_of(name):
            return tiles.plan_from_container(a, tile_m=variants[name][2])

        def min_dense(name):
            _, per_k, _ = variants[name]
            per_k = tile_spmm.DENSE_PER_TILE_K if per_k is None else per_k
            plan = plan_of(name)
            # per_k·tile_k nonzeros, where the routine takes dense tiles
            takes = math.isfinite(tile_spmm.dense_min(plan.tile_k, False))
            return plan, per_k * plan.tile_k if takes else math.inf

        bound = {}

        def launch_of(name, operand, issues=None):
            # K3's binding, or K5a's for a cluster variant, with this
            # variant's constants (a routine control: the owner routine's
            # or the cluster launch's, whatever the index holds), bound
            # once a B shape and dtype (with issues: each time)
            key = (name, operand.dtype, tuple(operand.shape))
            if issues is None and key in bound:
                return bound[key]
            plan, md = min_dense(name)
            idx = tile_spmm.index_arrays(plan, dev, md)
            args = (operand, plan.shape[0], plan.tile_m, plan.tile_k, False)
            sched = None
            if name in CLUSTER_VARIANTS or ROUTINE_CONTROLS.get(name):
                sched = cres_spmm.schedule_arrays(
                    plan, dev, md, CLUSTER_VARIANTS[name][0]
                    if name in CLUSTER_VARIANTS else None)
            entry = "tile_chunk_spmm" if sched is None else "cres_chunk_spmm"
            with overridden(chunk_cuda, CHUNK_OVERRIDES.get(name, {})):
                if name in ROUTINE_CONTROLS:
                    launch = chunk_cuda._routine_launch(entry, idx, *args,
                                                        sched)
                else:
                    launch = chunk_cuda.bind(entry, idx, *args, sched,
                                             issues)
            if issues is None:
                bound[key] = launch
            return launch

        def run(name, operand, issues=None):
            chunk_cuda.load = lambda: libs[name]
            return launch_of(name, operand, issues)(operand)

        serving = tile_spmm.host_index(
            plan_of("serving"), tile_spmm.dense_min(128, False))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for tag in dtypes:
            b = b32 if tag == "f32" else b32.to(torch.bfloat16)
            b_slice = b[:, :128].contiguous()
            rec = {"case": case, "b": tag, "width": int(b.shape[1]),
                   "nnz": int(a.nnz), "tiles": len(serving["tile_nnz"]),
                   "dense_tiles": int(serving["tile_dense"].sum()),
                   "shape": {}, "err": {}, "gate_ratio": {}, "ms": {},
                   "cold_ms": {}, "call_ms": {}, "same_bits": {},
                   "issues": {}, "want_issues": {}, "b_panel_bytes": {}}
            plains = {}
            for name in libs:
                tm = variants[name][2]
                if tm not in plains:
                    plains[tm] = tile_spmm.tile_spmm_plain(plan_of(name),
                                                           b_slice, "split")
                got = run(name, b_slice)
                torch.cuda.synchronize()
                rec["err"][name] = (max_abs_err(got, plains[tm])
                                    / float(plains[tm].abs().max()))
                rec["gate_ratio"][name] = gate_ratio(got, a, b_slice)
            if "serving" in libs:
                want = run("serving", b)
                for name in libs:
                    rec["shape"][name] = launch_of(name, b).shape
                    if name not in on_serving and not name.startswith(
                            "gather_"):
                        continue
                    # one index, one sum order: the gather build's
                    # variants and the serving library's give the serving
                    # bits
                    rec["same_bits"][name] = bool(torch.equal(run(name, b),
                                                              want))
                for name in CLUSTER_VARIANTS:
                    if name not in libs:
                        continue
                    issues = torch.zeros(1, dtype=torch.int32, device=dev)
                    got = run(name, b, issues)
                    torch.cuda.synchronize()
                    plan, md = min_dense(name)
                    traffic = cres_spmm.b_traffic(plan, b, md, sms,
                                                  CLUSTER_VARIANTS[name][0])
                    rec["same_bits"][name] = bool(torch.equal(got, want))
                    rec["issues"][name] = int(issues.item())
                    rec["want_issues"][name] = traffic["multicast_issues"]
                    rec["b_panel_bytes"][name] = traffic["b_panel_bytes"]
                del want
            # device times: each variant's launch on one B (warm: B in L2
            # after the first) and on B's rotation in turn (cold), both
            # captured in CUDA graphs; each round captures the variants in
            # an order rotated by one (the first captured reads fast) and
            # times them there and back; ms / cold_ms are the median over
            # the rounds of each round's least
            copies = rotation(b)
            order = list(libs)
            times = {name: ([], [], []) for name in order}
            for r in range(rounds):
                turn = order[r % len(order):] + order[:r % len(order)]
                warm, cold = {}, {}
                for name in turn:
                    run(name, b)  # the index on the device before capture
                    warm[name] = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(warm[name]):
                        run(name, b)
                    cold[name] = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(cold[name]):
                        for c in copies:
                            run(name, c)
                torch.cuda.synchronize()
                seen = {name: ([], [], []) for name in turn}
                for name in turn + turn[::-1]:
                    seen[name][0].append(cuda_time_ms(warm[name].replay))
                    seen[name][1].append(cuda_time_ms(cold[name].replay)
                                         / len(copies))
                    seen[name][2].append(cuda_time_ms(lambda: run(name, b)))
                for name in turn:
                    for got, mine in zip(times[name], seen[name]):
                        got.append(min(mine))
                del warm, cold
            for name, (ms, cold_ms, call_ms) in times.items():
                rec["ms"][name] = float(np.median(ms))
                rec["cold_ms"][name] = float(np.median(cold_ms))
                rec["call_ms"][name] = float(np.median(call_ms))
            rec["ok"] = (all(e <= PLAIN_TOL for e in rec["err"].values())
                         and all(rec["same_bits"].values())
                         and all(rec["issues"][v] == rec["want_issues"][v]
                                 for v in rec["issues"]
                                 if v not in CLUSTER_CONTROLS))
            print(json.dumps(rec), flush=True)
            del copies, plains
    return 0


def bsr_weights(wname, rows, cols, block, density, seed) -> list:
    """The BSR weights of a BSR_CASES case: chip_smoke.py's weight, or
    ROTATE weights drawn as spmm_bench's pruned_ffn generator draws them
    (one group of the shape, at block sparsity 1 - density)."""
    from tpuspmm_torch.formats import BSR

    if wname not in DRAWN:
        return [BSR.random_blocks(rows, cols, block, density, seed)]
    from spmm_bench.generators import pruned_ffn
    from spmm_bench.operands import generator

    group = pruned_ffn._group((rows, cols), ROTATE, block, 1.0 - density,
                              generator(seed, "operands", "cpu"), "cpu")
    return [BSR(indptr=indptr.numpy().astype(np.int32),
                indices=indices.numpy().astype(np.int32),
                blocks=np.ascontiguousarray(values.numpy()),
                shape=(rows, cols), block_size=tuple(block),
                nnz=int(values.numel()))
            for indptr, indices, values in group]


def bsr_sweep(names: list, cases=None, rounds: int = 1) -> int:
    """Build and time BSR_VARIANTS on BSR_CASES (those whose weight is in
    ``cases``, where given; see the module docstring); prints one JSON
    line per build and one per (case, B dtype).  Times are a launch's:
    an Olmo case's graph launches its ROTATE weights in turn; each is the
    least of ``rounds`` passes over the variants and back."""
    from tpuspmm_torch.kernels import bsr_cuda, bsr_spmm, cuda_build
    from tpuspmm_torch.utils.compare import max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    out_dir = os.path.join(OUT, "bsr")
    builds = to_build(names, BSR_OVERRIDES)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(
            lambda name: build(name, BSR_VARIANTS[name], cuda_build.nvcc(),
                               cuda_build.NVCC_FLAGS, bsr_cuda.SOURCE,
                               out_dir), builds))
    libs = {}
    for rec in built:
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("path", "group_rows")}), flush=True)
        if "path" in rec:
            libs[rec["name"]] = ctypes.CDLL(rec["path"])
            bsr_cuda._bind(libs[rec["name"]])
    add_overrides(libs, names, BSR_OVERRIDES)
    dev = torch.device("cuda")
    weights = {}
    for wname, rows, cols, block, density, seed, width in BSR_CASES:
        if cases is not None and wname not in cases:
            continue
        key = (wname, rows, cols, block, density, seed)
        if key not in weights:
            weights = {key: bsr_weights(*key)}  # one case's weights held
        ws = weights[key]
        w = ws[0]
        b32 = torch.from_numpy((np.random.default_rng(seed).standard_normal(
            (cols, width)) * 0.05).astype(np.float32)).to(dev)
        counts = np.diff(w.indptr)
        for tag in ("f32", "bf16"):
            b = b32 if tag == "f32" else b32.to(torch.bfloat16)

            bound = {}

            def run(name):
                # the serving bindings, or an override variant's own,
                # bound once with its constants on the same arrays
                bsr_cuda.load = lambda: libs[name]
                if name not in BSR_OVERRIDES:
                    return [bsr_spmm.spmm_bsr_stream(x, b) for x in ws][0]
                if name not in bound:
                    with overridden(bsr_cuda, BSR_OVERRIDES[name]):
                        bound[name] = [bsr_cuda.bind(
                            *bsr_spmm.stream_launch(x, b).keep, b,
                            x.shape[0], x.block_size) for x in ws]
                return [launch(b) for launch in bound[name]][0]

            want = bsr_spmm.bsr_spmm_plain(w, b)
            scale = float(want.abs().max())
            rec = {"case": wname, "b": tag, "width": width,
                   "block": list(block), "nblocks": w.nblocks,
                   "weights_in_turn": len(ws),
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
            for name in (list(libs) + list(libs)[::-1]) * rounds:
                times[name].append(cuda_time_ms(graphs[name].replay))
                calls[name].append(cuda_time_ms(lambda: run(name)))
            rec["ms"] = {k: min(v) / len(ws) for k, v in times.items()}
            rec["call_ms"] = {k: min(v) / len(ws) for k, v in calls.items()}
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
    from tpuspmm_torch.kernels import cuda_build, panel_spmm, strip_cuda
    from tpuspmm_torch.utils.compare import max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None,
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--chunk", action="store_true",
                    help="sweep the tile-owner routine's CHUNK_VARIANTS "
                         "and CLUSTER_VARIANTS")
    ap.add_argument("--bsr", action="store_true",
                    help="sweep the block-streaming kernel's BSR_VARIANTS")
    ap.add_argument("--cases", default=None,
                    help="with --bsr: comma-separated BSR_CASES weights "
                         "(default: all)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with --bsr: time the variants this many times "
                         "there and back, each the least; with --chunk: "
                         "capture and time them this many rounds, the "
                         "capture order rotated by one a round, each the "
                         "median of the rounds' least (default 1)")
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
    variants = ({**BSR_VARIANTS, **BSR_OVERRIDES} if args.bsr
                else {**CHUNK_VARIANTS, **CHUNK_OVERRIDES, **ROUTINE_CONTROLS,
                      **CLUSTER_VARIANTS}
                if args.chunk else VARIANTS)
    names = (args.variants.split(",") if args.variants else list(variants))
    if args.bsr:
        return bsr_sweep(names, args.cases.split(",") if args.cases
                         else None, args.rounds)
    if args.chunk:
        return chunk_sweep(names, args.rounds)
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
        a, b_np = operand(case, width)
        n = b_np.shape[1]
        geom = panel_spmm.resolve_panel_geometry(
            a, -(-n // 128) * 128, plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP,
            device=dev)
        plan = panel_spmm.panel_plan_from_geometry(a, geom)
        arrs = {}
        for gr in {g for _, g in libs.values()}:
            arrs[gr] = dict(plan.device_arrays(dev))
            index = panel_spmm.group_arrays(plan, gr // plan.tm)
            arrs[gr].update({k: v.to(dev) for k, v in index.items()})
        b32 = torch.from_numpy(b_np).to(dev)
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
                   "max_abs_c": scale, "ms": {}, "err": {},
                   "gate_ratio": {}}
            for name in libs:
                got = run(name)
                torch.cuda.synchronize()
                rec["err"][name] = max_abs_err(got, want)
                rec["gate_ratio"][name] = gate_ratio(got, a, b)
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
