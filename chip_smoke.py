#!/usr/bin/env python3
"""Drive tpuspmm_torch's serving path and its CSR / COO / BSR / ELL
engines on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--k6-parent DIR]

``--k6-parent DIR``: a checkout of an earlier commit (``git archive``
unpacked into a git-ignored directory, e.g. ``_archive/parent``), whose
K6 phase 4b runs in a subprocess of its own on the same operands; every
bf16-B output of K6 must equal that commit's bit for bit.

Prints one JSON object per phase:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off for the plain versions;
2. build: compiles the four CUDA sources of tpuspmm_torch/csrc with nvcc
   and the two C++ sources of tpuspmm_torch/native with g++, one process
   each, started together; ptxas's registers and spills of
   every kernel of the three, and the tensor-core instructions (HMMA,
   HGMMA) in their SASS (cuobjdump), which must not be zero (K6: HGMMA,
   wgmma); no tile-owner or K6 kernel may spill, ptxas may not serialise
   any K6 kernel's wgmma (C7514), and the occupancy
   calculator must fit two tile-owner blocks an SM and at least one
   C-resident cluster on the card (its count, per build, in the record);
3. kernels: on large_25605 at B width 256 (f32 and bf16 B), the panel and
   pair kernels' entry points against their plain PyTorch versions on the
   same plan at "highest" and "split2", the gate against the f64 oracle
   at "highest", and both times (CUDA events: the entry point's calls,
   and its launch replayed in a CUDA graph, the device time); every launch
   of the two is made twice and must give bit-identical output; the host
   seconds of the panel and pair geometry searches; each plan's group
   index (64-row groups: entries, B bytes loaded per call, tensor-core
   products and their floor at the bf16 rate);
3b. the panel and pair kernels against their plain versions at both
   tiers, with the control, on the geometries of STRIP_SHAPES (16- and
   32-row strips, 256- and 512-deep k-tiles, several supertiles, a
   row-permuted plan, widths 77, 130 and 200, an f32 plan with bf16 B) and
   at the gate, and on a matrix with no entry, which must give exact zeros;
4. tile kernels: launch counts of the tile-plan kernels zeroed, then on
   each of TILE_OPERANDS (large_25605 w256 at 128 x 128 and at 64 x 256
   tiles, pruned weight (a) as CSR at w512 and w1024, medium_4096 and
   medium_2048 at their on-disk widths, large_25605 and weight (a) at
   widths 77 and 130, and the 2048 x 2048 operand at density 0.1, w1024,
   every tile dense) K3 tile, K4 staged, K5a C-resident and K5b
   C-resident k-loop: two launches at "split", bit-identical, at the
   gate against the f64 oracle, K4's, K5a's and K5b's equal to K3's bit
   for bit (one tile index on the card: K3 and K4 on the owner routine,
   K5a and K5b on its cluster launch); K5a's and K5b's records carry the
   cluster (``cluster``, ``clusters``), how B's dense chunks were staged
   (``b_copy``), the multicast issues read from the device counter,
   which must equal the schedule's, and the B bytes the owner routine and
   the cluster read (``b_panel_bytes``, from the schedule); wherever a
   multicast ran and members share a k-tile the cluster must stage fewer
   chunks than the owners;
   every launch at full width, its columns (the first 128 where B is
   wider than 256) against the plain versions on the same columns at
   "split" and "split2"; every build of the routine (64 or 128 columns,
   dense tiles or none, f32 or bf16 B) must be among those held; times
   at full width (entry point, and graph-replayed device time), plain
   times at the headline; per operand the plan's chunks, tiles, dense
   tiles, sentinel shares, slabs, residency, the column tile, bound, the
   dense tiles' tensor-core floor at the bf16 rate, and the cuSPARSE time
   and, where A fits 2^26 values, the dense f32 product's (cuBLAS).
   K5b's count is read here: no engine variant
   reaches it, as in the JAX package.
   In phases 3 and 4 a "split2" result is held to SPLIT2_TOL·max|C|, and
   with an f32 operand the f32-tier output must differ from the split2
   plain by more than that (the control);
4b. block-streaming kernel (K6): on three 4096 x 4096 weights against a
   4096 x 512 B drawn as bench/pruned_llm.py draws it, f32 and bf16: (a)
   128 x 128 blocks at 10% block density, (b) (8, 128) blocks at 2% (about
   half the block rows empty), (c) weight (a) re-blocked to 4 x 4, which
   ``pack_blocks`` rebuilds into 128 x 128 blocks for K6; and (a) against
   a 4096 x 1024 B.  Each: two launches, the counter rising by two, the
   outputs bit-identical, K6 against its plain version at K6_TOL·max|C|
   (with f32 B, the control: the ladder cut to three products, summed
   exactly, must miss that limit), the gate against the f64 oracle, the
   times of K6 (entry point, and graph-replayed device time), its plain
   version, cuSPARSE CSR (``torch.sparse``) and ``torch.sparse_bsr_tensor
   @ B`` (or the error PyTorch gives), the bound, the tensor-core floor at
   the bf16 rate and the heaviest block row's floor (its owner's products
   at one SM's share of that rate).  Then, untimed, K6 against its plain
   version (with the control) and the oracle, launched twice, on the block
   shapes and widths of K6_SHAPES (bh 8-512); both builds that stage B
   (16-byte cp.async, and plain loads for rows not 16-byte aligned) must
   be among those held, for f32 and bf16 B (with bf16 B the first is the
   warp-specialised build, whose consumers ``bsr_cuda.ws_consumers``
   gives and the records carry).  With ``--k6-parent``, every bf16-B
   output of the phase equals the parent's bit for bit.  Then K6's times
   (bf16 and f32 B) on an Olmo-Hybrid-7B gate and down weight as the
   benchmark draws them (``strip_sweep.bsr_weights``: ROTATE weights
   launched in turn, so a call's planes are not in L2 from the last), at
   w512 and w16, each held to its plain version;
5. serving path: launch counts zeroed, then only ``tpuspmm_torch.spmm``
   runs: large_25605 w256 in f32 and bf16, one record in bench.py's shape;
   then the corpus dirs large_15120, large_21074, medium_2048 and
   medium_4096, each served by the route the priced dispatcher names
   (``dispatch.route``, which must be SERVED_ROUTES', the list the CPU
   tests pin: large_21074's bf16 serve reaches the panel kernel, the
   others the C-resident one), checked at the gate and timed beside
   cuSPARSE on the same operand, with every admitted route's modelled µs;
   each serve's device time too (``device_ms``: the same ``spmm``
   replayed in a CUDA graph), and each corpus dir's bf16 serve, pinned
   the same way, at the gate, timed the same two ways.  The counts are
   read as this path's launches (every kernel SERVED_ROUTES names must
   have run).  Then the BSR serving
   path in a window of its own: ``tpuspmm_torch.spmm`` on weights (a)-(c)
   in f32 and bf16, each served by K6 and by no other kernel, at the gate;
   the 4 x 4 weight at 10% block density (packing refused, as in the
   JAX package) served by the route ``dispatch.route`` names under the
   routing row, launching that route's kernel alone (none for densify),
   at the gate.  After
   the window, one ``model_fit`` record per dir the default config
   serves by panel or pair (of the headline, the four corpus dirs and
   medium_4000, at their widths): the panel and pair geometries the
   model resolves, each one's modelled ``cost_us`` beside its device
   time, which one the model serves, and the geometry the unfitted constants (step and strip 0,
   the data sheet's bandwidth) served, with its device time from the same
   run: data for the next refit and for the fit's effect, not a check.
   The record ``main_path``'s ``hbm_roofline_frac`` is the least bytes
   over the card's data-sheet rate;
5c. served handles: for K1, K2 (the headline's panel and pair plans),
   K3, K4, K5a, K5b (the headline's tile plan) and K6
   (weight (a)), f32 and bf16 B, the launch a served handle holds
   (``dispatch._launch``; K5b's ``cres_spmm.cres_launch``, it has no
   route) against the entry point on the same plan, bit for bit, and
   against the plain version (PLAIN_TOL; K6_TOL for K6); the handle's
   call timed beside the entry point's and its graph replay; an f16 B
   refused by the bound launch and by the entry point.  Then the headline
   served end to end: ``spmm``'s time beside its handle's launch alone
   and the device time, cuSPARSE beside;
6. engine: every launch count zeroed, then ``tpuspmm_torch.cli.main``
   runs ``--csr --coo`` and ``--bsr --ell`` on large_25605 ``--width 256``
   in f32 and bf16 B, ``--csr`` on medium_2048 and medium_4096 and
   ``--bsr --ell`` on medium_4096 (its on-disk `.bsr` and `.ell`) at their
   on-disk widths (B 2048 and 4096 wide: the staged kernel slabs),
   ``--bsr`` on build/pruned_llm_b128 (weight (a) written with
   ``BSR.save`` and B as ``dense.in`` by this script), and ``--auto`` on
   large_25605 w256 and on that directory.  Every variant record is
   admitted and checked, or skipped as inadmissible; none carries an error;
   every variant that is not verified-only passes the gate, the one
   ``--auto`` selected included.  The counts are read as the engine's
   launches: panel, pair, tile, staged, C-resident and K6 each rose.  The
   full records go to ``build/engine_records.jsonl``;
6b. tuned: the ranking and geometry caches (TPUSPMM_TORCH_TUNE_CACHE and
   TPUSPMM_TORCH_GEOM_CACHE, set for the whole script to files under
   build/tune_cache, emptied before the first phase, so nothing is
   written into the home directory and no earlier run's pins are read);
   every launch count is zeroed; then on large_25605 w256 with f32 and
   with bf16 B, medium_4096 at its on-disk w4096, and pruned weight (a)
   as a BSR at w512 (the BSR engine: K6 against the others): the default
   ``tpuspmm_torch.spmm`` serve is timed (before any tune pins a
   geometry), ``autotune.tune`` runs (8 calls a window, 3 windows a
   measurement), every ranked variant passes the gate when run again,
   ``spmm(method="tuned")`` serves the first entry that is not
   verified-only (its kernel number seen through ``engine.run_kernel``;
   its output equal to that kernel's where two of its runs agree bit for
   bit), and a second tune on a fresh container measures nothing and
   returns the same ranking; one record per operand with the ranking, the
   winner, and the tuned serve's time beside the default serve's and
   cuSPARSE's; the default serve on medium_4096 must be the tile family
   (priced) and within 2x of the tuned serve.  After every tune, the
   panel and pair entries of every ranking carry their geometry and the
   resolvers return it for
   that operand's B dtype on a fresh container of the same matrix (from
   the disk cache).  The counts are read as the tuned window's launches.
   Then ``python -m tpuspmm_torch.bench`` in a process of its own with
   caches of its own, so its ``default_serve_ms`` is the model's pick and
   its ranking its own (its last line re-emitted, held to ``correct``
   and ``bf16_serving_correct``), ``cli.main`` with
   ``--csr --tuned`` on large_25605 w256 (correct), a ``--trace`` run of
   the panel kernel whose Chrome trace must name ``group_owner_kernel``,
   and the API on the card: ``spmv`` with f32 and bf16 x, ``spmm_batched``
   on a (3, K, 256) stack (one launch), and ``spmm_fn`` on large_25605
   w256 with f32 and bf16 B, whose backward must launch a hand kernel on
   A^T (25605 x 6300) and give a gradient in B's dtype at the gate against
   the f64 oracle of A^T G;
7. dispatch routes: ``tpuspmm_torch.spmm`` on ROUTE_DIRS (small_32x32,
   medium_1484), each served by the route ``dispatch.route`` names, at
   the gate;
8. entry points: counts zeroed again, the panel and pair entry points on
   the serving corpus, each checked at the gate; counted apart;
9. extreme-value dirs (medium_1484/2880/4000, large_20000): the route
   ``tpuspmm_torch.spmm`` takes at the default config and its gate against
   the f64 oracle, required on the compensated ("exact") route; the panel
   and pair kernels against their plain versions, with the gates of both
   printed, not required (plain f32 passes there only by luck);
10. parallel (``tpuspmm_torch.parallel``) in a one-rank NCCL group the
   script opens itself (no launcher): every schedule (row-sharded, 2-D,
   ring, k-shard) with every local (xla, tile, panel, pair) on
   large_25605 w256 with f32 and bf16 B, in a launch window of its own:
   each call at the gate against the f64 oracle, launching exactly its
   local's kernel once (xla none), and the tile, panel and pair outputs
   equal bit for bit to the single-card entry point on the plan the
   one-rank shard plan equals; each combo's time beside that entry's.
   Then ``make_train_state`` on pruned weight (a) as CSR with n = 512 and
   three ``lsq_train_step``s: the loss falls, each step launches K3
   twice, and the last step's dB is held to its plain version within
   PLAIN_TOL·max|dB| (the update equal to B - lr·dB bit for bit).  Then
   ``tpuspmm_torch.examples.distributed_serving`` under ``python -m
   torch.distributed.run --standalone --nproc_per_node=1`` on large_25605
   w256 with the panel local: exit 0, all four schedules correct;
10b. sweeps (the reference's benchmark harness): both host libraries
   (``tpuspmm_torch/native``, built with g++ in phase 2) load; the tile
   plan of the 2048 x 2048 operand at density 0.9 (3.77 M nonzeros) built
   natively and by numpy, equal, both timed; large_25605's .mtx read
   natively equals scipy's; ``gen_sparse``, ``convert_mtx`` and
   ``validate`` into build/sweeps/tools (the converted small_32x32's
   result.expect against the committed golden); then, launch counts and
   ``native.plan_builds`` zeroed, in one window: ``sweep_formats`` on
   SWEEP_DIRS x CSR / COO / BSR / ELL (f32 B, on-disk or 512 synthesised
   columns, ``--skip-seq --repeats 3 --retries 0``), ``sweep_sparsity``
   at SWEEP_DENSITIES, ``pruned_llm`` at 4 x 4 blocks ({0.8, 0.9, 0.95})
   and 128 x 128 blocks (0.9: K6) in f32 and bf16, ``pruned_mlp`` with
   f32 and bf16 activations and ``--sharded`` under ``python -m
   torch.distributed.run --nproc_per_node=1``, and ``summarize``.  Every
   run exits 0 (no incorrect record outside verified-only, no error
   record, no faulted group), the 128 x 128 weight's block stream is K6
   launched once a call, the panel, tile, C-resident and K6 kernels
   launched, and every plan of 200,000 nonzeros or more was built
   natively.  One record per run (its seconds), then one with the
   window's launches and, per (testcase, format, B dtype), the best hand
   kernel's ``cudaKernelTimeMs`` beside cuSPARSE's.  Records and the
   summary go to build/sweeps/ (the whole corpus and all nine densities
   run as calls of their own, README);
10c. tools (the reference's last tools), launch counts zeroed, in one
   window: ``tpuspmm_torch.entry.entry()``'s ``fn`` (the raw K1 launch,
   counted by ``PanelLaunch.launches``, not ``spmm_panel``'s) against its
   plain version within PLAIN_TOL·max|C| and at the gate against the f64
   oracle, timed (entry point, graph replay, plain); ``profile_variants``
   on TOOLS_PROFILE (large_25605 w256, large_21074 w512, medium_4000,
   2048 x 2048 at 0.1 w1024, the three small dirs): no error, every
   admitted strategy at the gate, every hand kernel with a ``device_ms``;
   ``hbm_control``: three records, the stream kernel (csrc/stream.cu)
   equal to ``2 * x + 1``, every ``frac_of_nominal`` at most 1.05;
   ``weak_scaling --devices 1`` with the tile and panel locals (one NCCL
   rank in a process of its own) at the gate.  The tile, staged,
   C-resident, panel and stream kernels must have launched in the window
   (the ranks' launches come back in their records);
10d. the priced dispatcher (``kernels/dispatch.route_costs``, the
   serve-time model of the H100 row, fitted by ``tools/fit_routing.py``):
   on ROUTING_OPERANDS (the 4 x 4 and 128 x 128 pruned weights at 90% as
   CSR w512, f32 and bf16 B; the uniform 2048 x 2048 at densities 0.016
   and 0.1, w1024; large_21074 w512; medium_4096 w4096 and large_15120
   w12600 at their on-disk B) the route ``tpuspmm_torch.spmm`` serves
   must be the one ``dispatch.route`` names, the least modelled time,
   and pass the gate; its serve and device times, and every admitted
   route's modelled µs beside its measured ``ms`` and ``device_ms`` (each
   pinned by the row, served and gated), JAX's order's route and the
   chosen route's regret (reported, not required);
10e. the expert layer (``moe_phase``): one DeepSeek-V3 MoE layer at its
   published widths through ``tpuspmm_torch.moe``, 131,072 tokens routed
   over 256 experts, held experts 0-7 and the shared expert: per draw the
   experts' token counts, handle builds, warp-specialised binds (every
   build must be one: the layer pads each slab to a multiple of 8) and
   wall times; one profiled call's spans and K6 launches by kernel; the
   layer against its plain reference (TF32 off) with bf16 and f32 tokens,
   each with the control (bf16 expert weights) missing the limits;
11. the kernels line (all seven kernels and the stream kernel, with the
   least time the card could take for the work, ``bound_ms``, the library
   call's time, the tuned window's launches, ``tuned_launches``, the
   parallel window's, ``parallel_launches``, the sweeps window's,
   ``sweeps_launches``, and the tools window's, ``tools_launches``, K1's
   with ``entry()``'s apart, ``entry_launches``);
   every other number in it measured in this run: floors and plan work
   stay in their phase records; the tile family's operands also carry
   their bound at the stream rate ``hbm_control`` measured in phase 10c),
   the card line, and the final ok line.

Any failed phase raises, and the script exits non-zero.  It exits
non-zero without a result when no CUDA device is present or when the
tpuspmm_torch package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import platform
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = "large_25605"
WIDTH = 256
MAIN_CORPUS = ("large_15120", "large_21074", "medium_2048", "medium_4096")
# the routes the priced dispatcher serves the headline (w256) and
# MAIN_CORPUS (on-disk B, large_21074 w256) by, (dir, B dtype): the list
# tests/test_torch_route_model.py pins on the CPU.  large_21074's bf16
# serve reaches K1; no default serve reaches K2 (the engine's window
# counts its launches)
SERVED_ROUTES = {(HEADLINE, "f32"): "cres", (HEADLINE, "bf16"): "cres",
                 ("large_15120", "f32"): "cres",
                 ("large_15120", "bf16"): "cres",
                 ("large_21074", "f32"): "cres",
                 ("large_21074", "bf16"): "panel",
                 ("medium_2048", "f32"): "cres",
                 ("medium_2048", "bf16"): "cres",
                 ("medium_4096", "f32"): "cres",
                 ("medium_4096", "bf16"): "cres"}
# the dir outside MAIN_CORPUS whose default serve is panel / pair: its
# model_fit record (its values are extreme, so it is not held to the gate)
FIT_EXTRA = "medium_4000"
EXTREME_CORPUS = ("medium_1484", "medium_2880", "medium_4000", "large_20000")
# the pruned-LLM weights of the K6 phases: (rows, cols, block, block
# density, seed), and B as bench/pruned_llm.py draws it
PRUNED = {"a": (4096, 4096, (128, 128), 0.1, 0),
          "b": (4096, 4096, (8, 128), 0.02, 1)}
PRUNED_4X4 = (4096, 4096, (4, 4), 0.1, 0)
# block shapes and widths the pruned weights do not reach, K6 against its
# plain version only: (rows, cols, block, block density, seed, B width).
# Row sub-tiles of 8 where 32 does not divide bh, bh above 128 (split into
# 128-row sub-tiles), widths that are not a multiple of the kernel's
# 64-column tile and rows that are not 16-byte aligned (77, 130: B staged
# by plain loads), and a matrix with no stored block
K6_SHAPES = ((512, 1024, (16, 256), 0.2, 2, 200),
             (384, 512, (24, 128), 0.3, 3, 77),
             (512, 512, (256, 128), 0.5, 4, 130),
             (1024, 1024, (512, 128), 0.5, 6, 256),
             (256, 512, (8, 128), 0.0, 5, 64))
# K6's timed operands: (weight, B width); B is pb32's draw at that width
K6_OPERANDS = (("a", 512), ("b", 512), ("c", 512), ("a", 1024))
PRUNED_WIDTH = 512
# operands of the tile-plan kernels (phase 4): (operand, B width or None
# for the on-disk width, B dtypes, tile_m, tile_k).  "pruned_a" is weight
# (a) as CSR; the 64-row, 256-deep plan runs 4 warps a block.  Weight (a)
# at w1024 gives 256 blocks of 128 columns, the wide build on the tensor
# cores (w512 gives 128 blocks, fewer than the SMs: 64 columns).  Widths
# 77 and 130 have no 16-byte B rows (the dense path stages B with plain
# stores) and 77 no vector rows at all; 130 on the 64-row plan takes the
# wide build with scalar loads and stores.  "random_2048" is the sparsity
# sweep's 2048 x 2048 at density 0.1 as profile_variants draws it (values
# ±100, B U(-1, 1)) at w1024: every 128 x 128 tile dense, each k-tile's B
# panel shared by all 16 row tiles (the cluster launch's multicast)
TILE_OPERANDS = ((HEADLINE, WIDTH, ("f32", "bf16"), 128, 128),
                 (HEADLINE, WIDTH, ("f32",), 64, 256),
                 ("pruned_a", PRUNED_WIDTH, ("f32", "bf16"), 128, 128),
                 ("pruned_a", 1024, ("f32", "bf16"), 128, 128),
                 ("medium_4096", None, ("f32",), 128, 128),
                 ("medium_2048", None, ("f32",), 128, 128),
                 (HEADLINE, 77, ("f32", "bf16"), 128, 128),
                 (HEADLINE, 130, ("f32", "bf16"), 64, 256),
                 ("pruned_a", 77, ("f32", "bf16"), 128, 128),
                 ("pruned_a", 130, ("f32", "bf16"), 128, 128),
                 ("random_2048", 1024, ("f32", "bf16"), 128, 128))
PRUNED_DIR = os.path.join(REPO, "build", "pruned_llm_b128")
# the autotuner's ranking and geometry caches, for every phase (nothing is
# written into the home directory), emptied before the first
CACHE_DIR = os.path.join(REPO, "build", "tune_cache")
# engine runs: (cli arguments, what the run must show)
ENGINE_RUNS = (
    ["--csr", "--coo", "-d", HEADLINE, "--width", str(WIDTH)],
    ["--csr", "--coo", "-d", HEADLINE, "--width", str(WIDTH),
     "--b-dtype", "bf16"],
    ["--csr", "-d", "medium_2048"],
    ["--csr", "-d", "medium_4096"],
    ["--bsr", "--ell", "-d", HEADLINE, "--width", str(WIDTH)],
    ["--bsr", "--ell", "-d", HEADLINE, "--width", str(WIDTH),
     "--b-dtype", "bf16"],
    ["--bsr", "--ell", "-d", "medium_4096"],
    ["--bsr", "-d", PRUNED_DIR],
    ["--auto", "-d", HEADLINE, "--width", str(WIDTH)],
    ["--auto", "-d", PRUNED_DIR],
)
# phase 7: dirs whose serve is held to the route dispatch.route names
ROUTE_DIRS = ("small_32x32", "medium_1484")
# phase 10d: (operand, B dtypes, B width; None: on-disk) served by the
# priced dispatcher beside every admitted route: the pruned weights as
# CSR, the uniform 2048² (values U(-1, 1)), large_21074, and the wide-B
# dirs where JAX's order serves the strip routine
ROUTING_OPERANDS = (("pruned_4x4_s0.9", ("f32", "bf16"), PRUNED_WIDTH),
                    ("pruned_128x128_s0.9", ("f32", "bf16"), PRUNED_WIDTH),
                    ("uniform_2048_d0.016", ("f32",), 1024),
                    ("uniform_2048_d0.1", ("f32",), 1024),
                    ("large_21074", ("f32",), PRUNED_WIDTH),
                    ("medium_4096", ("f32",), None),
                    ("large_15120", ("f32",), None))
# the sweeps phase: the corpus dirs it sweeps at their on-disk B
# (large_25605 synthesises 512 columns; the whole corpus runs as its own
# call, README), the sparsity sweep's size (the reference's) and densities
SWEEP_DIRS = ("large_25605", "medium_4096", "medium_2048", "small_32x32")
SWEEP_SHAPE = (2048, 2048)
SWEEP_DENSITIES = "0.1,0.5,0.9"
# geometries of the strip kernel (K1, K2) the corpus does not reach, each
# against the plain versions at both tiers: (rows, cols, density, tm, tk,
# sm or None, row-permuted, bf16 plan, B width, B dtype, seed).  Strips of
# 16 and 32 rows, 256- and 512-deep k-tiles, several supertiles, widths
# that are no multiple of 4 or 8 (no 16-byte rows), an f32 plan with bf16
# B, and a matrix with no entry
# phase 10c: profile_variants' operands (the headline, the dirs where
# cuSPARSE led the corpus sweep, and the sparsity sweep's shape)
TOOLS_PROFILE = (("-d", HEADLINE, "--width", "256"),
                 ("-d", "large_21074", "--width", "512"),
                 ("-d", "medium_4000"),
                 ("--random", "2048x2048x0.1", "--width", "1024"),
                 ("-d", "small_10x10"), ("-d", "small_210"),
                 ("-d", "small_32x32"))
STRIP_SHAPES = (
    (3000, 5000, 0.002, 16, 256, None, False, False, 77, "f32", 1),
    (3000, 5000, 0.002, 32, 128, 512, True, True, 130, "f32", 2),
    (3000, 5000, 0.002, 8, 256, 320, False, False, 130, "bf16", 3),
    (2000, 3000, 0.003, 16, 128, None, True, True, 200, "bf16", 4),
    (2000, 6000, 0.002, 8, 512, 1000, False, True, 256, "f32", 6),
    (500, 700, 0.0, 8, 128, 40, False, True, 64, "f32", 5))
# the card's rates for f32 operands (H100 SXM data sheet): on the tensor
# cores (TF32), which bound the work, and in FMAs on the CUDA cores, the
# floor of a kernel that uses no tensor cores; and the bf16 tensor-core
# rate, which the strip kernel's products run at
TF32_PEAK_FLOPS = 495e12
F32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
# kernel against its plain version: both sum f32 products (exact for bf16
# operands) in different orders, so they differ by f32 rounding only
PLAIN_TOL = 1e-4
# K6 against its plain version: each k-step's products summed in a fresh
# accumulator, then into the f32 sums (csrc/bsr_spmm.cu), so the two differ
# by f32 rounding, below the ~4.5e-6·max|C| that the f32-B ladder cut to
# three products drops: that cut ladder, summed exactly, must miss this
# limit on every f32 operand (the control)
K6_TOL = 2e-6
# at "split2" both run the 2-term tier term for term, so they differ by f32
# rounding only, held below the tier's own error (~2^-17·max|C|): a kernel
# that computed plain f32 products there fails, and each phase shows it
# (the f32-tier output against the split2 plain must exceed this)
SPLIT2_TOL = 2.0 ** -20


def plain_tol(mode: str) -> float:
    return SPLIT2_TOL if mode == "split2" else PLAIN_TOL


# a checkout of an earlier commit whose K6 gives phase 4b's bf16-B outputs
# bit for bit (``--k6-parent DIR``), or None
K6_PARENT = (sys.argv[sys.argv.index("--k6-parent") + 1]
             if "--k6-parent" in sys.argv else None)
# the parent's K6 on phase 4b's operands, run from its checkout (argv:
# the operands' file, the outputs' file)
PARENT_K6 = """
import sys
import torch
from tpuspmm_torch.formats import BSR
from tpuspmm_torch.kernels import bsr_spmm
out = {}
for key, c in torch.load(sys.argv[1]).items():
    a = BSR(indptr=c["indptr"].numpy(), indices=c["indices"].numpy(),
            blocks=c["blocks"].numpy(), shape=tuple(c["shape"]),
            block_size=tuple(c["block_size"]), nnz=int(c["nnz"]))
    out[key] = bsr_spmm.spmm_bsr_stream(a, c["b"].cuda()).cpu()
torch.save(out, sys.argv[2])
"""


def k6_parent_equal(parent: str, outputs: dict) -> dict:
    """{key: the parent's K6 output equals ours bit for bit} for outputs
    {key: (BSR, B, our output)}; the parent's K6 runs in a subprocess from
    its checkout ``parent``, which builds its own library under its
    build/."""
    work = os.path.join(REPO, "build", "k6_parent")
    os.makedirs(work, exist_ok=True)
    inp, out = os.path.join(work, "in.pt"), os.path.join(work, "out.pt")
    torch.save({key: {"indptr": torch.from_numpy(a.indptr),
                      "indices": torch.from_numpy(a.indices),
                      "blocks": torch.from_numpy(a.blocks),
                      "shape": list(a.shape),
                      "block_size": list(a.block_size), "nnz": int(a.nnz),
                      "b": b.cpu()}
                for key, (a, b, _) in outputs.items()}, inp)
    parent = os.path.abspath(parent)
    res = subprocess.run([sys.executable, "-c", PARENT_K6, inp, out],
                         cwd=parent, env=dict(os.environ, PYTHONPATH=parent),
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"the parent's K6 failed:\n{res.stderr[-3000:]}")
    theirs = torch.load(out)
    return {key: bool(torch.equal(theirs[key], got))
            for key, (_, _, got) in outputs.items()}


# phase 10e: one MoE layer of the DeepSeek-V3 configuration at its
# published widths, for one EP32 prefill step (32 chips' 4096-token chunks)
MOE_CONFIG = "spmm_bench/configs/dsv3_ep32_b128.json"
MOE_TOKENS = 32 * 4096
MOE_CHUNK = 4096
# the configuration's first MoE layer (after first_k_dense_replace)
MOE_LAYER = 3
MOE_SEED = 2100000021
MOE_DRAWS = 3
# f32 tokens: max |out - ref| / max |ref| (the cell's limit: each product
# is K6 at f32 A); bf16 tokens: ||out - ref|| / ||ref||, since h rounds to
# bf16 between the products in both and a few land a bf16 step apart, and
# the largest gap at a looser limit, between one seed's readings of the
# layer (1.30e-3) and the control (4.58e-3) (tests/test_torch_moe.py gives
# the reasons)
MOE_LIMIT = 1e-5
MOE_NORM_LIMIT = 1e-3
MOE_BF16_MAX_LIMIT = 2.5e-3


def moe_phase() -> None:
    """One MoE layer at published widths: held experts 0-7 and the shared
    expert of layer MOE_LAYER as ``pruned_moe`` draws them from MOE_SEED,
    a seeded router over all 256 experts and MOE_TOKENS tokens, this
    chip's shared part on its first MOE_CHUNK.  Per draw of bf16 tokens:
    the per-expert token counts, the first call's and a repeat's wall
    time, the handle builds and warp-specialised binds the first made (the
    builds that were not warp-specialised took K6's register build, and
    there must be none); one profiled call's spans and K6 launches by
    kernel.  Then the layer against the reference on the card (bf16 and
    f32 tokens), each with the control, the reference on bf16-rounded
    expert weights, which must miss the limits.  Emits ``moe_draws``,
    ``moe_profiled`` and ``moe_checks``."""
    from spmm_bench.generators import pruned_moe
    from spmm_bench.models import deepseek_v3_moe as ref
    from tpuspmm_torch import BSR, Expert, Routing, moe
    from tpuspmm_torch.ops.moe import TOKENS_COUNTER
    from tpuspmm_torch.utils import profiling

    dev = torch.device("cuda")
    with open(os.path.join(REPO, MOE_CONFIG)) as f:
        config = json.load(f)
    hidden = config["hidden_size"]
    n_experts = config["published"]["n_routed_experts"]
    prefix = f"layer{MOE_LAYER}."
    ops = [op for op in pruned_moe.build(config, MOE_SEED, dev, REPO)
           if op.name.startswith(prefix)]

    def held(dtype=None):
        """{id: weights} and the shared expert's: BSR containers, or
        dense tensors rounded to ``dtype`` for the reference."""
        def one(op):
            if dtype is None:
                values = np.ascontiguousarray(op.values.cpu().numpy())
                return BSR(indptr=op.indptr.cpu().numpy().astype(np.int32),
                           indices=op.indices.cpu().numpy().astype(np.int32),
                           blocks=values, shape=tuple(op.shape),
                           block_size=tuple(op.block), nnz=int(values.size))
            return ref.dense(op.shape, op.block, op.indptr, op.indices,
                             op.values).to(dtype).float()
        ws = [one(op) for op in ops]
        groups = [ws[i:i + 3] for i in range(0, len(ws), 3)]
        return dict(enumerate(groups[:-1])), groups[-1]

    experts, shared = held()
    experts = {e: Expert(*w) for e, w in experts.items()}
    shared = Expert(*shared)
    g = torch.Generator(device=dev).manual_seed(MOE_SEED)
    router = torch.randn((n_experts, hidden), generator=g,
                         device=dev) / hidden ** 0.5
    bias = torch.randn(n_experts, generator=g, device=dev) * 1e-3
    routing = Routing.from_config(config)
    own = slice(0, MOE_CHUNK)

    def layer(x):
        return moe(x, router, bias, experts, routing, shared, own=own)

    def timed(x):
        before = profiling.snapshot()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = layer(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        after = profiling.snapshot()
        rose = {k: after[k][0] - before.get(k, (0, 0.0))[0] for k in after
                if after[k][0] != before.get(k, (0, 0.0))[0]}
        return out, seconds, rose

    def tokens(draw, dtype):
        gx = torch.Generator(device=dev).manual_seed(MOE_SEED + 1 + draw)
        return (torch.randn((MOE_TOKENS, hidden), generator=gx, device=dev)
                * 0.05).to(dtype)

    draws = []
    for draw in range(MOE_DRAWS):
        x = tokens(draw, torch.bfloat16)
        chosen, _ = ref.route(x, router, bias, config)
        loads = torch.bincount(chosen.flatten(), minlength=n_experts)
        widths = loads[:len(experts)].tolist()
        _, first_s, built = timed(x)
        _, repeat_s, again = timed(x)
        builds = built.get("tpuspmm_torch.served.build", 0)
        bind_ws = built.get("tpuspmm_torch.bsr.bind_ws", 0)
        draws.append({
            "expert_tokens": widths,
            "load_min_max_of_256": [int(loads.min()), int(loads.max())],
            "first_call_s": first_s, "repeat_call_s": repeat_s,
            "first_builds": builds, "first_bind_ws": bind_ws,
            "repeat_builds": again.get("tpuspmm_torch.served.build", 0),
            "tokens_counted": again.get(TOKENS_COUNTER, 0),
            "k6_calls": 3 * (sum(1 for n in widths if n) + 1),
            "register_builds": builds - bind_ws})
        check(builds == bind_ws,
              f"every handle the layer built is warp-specialised ({draw})")
        check(again.get(TOKENS_COUNTER, 0) == sum(widths),
              f"the tokens counter adds the held experts' tokens ({draw})")
        check(again.get("tpuspmm_torch.served.build", 0) == 0,
              f"a repeat of the same widths builds no handle ({draw})")
        del x
    emit("moe_draws", tokens=MOE_TOKENS, own_tokens=MOE_CHUNK,
         layer=MOE_LAYER, seed=MOE_SEED, draws=draws)

    # one profiled call of the last draw: the spans and K6's launches
    x = tokens(MOE_DRAWS - 1, torch.bfloat16)
    from torch.profiler import ProfilerActivity, profile

    before = profiling.snapshot()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        layer(x)
        torch.cuda.synchronize()
    after = profiling.snapshot()
    spans = {k: [after[k][0] - before.get(k, (0, 0.0))[0],
                 after[k][1] - before.get(k, (0, 0.0))[1]]
             for k in after if k.startswith("tpuspmm_torch.")
             and after[k][0] != before.get(k, (0, 0.0))[0]}
    kernels = {ev.key: {"count": ev.count,
                        "device_ms": ev.device_time_total / 1e3}
               for ev in prof.key_averages() if "bsr" in ev.key
               and "kernel" in ev.key}
    del prof
    emit("moe_profiled", spans=spans, k6_kernels=kernels)

    # the layer against the reference, bf16 tokens (the last draw) then f32
    checks = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = tokens(MOE_DRAWS - 1, dtype)
        out = layer(x)
        dense_experts, dense_shared = held(torch.float32)
        want = ref.moe_share(x, router, bias, dense_experts, config,
                             dense_shared, own=own)
        gap = (out - want)
        got = {"max_rel_err": float(gap.abs().max() / want.abs().max()),
               "norm_rel_err": float(gap.norm() / want.norm())}
        del out, gap, dense_experts, dense_shared
        bf_experts, bf_shared = held(torch.bfloat16)
        control = ref.moe_share(x, router, bias, bf_experts, config,
                                bf_shared, own=own)
        gap = control - want
        ctl = {"max_rel_err": float(gap.abs().max() / want.abs().max()),
               "norm_rel_err": float(gap.norm() / want.norm())}
        limits = ({"norm_rel_err": MOE_NORM_LIMIT,
                   "max_rel_err": MOE_BF16_MAX_LIMIT}
                  if dtype == torch.bfloat16 else {"max_rel_err": MOE_LIMIT})
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        checks[tag] = {"layer": got, "control": ctl, "limits": limits}
        for key, limit in limits.items():
            check(got[key] <= limit,
                  f"moe {tag} {key} {got[key]} <= {limit}")
            check(ctl[key] > limit,
                  f"moe {tag} control {key} {ctl[key]} misses {limit}")
        del x, want, control, gap, bf_experts, bf_shared
        torch.cuda.empty_cache()
    emit("moe_checks", checks=checks,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float, hbm_bytes_per_s: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its tensor cores' f32 rate, whichever is longer; and
    the operations over the CUDA cores' f32 FMA rate (``fma_floor_ms``)."""
    t_bytes, t_ops = nbytes / hbm_bytes_per_s, flops / TF32_PEAK_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fma_floor_ms": flops / F32_PEAK_FLOPS * 1e3}


def gate_ratio(result, reference) -> float:
    """max |result - reference| / (1e-3 + 1e-2·|reference|): at most 1
    where the gate (``utils.compare.allclose``) passes."""
    got = result.detach().double().cpu().numpy()
    ref = np.asarray(reference, dtype=np.float64)
    return float(np.max(np.abs(got - ref) / (1e-3 + 1e-2 * np.abs(ref)),
                        initial=0.0))


def tensor_core_ops(path: str) -> tuple:
    """Tensor-core instructions in a built library's SASS (cuobjdump),
    and the names of the kernels it holds."""
    from tpuspmm_torch.kernels import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    return ({op: len(re.findall(rf"\b{op}\.", sass))
             for op in ("HMMA", "HGMMA")},
            set(re.findall(r"Function : (\w+)", sass)))


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel in nvcc's -Xptxas -v."""
    out = []
    for name, body in re.findall(
            r"Compiling entry function '(\w+)' for 'sm_90a'\n(.*?)"
            r"(?=ptxas info\s+: Compiling|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        out.append({"kernel": name, "registers": int(regs.group(1)),
                    "spill_store_bytes": int(spill.group(1)) if spill
                    else None})
    return out


def parallel_phase(parallel, a, b32, b16, refs, pruned_csr, xla, tiles,
                   tile_spmm, panel_spmm, pair_spmm, gpu, card) -> dict:
    """Phase 10 in the one-rank group: the 16 schedule x local combos on
    the headline with f32 and bf16 B, then the training steps.  Returns
    the window's launches and the records' times."""
    from tpuspmm_torch.kernels.common import round_up
    from tpuspmm_torch.ops.xla import coo_view
    from tpuspmm_torch.utils.compare import allclose, max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms

    mesh1 = parallel.make_mesh((1,), ("rows",))
    mesh2 = parallel.make_mesh((1, 1))
    schedules = {
        "row_sharded": lambda loc, b: parallel.spmm_row_sharded(
            a, b, mesh1, local=loc),
        "2d": lambda loc, b: parallel.spmm_2d(a, b, mesh2, local=loc),
        "ring": lambda loc, b: parallel.spmm_ring(a, b, mesh1, local=loc),
        "kshard": lambda loc, b: parallel.spmm_kshard(a, b, mesh1,
                                                      local=loc),
    }
    counters = {"tile": tile_spmm.spmm_tiles, "panel": panel_spmm.spmm_panel,
                "pair": pair_spmm.spmm_pair}
    # at one rank each shard (and bucket) plan is the single-card plan of
    # the local's geometry: its entry point's output, computed before the
    # window, is what every schedule must give bit for bit
    coo = coo_view(a)
    single_plans = {
        "tile": tiles.plan_from_container(a),
        "panel": panel_spmm.build_panel_plan(
            coo.rows, coo.cols, coo.values, a.shape, tm=8, tk=128,
            panel_strips=16),
        "pair": pair_spmm.build_pair_plan(
            coo.rows, coo.cols, coo.values, a.shape, tm=8, tk=128,
            chunk_strips=32)}
    single_fns = {"xla": lambda b: xla.spmm_xla(a, b),
                  **{loc: (lambda b, loc=loc: counters[loc](
                      single_plans[loc], b)) for loc in counters}}
    single = {}
    for b in (b32, b16):
        for loc, fn in single_fns.items():
            single[loc, b.dtype] = (fn(b), cuda_time_ms(lambda: fn(b)))
    for counter in counters.values():
        counter.launches = 0
    times = {}
    m = a.shape[0]
    for b in (b32, b16):
        tag = "f32" if b.dtype == torch.float32 else "bf16"
        for sched, run in schedules.items():
            for loc in ("xla", "tile", "panel", "pair"):
                before = {n: c.launches for n, c in counters.items()}
                out = run(loc, b)
                torch.cuda.synchronize()
                ran = {n: c.launches - before[n] for n, c in counters.items()}
                check(ran == {n: int(n == loc) for n in counters},
                      f"parallel {sched} {loc} {tag} launched {ran}")
                check(tuple(out.shape) == (m, WIDTH)
                      and bool(torch.isfinite(out).all()),
                      f"parallel {sched} {loc} {tag} output finite, "
                      f"({m}, {WIDTH})")
                gate = allclose(out, refs[b.dtype])
                check(gate, f"parallel {sched} {loc} {tag} gate vs f64 "
                            "oracle")
                want, single_ms = single[loc, b.dtype]
                equal = bool(torch.equal(out, want))
                if loc != "xla":
                    check(equal, f"parallel {sched} {loc} {tag} equal bit "
                                 "for bit to the single-card entry point")
                ms = cuda_time_ms(lambda: run(loc, b))
                times[sched, loc, tag] = ms
                emit("parallel", schedule=sched, local=loc, b_dtype=tag,
                     testcase=HEADLINE, bCols=WIDTH, ranks=1, gate=gate,
                     bit_equal_single_card=equal,
                     max_abs_err_single_card=max_abs_err(out, want),
                     ms=ms, single_card_ms=single_ms, launches=ran, gpu=gpu,
                     power_limit=card.split(",")[-1].strip())
                del out
    del single
    # what the one-rank collectives cost on their own, at the k-shard
    # partial's size (6304 x 256 f32): the schedules' time above their
    # single-card entry
    group = mesh1.get_group("rows")
    partial = torch.ones(round_up(m, 8), WIDTH, device=b32.device)
    out = torch.empty_like(partial)
    emit("parallel_collectives", shape=list(partial.shape), ranks=1,
         reduce_scatter_ms=cuda_time_ms(
             lambda: torch.distributed.reduce_scatter_tensor(
                 out, partial, group=group)),
         all_reduce_ms=cuda_time_ms(
             lambda: torch.distributed.all_reduce(partial, group=group)),
         gpu=gpu, power_limit=card.split(",")[-1].strip())
    del partial, out

    # training: pruned weight (a) as CSR, B 512 wide; lr = 1/‖A‖_F² is at
    # most 1/‖A‖₂², so each step descends
    k = pruned_csr.shape[1]
    lr = 1.0 / float(np.sum(np.square(pruned_csr.values, dtype=np.float64)))
    state = parallel.make_train_state(pruned_csr, 512, mesh2, seed=0)
    losses, per_step = [], []
    for _ in range(3):
        before = tile_spmm.spmm_tiles.launches
        new_state, loss = parallel.lsq_train_step(state, mesh2, lr=lr)
        torch.cuda.synchronize()
        per_step.append(tile_spmm.spmm_tiles.launches - before)
        losses.append(float(loss))
        prev, state = state, new_state
    check(per_step == [2, 2, 2], f"each step launches K3 twice ({per_step})")
    check(losses[2] < losses[1] < losses[0], f"the loss falls ({losses})")
    step_ms = cuda_time_ms(lambda: parallel.lsq_train_step(state, mesh2,
                                                           lr=lr))
    launches = {n: c.launches for n, c in counters.items()}
    # the last step's dB against its plain version (outside the window)
    res = tile_spmm.spmm_tiles(prev["fwd"].local, prev["b"][:k]) \
        - prev["c_target"]
    db = tile_spmm.spmm_tiles(prev["bwd"].local, res)
    check(torch.equal(state["b"][:k], prev["b"][:k] - lr * db),
          "the step's update is B - lr*dB")
    db_plain = tile_spmm.tile_spmm_plain(prev["bwd"].local, res, "split")
    err, scale = max_abs_err(db, db_plain), float(db_plain.abs().max())
    check(err <= PLAIN_TOL * scale,
          f"dB against its plain version {err} <= {PLAIN_TOL}*{scale}")
    emit("parallel_train", weight="a as CSR", shape=list(pruned_csr.shape),
         nnz=pruned_csr.nnz, n=512, lr=lr, losses=losses,
         k3_launches_per_step=per_step, step_ms=step_ms,
         db_max_abs_err=err, db_max_abs=scale,
         tolerance=f"{PLAIN_TOL}*max|dB| (f32 sums in another order)",
         gpu=gpu, power_limit=card.split(",")[-1].strip())
    for name in counters:
        check(launches[name] > 0, f"{name} launched in the parallel window")
    return {"launches": launches, "times": times, "step_ms": step_ms}


def run_main(main_fn, argv) -> tuple:
    """(exit status, stdout, stderr, seconds) of a module's ``main(argv)``
    run in this process."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        status = main_fn(argv)
    return status, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def read_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{")]


def sweeps_phase(out_dir: str, gpu: str, card: str) -> dict:
    """Phase 10b: the reference's benchmark harness (``tpuspmm_torch.native``,
    ``.tools``, ``.sweeps``, the pruned-MLP example) on the card: the corpus
    sweep on SWEEP_DIRS with f32 B, the sparsity sweep at SWEEP_DENSITIES.
    Records go to ``out_dir``.  Returns the launch counts of the sweep
    window."""
    from tpuspmm_torch import native
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.examples import pruned_mlp
    from tpuspmm_torch.formats import CSR, tiles
    from tpuspmm_torch.native import fastio, tileplan
    from tpuspmm_torch.sweeps import (pruned_llm, summarize, sweep_formats,
                                      sweep_sparsity)
    from tpuspmm_torch.sweeps.common import hand_kernels
    from tpuspmm_torch.tools import convert_mtx, gen_sparse, validate

    t_phase = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    power = card.split(",")[-1].strip()

    # ---- native: both host libraries, the plan builder against numpy ----
    for lib in (fastio.LIBRARY, tileplan.LIBRARY):
        check(lib.available(), f"{os.path.basename(lib.source)} builds and "
                               f"loads on this host ({lib.error})")
    base = CSR.random(SWEEP_SHAPE[0], SWEEP_SHAPE[1], 0.9, seed=0, lo=-1.0,
                      hi=1.0)
    coo = base.to_coo()
    args = (coo.rows, coo.cols, coo.values, coo.shape)
    t0 = time.perf_counter()
    plan_native = tiles.build_tile_plan(*args)
    native_s = time.perf_counter() - t0
    with mock.patch.object(tiles, "NATIVE_MIN_NNZ", coo.nnz + 1):
        t0 = time.perf_counter()
        plan_numpy = tiles.build_tile_plan(*args)
        numpy_s = time.perf_counter() - t0
    for f in ("rt", "kt", "first", "rows", "cols", "vals"):
        x, y = getattr(plan_native, f), getattr(plan_numpy, f)
        check(x.dtype == y.dtype and np.array_equal(x, y),
              f"native tile plan's {f} equals numpy's")
    mtx = os.path.join(data_dir(HEADLINE), "n4c6-b13.mtx")
    t0 = time.perf_counter()
    shape, r, c, v = fastio.read_mtx_triplets(mtx)
    mtx_native_s = time.perf_counter() - t0
    import scipy.io

    t0 = time.perf_counter()
    ref = scipy.io.mmread(mtx)
    mtx_scipy_s = time.perf_counter() - t0
    check(shape == ref.shape and np.array_equal(r, ref.row)
          and np.array_equal(c, ref.col)
          and np.array_equal(v, ref.data.astype(np.float64)),
          f"native .mtx triplets equal scipy's on {HEADLINE}")
    emit("sweeps_native", libraries=[
        os.path.relpath(lib.library_path(), REPO)
        for lib in (fastio.LIBRARY, tileplan.LIBRARY)],
        flags=" ".join(fastio.LIBRARY.flags), nnz=coo.nnz,
        tile_plan_native_s=native_s, tile_plan_numpy_s=numpy_s,
        mtx_native_s=mtx_native_s, mtx_scipy_s=mtx_scipy_s,
        host_cpu=platform.processor() or platform.machine(),
        host_cores=os.cpu_count())
    del base, coo, plan_native, plan_numpy

    # ---- tools: generate, convert, validate -----------------------------
    t0 = time.perf_counter()
    tools_dir = os.path.join(out_dir, "tools")
    shutil.rmtree(tools_dir, ignore_errors=True)
    sp_dir = gen_sparse.gen_dir(tools_dir, 0.05, 512, 512, 64, seed=0)
    mtx_dir = os.path.join(tools_dir, "small_32x32")
    os.makedirs(mtx_dir)
    src = data_dir("small_32x32")
    for name in ("Hamrle1.mtx", "dense.mtx"):
        shutil.copy(os.path.join(src, name), mtx_dir)
    written = convert_mtx.convert_dir(mtx_dir)
    failures = {}
    for d in (sp_dir, mtx_dir):
        status, out, err, _ = run_main(validate.main,
                                       [d, "--write-expect"])
        failures[os.path.basename(d)] = status
        check(status == 0, f"validate {d}: {out[-500:]} {err[-500:]}")
    golden = np.loadtxt(os.path.join(src, "result.expect"))
    mine = np.loadtxt(os.path.join(mtx_dir, "result.expect"))
    check(np.allclose(mine, golden, rtol=1e-2, atol=1e-3),
          "the converted small_32x32's result.expect agrees with the "
          "committed golden")
    emit("sweeps_tools", seconds=time.perf_counter() - t0,
         converted=[os.path.basename(w) for w in written],
         validate_status=failures)

    # ---- the sweeps, in one launch window --------------------------------
    counters = hand_kernels()
    for counter in counters.values():
        counter.launches = 0
    native.plan_builds.update(native=0, numpy=0)
    runs = []

    def run(tag, main_fn, argv):
        status, out, err, secs = run_main(main_fn, argv)
        tail = err.strip().splitlines()[-1:] if err.strip() else []
        runs.append({"run": tag, "status": status, "seconds": secs,
                     "stderr_tail": tail})
        emit("sweeps_run", run=tag, status=status, seconds=secs,
             stderr_tail=tail)
        if status != 0:
            print(err[-3000:], file=sys.stderr, flush=True)
        return out

    formats_path = os.path.join(out_dir, "formats.jsonl")
    sparsity_path = os.path.join(out_dir, "sparsity.jsonl")
    llm_path = os.path.join(out_dir, "pruned_llm.jsonl")
    for p in (formats_path, sparsity_path, llm_path):
        open(p, "w").close()
    run("sweep_formats f32", sweep_formats.main,
        ["--dirs", ",".join(SWEEP_DIRS), "--formats", "csr,coo,bsr,ell",
         "--skip-seq", "--repeats", "3", "--retries", "0", "--out",
         formats_path])
    run("sweep_sparsity f32", sweep_sparsity.main,
        ["--densities", SWEEP_DENSITIES, "--skip-seq", "--repeats", "3",
         "--out", sparsity_path])
    for block, sparsities in ((4, "0.8,0.9,0.95"), (128, "0.9")):
        for dtype in ("f32", "bf16"):
            out = run(f"pruned_llm --block {block} {dtype}", pruned_llm.main,
                      ["--block", str(block), "--block-sparsity", sparsities,
                       "--b-dtype", dtype])
            with open(llm_path, "a") as f:
                f.write(out.strip().splitlines()[-1] + "\n")
    for dtype in ("f32", "bf16"):
        run(f"pruned_mlp {dtype}", pruned_mlp.main,
            ["--activations-dtype", dtype])
    t0 = time.perf_counter()
    sharded = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "tpuspmm_torch.examples.pruned_mlp",
         "--sharded"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    runs.append({"run": "pruned_mlp --sharded (torch.distributed.run)",
                 "status": sharded.returncode,
                 "seconds": time.perf_counter() - t0})
    emit("sweeps_run", **runs[-1], stdout=sharded.stdout.splitlines()[-2:])
    if sharded.returncode != 0:
        print(sharded.stderr[-3000:], file=sys.stderr, flush=True)
    launches = {n: c.launches for n, c in counters.items()}
    plan_builds = dict(native.plan_builds)

    # ---- checks over the records, and the summary ------------------------
    # every run exits 0: no failed record, no faulted group, the examples
    # at the gate (they exit 1 when they miss it)
    check(all(r["status"] == 0 for r in runs), "every sweep run exits 0 "
          f"({[(r['run'], r['status']) for r in runs]})")
    formats = read_records(formats_path)
    sparsity = read_records(sparsity_path)
    llm = read_records(llm_path)
    for rec in formats + sparsity:
        what = f"{rec['testcase']} {rec['format']} {rec['kernelName']}"
        check("error" not in rec and "device_fault" not in rec,
              f"{what}: no error record ({rec.get('error')})")
        check(rec.get("skipped") == "inadmissible"
              or rec["correct"] == "1" or rec.get("verifiedOnly") == "1",
              f"{what} passes the gate")
    for line in llm:
        for rec in line["results"]:
            check("error" not in rec, f"pruned_llm {rec}")
            check(rec.get("skipped") == "inadmissible" or rec["correct"]
                  or rec.get("verifiedOnly") == "1",
                  f"pruned_llm block {line['block']} {line['bDtype']} "
                  f"{rec['variant']} passes the gate")
    k6_runs = [rec for line in llm if line["block"] == 128
               for rec in line["results"]
               if rec["variant"] == "pallas_block_stream"]
    check(k6_runs and all(r["blockStream"] == "k6" and r["launched"] == {
        "bsr_stream": 1} for r in k6_runs),
        f"the 128 x 128 pruned weight's block stream is K6 ({k6_runs})")
    check(plan_builds["native"] > 0 and plan_builds["numpy"] == 0,
          f"every tile plan of {tiles.NATIVE_MIN_NNZ} nonzeros or more in "
          f"the sweeps was built natively ({plan_builds})")
    for name in ("panel", "tile", "cres", "bsr_stream"):
        check(launches[name] > 0, f"{name} launched in the sweeps")

    def best_hand(recs):
        ok = [r for r in recs if r.get("correct") == "1"
              and r["kernelName"].startswith("pallas_")]
        return min(ok, key=lambda r: r["cudaKernelTimeMs"]) if ok else None

    groups = {}
    for rec in formats + sparsity:
        groups.setdefault((rec["testcase"], rec["format"], rec["bDtype"]),
                          []).append(rec)
    versus = []
    for (tc, fmt, dtype), recs in sorted(groups.items()):
        best = best_hand(recs)
        vendor = next((r for r in recs if r["kernelType"] == "-1"
                       and r.get("correct") == "1"), None)
        versus.append({
            "testcase": tc, "format": fmt, "b_dtype": dtype,
            "best_hand": best and best["kernelName"],
            "best_hand_ms": best and best["cudaKernelTimeMs"],
            "cusparse_ms": vendor and vendor["cudaKernelTimeMs"]})
    table = io.StringIO()
    with contextlib.redirect_stdout(table), \
            contextlib.redirect_stderr(io.StringIO()):
        status = summarize.main([formats_path, sparsity_path])
    with open(os.path.join(out_dir, "summary.md"), "w") as f:
        f.write(f"{card}\n\n{table.getvalue()}")
    check(status == 0, "summarize finds no incorrect record")
    emit("sweeps", seconds=time.perf_counter() - t_phase,
         gpu=gpu, power_limit=power, runs=runs, launches=launches,
         native_plan_builds=plan_builds, best_hand_vs_cusparse=versus,
         records={"formats": len(formats), "sparsity": len(sparsity),
                  "pruned_llm": sum(len(x["results"]) for x in llm)},
         out_dir=os.path.relpath(out_dir, REPO))
    return launches


def tools_phase(gpu: str, card: str) -> dict:
    """Phase 10c: the reference's last tools on the card, in one launch
    window: ``entry()``'s raw K1 launch, ``profile_variants`` on
    TOOLS_PROFILE, ``hbm_control`` and ``weak_scaling --devices 1`` with
    the tile and panel locals.  Returns the window's launches and the
    entry's and stream's numbers for the kernels line."""
    from tpuspmm_torch import entry as port_entry
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.formats import CSR
    from tpuspmm_torch.kernels import stream_cuda
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.sweeps.common import hand_kernels
    from tpuspmm_torch.tools import hbm_control, profile_variants, weak_scaling
    from tpuspmm_torch.utils.compare import allclose, max_abs_err
    from tpuspmm_torch.utils.timing import cuda_time_ms, graph_time_ms

    t_phase = time.perf_counter()
    power = card.split(",")[-1].strip()
    counters = dict(hand_kernels(), stream=stream_cuda.stream)
    for c in counters.values():
        c.launches = 0
    port_entry.PanelLaunch.launches = 0

    # ---- entry(): the raw K1 launch, against plain and the oracle --------
    fn, args = port_entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    entry_launches = port_entry.PanelLaunch.launches
    check(entry_launches == 1 and counters["panel"].launches == 0,
          "entry()'s fn launches K1 once, not through spmm_panel")
    want = fn.plain(*args)
    err = max_abs_err(out, want)
    scale = float(want.abs().max())
    check(out.shape == want.shape and bool(torch.isfinite(out).all()),
          f"entry output finite, shape {tuple(want.shape)}")
    check(err <= PLAIN_TOL * scale,
          f"entry |kernel - plain| {err} <= {PLAIN_TOL}*{scale}")
    a = CSR.random(1024, 1024, density=0.10, seed=0)
    b = np.random.default_rng(1).standard_normal((1024, 256)).astype(
        np.float32)
    plan = fn.plan
    gate = allclose(out[:a.shape[0], :b.shape[1]], oracle.spmm_oracle(a, b))
    check(gate, "entry gate vs f64 oracle")
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + out.numel() * 4
    entry_stats = {
        "max_abs_err": err, "max_abs_c": scale, "gate": gate,
        "ms": cuda_time_ms(lambda: fn(*args)),
        "device_ms": graph_time_ms(lambda: fn(*args)),
        "plain_ms": cuda_time_ms(lambda: fn.plain(*args)),
        **bound(nbytes, 2.0 * a.nnz * b.shape[1], report.hbm_gbps(gpu) * 1e9)}
    emit("tools_entry", gpu=gpu, power_limit=power, launches=entry_launches,
         geometry={"tm": plan.tm, "tk": plan.tk, "P": plan.panel_strips,
                   "sm": plan.sm, "panels": plan.n_panels},
         **entry_stats)
    del out, want

    # ---- profile_variants: device time split from host time --------------
    runs = []
    for argv in TOOLS_PROFILE:
        status, stdout, err_text, secs = run_main(
            profile_variants.main, [*argv, "--repeats", "20"])
        line = json.loads(stdout.strip().splitlines()[-1])
        emit("profile_variants", seconds=secs, status=status, **line)
        check(status == 0, f"profile_variants {argv} exits 0 "
                           f"({err_text[-1500:]})")
        for r in line["results"]:
            what = f"profile_variants {line['testcase']} {r['variant']}"
            check("error" not in r, f"{what}: no error ({r.get('error')})")
            check("inadmissible" in r or r["correct"] is True,
                  f"{what} at the gate")
            if r["variant"].startswith("pallas_") and "inadmissible" not in r:
                check(r["device_ms"] is not None, f"{what} has a device_ms")
        runs.append(line)

    # ---- hbm_control: the card's measured ceilings -----------------------
    status, stdout, err_text, secs = run_main(hbm_control.main, [])
    hbm = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    for rec in hbm:
        emit("hbm_control", **rec)
    check(status == 0 and [r["control"] for r in hbm] == [
        "stream", "matmul_sol", "matmul_pair"],
        f"hbm_control exits 0 with three records ({err_text[-1500:]})")
    check(hbm[0]["equal_to_plain"], "the stream kernel equals 2 * x + 1")
    for rec in hbm:
        check(rec["frac_of_nominal"] <= 1.05,
              f"{rec['control']}: frac_of_nominal {rec['frac_of_nominal']} "
              "<= 1.05")

    # ---- weak_scaling at one rank -----------------------------------------
    weak = {}
    for local in ("tile", "panel"):
        status, stdout, err_text, secs = run_main(
            weak_scaling.main, ["--devices", "1", "--local", local])
        line = json.loads(stdout.strip().splitlines()[-1])
        emit("weak_scaling", seconds=secs, status=status, **line)
        check(status == 0 and len(line["scaling"]) == 1
              and line["scaling"][0]["correct"] and line["dropped"] == [],
              f"weak_scaling --local {local} at one rank at the gate "
              f"({err_text[-1500:]})")
        weak[local] = line["scaling"][0]

    launches = {n: c.launches for n, c in counters.items()}
    for rec in weak.values():  # the ranks' launches, in their processes
        for name, count in rec["launches"].items():
            launches[name] += count
    launches["entry_panel"] = entry_launches
    for name in ("tile", "staged", "cres", "panel", "stream"):
        check(launches[name] > 0, f"{name} launched in the tools phase")
    stream_rec = hbm[0]
    emit("tools_phase", seconds=time.perf_counter() - t_phase,
         launches=launches)
    return {"launches": launches, "entry": entry_stats,
            "stream": stream_rec, "hbm": hbm, "profile": runs,
            "weak": weak}


def routing_row_phase(gpu: str, card: str) -> None:
    """Phase 10d: the priced dispatcher on ROUTING_OPERANDS.  Each is
    served by ``tpuspmm_torch.spmm`` under the row: the route it took
    must be the one ``dispatch.route`` names, the least of
    ``dispatch.route_costs`` (the serve-time model, µs), and must pass the
    gate against an f64 product; its serve time (``ms``, CUDA events) and
    device time (``device_ms``, graph replay).  Then every admitted route
    (``tools/fit_routing.py``'s routes record: each pinned by the row,
    served, gated and timed) beside its modelled µs, the route JAX's
    fixed order takes, and the chosen route's regret (its time over the
    fastest route's): reported, not required."""
    import tpuspmm_torch
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import dispatch
    from tpuspmm_torch.tools import fit_routing as fr
    from tpuspmm_torch.utils.compare import allclose
    from tpuspmm_torch.utils.timing import cuda_time_ms, graph_time_ms

    t_phase = time.perf_counter()
    power = card.split(",")[-1].strip()
    meas = fr.Measurer("cuda", lambda fn: cuda_time_ms(fn, warmup=3,
                                                       iters=fr.SERVES),
                       graph=True, card=card)
    for name, dtypes, width in ROUTING_OPERANDS:
        if name.startswith("pruned_"):
            block, s = name[len("pruned_"):].split("_s")
            a = fr.pruned(int(block.split("x")[0]), float(s))
            b_np = fr.b_pruned(a.shape[1], width)
        elif name.startswith("uniform_"):
            n, d = name[len("uniform_"):].split("_d")
            a = fr.uniform(int(n), float(d))
            b_np = fr.b_uniform(int(n), width)
        else:
            a = convert.load_sparse(data_dir(name), "csr")
            b_np = np.asarray(convert.load_dense(
                data_dir(name), width=width).data, np.float32)
        for dtype in dtypes:
            b = torch.from_numpy(b_np).cuda().to(fr.B_DTYPES[dtype])
            costs = dispatch.route_costs(a, b)
            route = dispatch.route(a, b)
            check(route == dispatch.cheapest(costs),
                  f"{name} {dtype}: {route} is the least modelled time")
            out, served = fr.served_route(lambda: tpuspmm_torch.spmm(a, b))
            gate = allclose(out, fr.reference(a, b))
            check(served == route, f"{name} {dtype}: spmm served {served}, "
                                   f"dispatch.route names {route}")
            check(gate, f"{name} {dtype}: served {route} at the gate")
            del out
            ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(a, b))
            dev_ms = graph_time_ms(lambda: tpuspmm_torch.spmm(a, b))
            rec = fr.routes_record(meas, "phase", name, a, b_np, dtype,
                                   rounds=1)
            routes = {kind: {"modelled_us": costs.get(kind), "ms": x["ms"],
                             "device_ms": x["device_ms"], "gate": x["gate"]}
                      for kind, x in rec["routes"].items()}
            emit("routing_row", operand=name, b_dtype=dtype,
                 width=int(b.shape[1]), served=route, ms=ms,
                 device_ms=dev_ms, gate=gate, routes=routes,
                 jax_order=fr.jax_route(rec),
                 regret=fr.route_regret(rec, route),
                 gpu=gpu, power_limit=power)
            del b
        del a
        torch.cuda.empty_cache()
    emit("routing_row_phase", seconds=time.perf_counter() - t_phase)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.environ["TPUSPMM_TORCH_TUNE_CACHE"] = os.path.join(CACHE_DIR,
                                                          "tune.json")
    os.environ["TPUSPMM_TORCH_GEOM_CACHE"] = os.path.join(CACHE_DIR,
                                                          "geom.json")
    # no earlier run's rankings or pinned geometries: every phase before
    # the tuned one serves the model's picks
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    import tpuspmm_torch
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.config import Config
    from tpuspmm_torch import cli
    from tpuspmm_torch.engine import autotune
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.formats import tiles
    from tpuspmm_torch.formats import BSR, COO, CSR
    from tpuspmm_torch.formats import io as fio
    from tpuspmm_torch.kernels import (bsr_cuda, bsr_spmm, chunk_cuda,
                                       cres_spmm, csr_vmem, cuda_build,
                                       dispatch, pair_spmm, panel_spmm,
                                       strip_cuda, tile_spmm)
    from tpuspmm_torch.kernels.common import round_up, split_bf16
    from tpuspmm_torch.ops import exact, oracle, vendor
    from tpuspmm_torch.tools import fit_routing
    from tpuspmm_torch.utils import profiling, timing
    from tpuspmm_torch.utils.compare import allclose, max_abs_err
    from tpuspmm_torch.utils.timing import card_line, cuda_time_ms
    # device time: the call replayed in a CUDA graph, its host work hidden
    from tpuspmm_torch.utils.timing import graph_time_ms as device_ms

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
    from tpuspmm_torch.native import fastio, tileplan

    from tpuspmm_torch.kernels import stream_cuda

    libraries = (strip_cuda.LIBRARY, chunk_cuda.LIBRARY, bsr_cuda.LIBRARY,
                 stream_cuda.LIBRARY)
    host_libraries = (fastio.LIBRARY, tileplan.LIBRARY)
    with ThreadPoolExecutor(len(libraries) + len(host_libraries)) as pool:
        list(pool.map(lambda lib: lib.build(), libraries + host_libraries))
    for lib in libraries + host_libraries:
        lib.load()
    # the strip routine must run its products on the tensor cores; ptxas's
    # report (kept beside the library, so a cached build has it too) must
    # give registers and spills of every kernel in its SASS
    strip_tc, strip_kernels = tensor_core_ops(
        strip_cuda.LIBRARY.library_path())
    strip_ptxas = ptxas_report(strip_cuda.LIBRARY.build_log())
    # so must the tile-owner routine's dense path, with no spills, and two
    # of its blocks must fit an SM
    chunk_tc, chunk_kernels = tensor_core_ops(
        chunk_cuda.LIBRARY.library_path())
    chunk_ptxas = ptxas_report(chunk_cuda.LIBRARY.build_log())
    bsr_tc, bsr_kernels = tensor_core_ops(bsr_cuda.LIBRARY.library_path())
    bsr_ptxas = ptxas_report(bsr_cuda.LIBRARY.build_log())
    stream_ptxas = ptxas_report(stream_cuda.LIBRARY.build_log())
    chunk_occupancy = {
        f"{'bf16' if bb else 'f32'}_B_tn{128 if wide else 64}_"
        f"{'split2' if s2 else 'split'}": chunk_cuda.blocks_per_sm(bb, wide,
                                                                  s2)
        for bb in (False, True) for wide in (False, True)
        for s2 in (False, True)}
    # the C-resident cluster launch: clusters of chunk_cuda.CLUSTER blocks
    # the card holds at once (cudaOccupancyMaxActiveClusters)
    cluster_occupancy = {
        f"{'bf16' if bb else 'f32'}_B_tn{128 if wide else 64}_"
        f"{'split2' if s2 else 'split'}": chunk_cuda.max_active_clusters(
            bb, wide, s2)
        for bb in (False, True) for wide in (False, True)
        for s2 in (False, True)}
    emit("build", sources=[os.path.relpath(lib.source, REPO)
                           for lib in libraries + host_libraries],
         seconds=time.perf_counter() - t0,
         flags=" ".join(cuda_build.NVCC_FLAGS),
         strip_tensor_core_sass=strip_tc, strip_ptxas=strip_ptxas,
         chunk_tensor_core_sass=chunk_tc, chunk_ptxas=chunk_ptxas,
         chunk_blocks_per_sm=chunk_occupancy,
         cres_cluster=chunk_cuda.CLUSTER,
         cres_max_active_clusters=cluster_occupancy,
         bsr_tensor_core_sass=bsr_tc, bsr_ptxas=bsr_ptxas,
         stream_ptxas=stream_ptxas)
    for name, tc_ops, kernels, report_ in (
            ("strip_spmm.cu", strip_tc, strip_kernels, strip_ptxas),
            ("chunk_spmm.cu", chunk_tc, chunk_kernels, chunk_ptxas),
            ("bsr_spmm.cu", bsr_tc, bsr_kernels, bsr_ptxas)):
        check(tc_ops["HMMA"] + tc_ops["HGMMA"] > 0,
              f"{name} has tensor-core instructions ({tc_ops})")
        reported = {r["kernel"] for r in report_
                    if r["spill_store_bytes"] is not None}
        check(kernels and kernels <= reported,
              f"ptxas reports registers and spills of every kernel of "
              f"{name} ({len(reported)} of {len(kernels)})")
    check(all(r["spill_store_bytes"] == 0 for r in chunk_ptxas),
          f"no chunk_spmm.cu kernel spills ({chunk_ptxas})")
    check(bsr_tc["HGMMA"] > 0, f"K6 runs wgmma (HGMMA in its SASS: {bsr_tc})")
    check(all(r["spill_store_bytes"] == 0 for r in bsr_ptxas),
          f"no bsr_spmm.cu kernel spills ({bsr_ptxas})")
    serialised = [line for line in bsr_cuda.LIBRARY.build_log().splitlines()
                  if "C7514" in line or "Performance Loss" in line]
    check(not serialised, f"ptxas serialises no K6 wgmma ({serialised})")
    check(stream_ptxas and all(r["spill_store_bytes"] == 0
                               for r in stream_ptxas),
          f"the stream kernel builds without spills ({stream_ptxas})")
    check(min(chunk_occupancy.values()) >= 2,
          f"two tile-owner blocks fit an SM ({chunk_occupancy})")
    check(min(cluster_occupancy.values()) >= 1,
          f"a cluster of {chunk_cuda.CLUSTER} C-resident blocks fits the "
          f"card ({cluster_occupancy})")

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
        """Two kernel launches, bit-identical, against the plain version
        on the same plan; launches made here are reset by the caller's
        window."""
        fn, plain = entries[name]
        before = fn.launches
        got = fn(plan, b, mode)
        again = fn(plan, b, mode)
        torch.cuda.synchronize()
        check(fn.launches == before + 2, f"{name} launch counter rose")
        check(torch.equal(got, again), f"{name} {mode} two launches give "
                                       "bit-identical output")
        del again
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
            out["device_ms"] = device_ms(lambda: fn(plan, b, mode))
            out["plain_ms"] = cuda_time_ms(lambda: plain(plan, b, mode))
        return out

    def split2_control(name, f32_tier_out, split2_plain) -> dict:
        """With an f32 operand the f32-tier output differs from the split2
        plain by more than SPLIT2_TOL·max|C|: that tolerance tells the
        tiers apart, so a kernel ignoring "split2" would fail it."""
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
              "model's costs use the constants fitted on the H100 "
              "(kernels/dispatch.py)")
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
            stats[name][f"device_ms_{tag}"] = r["device_ms"]
            stats[name][f"plain_ms_{tag}"] = r["plain_ms"]
            emit("kernel_vs_plain", kernel=name, testcase=HEADLINE,
                 b_dtype=tag, geometry=geometry(plan),
                 max_abs_err=r["max_abs_err"], max_abs_c=r["max_abs_c"],
                 tolerance=f"{PLAIN_TOL}*max|C| (f32 sums in another order)",
                 gate=gate, ms=r["ms"], device_ms=r["device_ms"],
                 plain_ms=r["plain_ms"],
                 split2={"max_abs_err": r2["max_abs_err"],
                         "max_abs_c": r2["max_abs_c"],
                         "tolerance": f"{SPLIT2_TOL}*max|C|",
                         "control": control})
            del r, r2
    for name, plan in plans.items():
        # the reckoning the dispatcher prices the strip routine by
        stats[name]["work"] = panel_spmm.plan_strip_work(plan, WIDTH)
        emit("strip_work", kernel=name, testcase=HEADLINE,
             **stats[name]["work"])

    # ---- 3b. strip kernel on the geometries the corpus misses -----------
    for (rows, cols, density, tm, tk, sm, permuted, bf16_plan, width, bdt,
         seed) in STRIP_SHAPES:
        rng = np.random.default_rng(seed)
        flat = rng.choice(rows * cols, int(rows * cols * density),
                          replace=False)
        r, c = flat // cols, flat % cols
        v = (rng.integers(-8, 9, len(flat)) if bf16_plan
             else rng.uniform(-1, 1, len(flat))).astype(np.float32)
        perm = (panel_spmm._order_perm(r, c, rows, c // tk, "signature")
                if permuted else None)
        kw = dict(tm=tm, tk=tk, sm=sm, row_perm=perm)
        splans = {"panel": panel_spmm.build_panel_plan(
                      r, c, v, (rows, cols), panel_strips=8, **kw),
                  "pair": pair_spmm.build_pair_plan(
                      r, c, v, (rows, cols), chunk_strips=8, **kw)}
        sb = torch.from_numpy(rng.uniform(-1, 1, (cols, width)).astype(
            np.float32)).to(dev)
        if bdt == "bf16":
            sb = sb.to(torch.bfloat16)
        ref = oracle.spmm_oracle(
            COO(rows=r.astype(np.int32), cols=c.astype(np.int32), values=v,
                shape=(rows, cols)), sb.float().cpu().numpy())
        rec = {"shape": [rows, cols], "nnz": len(flat), "tm": tm, "tk": tk,
               "sm": sm, "permuted": permuted, "width": width,
               "b_dtype": bdt}
        for name, plan in splans.items():
            check((plan.a_dense.dtype == np.uint16) == bf16_plan,
                  f"{name} plan stored as {'bf16' if bf16_plan else 'f32'}")
            r1 = against_plain(name, plan, sb, timed=False)
            r2 = against_plain(name, plan, sb, timed=False, mode="split2")
            gate = allclose(r1["out"], ref)
            check(gate, f"{name} {rec} gate vs f64 oracle")
            if len(flat) == 0:
                check(not r1["out"].any() and not r2["out"].any(),
                      f"{name}: a matrix with no entry gives exact zeros")
            control = (split2_control(name, r1["out"], r2["want"])
                       if len(flat) and (bdt == "f32" or not bf16_plan)
                       else None)
            rec[name] = {"max_abs_err": r1["max_abs_err"],
                         "max_abs_c": r1["max_abs_c"], "gate": gate,
                         "split2_max_abs_err": r2["max_abs_err"],
                         "split2_control": control,
                         "plan_bf16": bf16_plan, "sm": plan.sm}
            del r1, r2
        emit("strip_shapes", **rec,
             tolerance=f"highest {PLAIN_TOL}*max|C|, split2 "
                       f"{SPLIT2_TOL}*max|C|; two launches bit-identical")
        del sb

    # ---- 4. tile-plan kernels against plain versions --------------------
    tile_ops, tile_stats = {}, {}
    tile_entries = {
        "tile": (tile_spmm.spmm_tiles,
                 lambda p, b, m: tile_spmm.spmm_tiles(p, b, mode=m),
                 tile_spmm.tile_spmm_plain),
        "staged": (csr_vmem.spmm_staged,
                   lambda p, b, m: csr_vmem.spmm_staged(p, b, mode=m),
                   lambda p, b, m: csr_vmem.staged_spmm_plain(
                       p, b, *csr_vmem.slab_geometry(p, b.device), m)),
        "cres": (cres_spmm.spmm_cres,
                 lambda p, b, m, **kw: cres_spmm.spmm_cres(p, b, mode=m,
                                                           **kw),
                 lambda p, b, m: cres_spmm.cres_spmm_plain(p, b, m,
                                                           "block8")),
        "cres_kloop": (cres_spmm.spmm_cres_kloop,
                       lambda p, b, m, **kw: cres_spmm.spmm_cres_kloop(
                           p, b, m, **kw),
                       lambda p, b, m: cres_spmm.cres_spmm_plain(p, b, m,
                                                                 "kloop")),
    }
    clustered = ("cres", "cres_kloop")  # the cluster launch
    for counter, *_ in tile_entries.values():
        counter.launches = 0
    hbm = report.hbm_gbps(gpu) * 1e9
    pb32 = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (4096, PRUNED_WIDTH)) * 0.05).astype(np.float32)).to(dev)
    pb16 = pb32.to(torch.bfloat16)
    weights = {name: BSR.random_blocks(*args) for name, args in PRUNED.items()}

    pruned_csr = CSR.from_scipy(weights["a"].to_scipy().tocsr())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def tile_operand(name, width):
        """(CSR container, f32 B on the card, f64 oracle of f32 B).  B of
        weight (a) is pb32's first columns, or drawn as it is; the
        headline's B is b32's first columns; the 2048 x 2048 operand and
        its B are drawn as profile_variants' ``--random``."""
        if name == "pruned_a":
            ob = (pb32[:, :width].contiguous() if width <= PRUNED_WIDTH
                  else torch.from_numpy((np.random.default_rng(0)
                                         .standard_normal((4096, width))
                                         * 0.05).astype(np.float32)).to(dev))
            return (pruned_csr, ob,
                    oracle.spmm_scipy_oracle(pruned_csr, ob.cpu().numpy()))
        if name == "random_2048":
            ca = CSR.random(2048, 2048, 0.1, seed=0)
            ob = torch.from_numpy(np.random.default_rng(1).uniform(
                -1, 1, (2048, width)).astype(np.float32)).to(dev)
            return ca, ob, oracle.spmm_scipy_oracle(ca, ob.cpu().numpy())
        if name == HEADLINE:
            check(width <= b32.shape[1], f"{HEADLINE} B has {width} columns")
            return (a, b32[:, :width].contiguous(),
                    refs[torch.float32][:, :width])
        ca = convert.load_sparse(data_dir(name), "csr")
        cd = convert.load_dense(data_dir(name), width=width)
        return (ca, torch.from_numpy(cd.data).to(dev),
                oracle.spmm_scipy_oracle(ca, cd.data))

    for op_name, width, dtypes, tm, tk in TILE_OPERANDS:
        ca, ob32, oref = tile_operand(op_name, width)
        headline = (op_name, width, tm, tk) == (HEADLINE, WIDTH, 128, 128)
        tplan = tiles.plan_from_container(ca, tile_m=tm, tile_k=tk)
        index = tile_spmm.host_index(tplan, tile_spmm.dense_min(tk, False))
        blk = cres_spmm._kmajor_blocks(tplan)
        num_slabs, slab_k = csr_vmem.slab_geometry(tplan, dev)
        n_op = int(ob32.shape[1])
        # the routine's column tile for this grid: 128 unless fewer blocks
        # than SMs
        column_tile = chunk_cuda.column_tile(tplan.num_row_tiles, n_op, sms)
        # the dense tiles' tensor-core products (16-row tiles, tk deep, n
        # wide; 6 bf16 products a pair with f32 B, 3 with bf16) at the bf16
        # rate; the dense product (cuBLAS, f32, TF32 off) where A fits
        tc_flop = (2.0 * index["d_a"].shape[0] * index["d_a"].shape[1] * tk
                   * n_op)
        dense_a = (torch.from_numpy(ca.to_scipy().toarray()).to(dev)
                   if ca.shape[0] * ca.shape[1] <= 1 << 26 else None)
        op = {"operand": op_name, "width": n_op, "tile_m": tm, "tile_k": tk,
              "column_tile": column_tile,
              "tc_floor_ms": 6 * tc_flop / BF16_PEAK_FLOPS * 1e3,
              "tc_floor_ms_bf16": 3 * tc_flop / BF16_PEAK_FLOPS * 1e3,
              "cublas_dense_ms": (cuda_time_ms(lambda: dense_a @ ob32)
                                  if dense_a is not None else None),
              "nnz": int(ca.nnz), "chunks": tplan.num_chunks,
              "tiles": len(index["tile_nnz"]),
              "dense_tiles": int(index["tile_dense"].sum()),
              "gathered_nnz": int(index["g_val"].size),
              "sentinel_slot_share": float((tplan.rows < 0).mean()),
              "block8_sentinel_chunk_share": float((blk["rt8"] < 0).mean()),
              "num_slabs": num_slabs, "slab_k": slab_k,
              "residency": {"staged": csr_vmem.residency(tplan, dev),
                            "cres": cres_spmm.residency(tplan, dev)},
              "cusparse_ms": cuda_time_ms(
                  lambda: vendor.spmm_vendor(ca, ob32)),
              **bound(report.spmm_min_bytes(ca.nnz, *ca.shape, n_op),
                      report.spmm_flops(ca.nnz, n_op), hbm)}
        del dense_a
        emit("tile_plan", **op)
        tile_ops[op_name, n_op, tm, tk] = op
        for tag in dtypes:
            b = ob32 if tag == "f32" else ob32.to(torch.bfloat16)
            ref = (oref if tag == "f32" else oracle.spmm_scipy_oracle(
                ca, b.float().cpu().numpy()))
            # every launch runs at full width, the build the timed run
            # takes; its first ncmp columns (all of them up to WIDTH, else
            # 128: the columns are independent) are held to the plain
            # version on the same columns of B
            ncmp = n_op if n_op <= WIDTH else 128
            b_cmp = b if ncmp == n_op else b[:, :ncmp].contiguous()
            k3_out = {}
            for name, (counter, fn, plain) in tile_entries.items():
                rec = {"testcase": op_name, "kernel": name, "b_dtype": tag,
                       "width": n_op, "tile_m": tm, "tile_k": tk,
                       "column_tile": column_tile,
                       "dense_tiles": op["dense_tiles"],
                       "compared_columns": ncmp}
                before = counter.launches
                kw = ({"issues": torch.zeros(1, dtype=torch.int32,
                                             device=dev)}
                      if name in clustered else {})
                got = fn(tplan, b, "split", **kw)
                again = fn(tplan, b, "split")
                torch.cuda.synchronize()
                check(counter.launches == before + 2,
                      f"{name} launch counter rose")
                if kw:
                    # each dense B chunk issued once per cluster: the
                    # device's count is the schedule's, and fewer chunks
                    # are staged than by the owners wherever members share
                    # a k-tile and B is bulk copied
                    traffic = cres_spmm.b_traffic(
                        tplan, b, tile_spmm.dense_min(tk, False), sms)
                    rec.update(traffic)
                    rec["multicast_issues"] = int(kw["issues"].item())
                    check(rec["multicast_issues"]
                          == traffic["multicast_issues"],
                          f"{name} {op_name} w{n_op} {tag} multicast issues "
                          f"{rec['multicast_issues']} == the schedule's "
                          f"{traffic['multicast_issues']}")
                    if traffic["shared_steps"] and traffic["multicast_issues"]:
                        check(traffic["cluster_stagings"]
                              < traffic["owner_stagings"],
                              f"{name} {op_name} w{n_op} {tag} stages fewer "
                              f"B chunks than the owners ({traffic})")
                    del kw
                check(got.shape == (ca.shape[0], n_op)
                      and bool(torch.isfinite(got).all()),
                      f"{name} {op_name} output finite, shape")
                check(torch.equal(got, again), f"{name} {op_name} {tag} two "
                      "launches give bit-identical output")
                rec["gate"] = allclose(got, ref)
                check(rec["gate"], f"{name} {op_name} {tag} gate vs f64 "
                                   "oracle")
                # one routine and one index on the card: K4, K5a and K5b
                # give K3's bits
                if name == "tile":
                    k3_out["out"] = got
                else:
                    rec["bit_identical_to_tile"] = bool(
                        torch.equal(got, k3_out["out"]))
                    check(rec["bit_identical_to_tile"],
                          f"{name} {op_name} {tag} output equals K3's")
                del again
                for mode in ("split", "split2"):
                    full = got if mode == "split" else fn(tplan, b, mode)
                    want = plain(tplan, b_cmp, mode)
                    torch.cuda.synchronize()
                    err = max_abs_err(full[:, :ncmp], want)
                    scale = float(want.abs().max())
                    tol = plain_tol(mode)
                    check(err <= tol * scale,
                          f"{name} {op_name} w{n_op} {tag} {mode} |kernel - "
                          f"plain| {err} <= {tol}*{scale}")
                    rec[mode] = {"max_abs_err": err, "max_abs_c": scale,
                                 "tolerance": f"{tol}*max|C|"}
                    if mode == "split2" and tag == "f32":
                        rec["split2"]["control"] = split2_control(
                            name, got[:, :ncmp], want)
                    del full, want
                del got
                rec["ms"] = cuda_time_ms(lambda: fn(tplan, b, "split"))
                rec["device_ms"] = device_ms(lambda: fn(tplan, b, "split"))
                if headline:
                    rec["plain_ms"] = cuda_time_ms(
                        lambda: plain(tplan, b, "split"))
                emit("tile_kernel_vs_plain", **rec)
                tile_stats[name, op_name, n_op, tm, tk, tag] = rec
            del k3_out
            if tag == "bf16":
                del b
    # every build of the routine was held to its plain version: each
    # column tile, with and without dense tiles, with f32 and bf16 B
    held = {(r["column_tile"], r["dense_tiles"] > 0, r["b_dtype"])
            for r in tile_stats.values()}
    check(len(held) == 8, f"phase 4 runs every build of the tile-owner "
                          f"routine ({sorted(held)})")
    tile_window = {name: counter.launches
                   for name, (counter, *_) in tile_entries.items()}
    emit("tile_kernel_launches", **tile_window)

    # ---- 4b. block-streaming kernel (K6) against its plain version -------
    weights["c"] = BSR.from_scipy(weights["a"].to_scipy(), (4, 4))
    packed = bsr_spmm.pack_blocks(weights["c"])
    check(packed is not None and packed.block_size == (128, 128)
          and packed.nblocks == weights["a"].nblocks,
          "weight (c) packs back into (a)'s 128 x 128 blocks")
    k6 = bsr_spmm.spmm_bsr_stream
    k6.launches = 0
    k6_stats, k6_refs, staged = {}, {}, set()
    # bf16-B outputs and their operands, for the parent's K6 (--k6-parent)
    k6_bf16 = {}

    def k6_products3(kw, b):
        """The control of K6_TOL: K6's f32-B ladder cut to the products
        (0,0), (0,1) and (1,0) of the same bf16 terms, summed exactly
        (f64) and added into the block rows."""
        nb, bh, bwid = kw.blocks.shape
        n = int(b.shape[1])
        a_t = [t.double() for t in split_bf16(
            torch.from_numpy(kw.blocks).to(dev), 3)]
        kt = torch.from_numpy(kw.indices.astype(np.int64)).to(dev)
        b_t = [t.double().reshape(-1, bwid, n)[kt]
               for t in split_bf16(b, 3)]
        prod = sum(torch.bmm(a_t[i], b_t[j])
                   for i, j in ((0, 0), (0, 1), (1, 0)))
        rows = torch.from_numpy(np.repeat(np.arange(kw.num_block_rows),
                                          np.diff(kw.indptr))).to(dev)
        out = torch.zeros(kw.num_block_rows, bh, n, dtype=torch.float64,
                          device=dev).index_add_(0, rows, prod)
        return out.reshape(-1, n)[:kw.shape[0]]

    def k6_twice(kw, b, what: str):
        """Two K6 launches, bit-identical, held to the plain version:
        (first output, |kernel - plain|, max|C|, and with f32 B the error
        of the control, which must miss K6_TOL).  Records which build
        staged B."""
        before = k6.launches
        got = k6(kw, b)
        again = k6(kw, b)
        torch.cuda.synchronize()
        check(k6.launches == before + 2, f"K6 {what} counter rose by two")
        check(torch.equal(got, again),
              f"K6 {what} two launches give bit-identical output")
        del again
        want = bsr_spmm.bsr_spmm_plain(kw, b)
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"K6 {what} output finite, shape {tuple(want.shape)}")
        err = max_abs_err(got, want)
        scale = float(want.abs().max())
        check(err <= K6_TOL * scale,
              f"K6 {what} |kernel - plain| {err} <= {K6_TOL}*{scale}")
        control = None
        if b.dtype == torch.float32 and kw.nblocks:
            control = max_abs_err(k6_products3(kw, b), want.double())
            check(control > K6_TOL * scale,
                  f"K6 {what} control: three products miss the limit "
                  f"({control} > {K6_TOL}*{scale})")
        staged.add((str(b.dtype), bsr_cuda.vector_staging(b)))
        return got, err, scale, control

    def k6_consumers(kw, b):
        """The warp-specialised build's consumer warpgroups for (kw, b),
        or None where another build takes b."""
        n = int(b.shape[1])
        if not (bsr_cuda.warp_specialised(b.dtype, n)
                and bsr_cuda.vector_staging(b)):
            return None
        bh = kw.block_size[0]
        return bsr_cuda.ws_consumers(
            kw.num_block_rows * (bh // bsr_cuda.row_tile(bh)), n, sms)

    def k6_floors(kw, width: int) -> dict:
        """K6's tensor-core products at the bf16 rate (six a k-step with
        f32 B, three with bf16), for the whole call and for the owner of
        the heaviest block row (its sub-tile x 64 columns) at one SM's
        share of the rate."""
        nb, bh, bwid = kw.blocks.shape
        most = int(np.diff(kw.indptr).max(initial=0))
        rt = bsr_cuda.row_tile(bh)
        out = {"most_blocks_in_a_row": most}
        for sfx, products in (("", 6), ("_bf16", 3)):
            out[f"tc_floor_ms{sfx}"] = (2.0 * nb * bh * bwid * width
                                        * products / BF16_PEAK_FLOPS * 1e3)
            out[f"heaviest_row_floor_ms{sfx}"] = (
                2.0 * most * rt * bwid * bsr_cuda.COLUMN_TILE * products
                / (BF16_PEAK_FLOPS / sms) * 1e3)
        return out

    k6_b = {PRUNED_WIDTH: pb32,
            1024: torch.from_numpy((np.random.default_rng(0).standard_normal(
                (4096, 1024)) * 0.05).astype(np.float32)).to(dev)}
    for wname, width in K6_OPERANDS:
        w = weights[wname]
        kw = packed if wname == "c" else w
        key = wname if width == PRUNED_WIDTH else f"{wname}_w{width}"
        _, bh, bwid = kw.blocks.shape
        rec = {"block_size": list(w.block_size), "nblocks": w.nblocks,
               "stored_nnz": w.nnz, "kernel_block_size": [bh, bwid],
               "kernel_nblocks": kw.nblocks, "width": width,
               "empty_block_rows": int((np.diff(kw.indptr) == 0).sum()),
               "tolerance": f"{K6_TOL}*max|C| (f32 sums in another "
                            "order; three products miss it)",
               **k6_floors(kw, width)}
        wb32 = k6_b[width]
        for b in (wb32, pb16 if width == PRUNED_WIDTH
                  else wb32.to(torch.bfloat16)):
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            got, err, scale, control = k6_twice(kw, b, f"({key}, {tag})")
            if tag == "bf16":
                k6_bf16[key] = (kw, b, got.cpu())
            ref = oracle.spmm_oracle(w, b.float().cpu().numpy())
            if width == PRUNED_WIDTH:
                k6_refs[wname, tag] = ref
            gate = allclose(got, ref)
            check(gate, f"K6 ({key}, {tag}) gate vs f64 oracle")
            del got
            rec[tag] = {"max_abs_err": err, "max_abs_c": scale, "gate": gate,
                        "products3_err": control,
                        "vector_staging": bsr_cuda.vector_staging(b),
                        "ws_consumers": k6_consumers(kw, b),
                        "ms": cuda_time_ms(lambda: k6(kw, b)),
                        "device_ms": device_ms(lambda: k6(kw, b)),
                        "plain_ms": cuda_time_ms(
                            lambda: bsr_spmm.bsr_spmm_plain(kw, b))}
        # library calls computing the same function (f32 B); the port never
        # calls either: cuSPARSE CSR through torch.sparse, and PyTorch's BSR
        # product on the stored blocks where it takes their shape
        rec["cusparse_csr_ms"] = cuda_time_ms(
            lambda: vendor.spmm_vendor(w, wb32))
        try:
            lib = torch.sparse_bsr_tensor(
                torch.from_numpy(w.indptr).long(),
                torch.from_numpy(w.indices).long(),
                torch.from_numpy(w.blocks), size=w.shape).to(dev)
            lib_out = lib @ wb32
            torch.cuda.synchronize()
            rec["torch_bsr_gate"] = allclose(lib_out, oracle.spmm_oracle(
                w, wb32.cpu().numpy()))
            rec["torch_bsr_ms"] = cuda_time_ms(lambda: lib @ wb32)
            del lib, lib_out
        except Exception as e:  # recorded: the yardstick, not the port
            rec["torch_bsr_error"] = f"{type(e).__name__}: {e}"[:300]
        m6, k6_k = kw.shape
        rec.update(bound(
            kw.blocks.size * 4 + (kw.indptr.size + kw.indices.size) * 4
            + k6_k * width * 4 + m6 * width * 4,
            2 * kw.blocks.size * width, hbm))
        emit("bsr_kernel_vs_plain", weight=key, **rec)
        k6_stats[key] = rec
    for rows, cols, block, density, seed, width in K6_SHAPES:
        w = BSR.random_blocks(rows, cols, block, density, seed)
        sb = torch.from_numpy((np.random.default_rng(seed).standard_normal(
            (cols, width)) * 0.05).astype(np.float32)).to(dev)
        rec = {"block_size": list(block), "nblocks": w.nblocks,
               "row_tile": bsr_cuda.row_tile(block[0]),
               "empty_block_rows": int((np.diff(w.indptr) == 0).sum()),
               "shape": [rows, cols], "width": width}
        for b in (sb, sb.to(torch.bfloat16)):
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            got, err, scale, control = k6_twice(w, b,
                                                f"{block} w{width} {tag}")
            if tag == "bf16":
                k6_bf16[f"{block} w{width}"] = (w, b, got.cpu())
            gate = allclose(got, oracle.spmm_oracle(w, b.float().cpu().numpy()))
            check(gate, f"K6 {block} w{width} {tag} gate vs f64 oracle")
            if w.nblocks == 0:
                check(not got.any(), "K6: no stored block gives exact zeros")
            rec[tag] = {"max_abs_err": err, "max_abs_c": scale, "gate": gate,
                        "products3_err": control,
                        "vector_staging": bsr_cuda.vector_staging(b),
                        "ws_consumers": k6_consumers(w, b)}
            del got
        emit("bsr_kernel_shapes", **rec)
    # both builds that stage B were held, with f32 and bf16 B
    check(len(staged) == 4, f"K6 ran both B staging builds in both dtypes "
                            f"({sorted(staged)})")
    if K6_PARENT:
        same = k6_parent_equal(K6_PARENT, k6_bf16)
        emit("bsr_kernel_vs_parent", parent=K6_PARENT, bit_equal=same)
        check(same and all(same.values()),
              f"K6's bf16-B outputs equal the parent's bit for bit ({same})")
    del k6_bf16
    # K6 on Olmo-Hybrid-7B's gate and down weights, as the benchmark draws
    # them, ROTATE weights in turn (the device time is a launch's)
    import strip_sweep
    for wname, rows, cols, block, dens, seed, width in (
            strip_sweep.BSR_CASES[2:]):
        ws = strip_sweep.bsr_weights(wname, rows, cols, block, dens, seed)
        ob32 = torch.from_numpy((np.random.default_rng(seed).standard_normal(
            (cols, width)) * 0.05).astype(np.float32)).to(dev)
        rec = {"weight": wname, "shape": [rows, cols], "width": width,
               "nblocks": ws[0].nblocks, "weights_in_turn": len(ws),
               "most_blocks_in_a_row": int(np.diff(ws[0].indptr).max())}
        for b in (ob32.to(torch.bfloat16), ob32):
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            got = k6(ws[0], b)
            want = bsr_spmm.bsr_spmm_plain(ws[0], b)
            err, scale = max_abs_err(got, want), float(want.abs().max())
            check(err <= K6_TOL * scale,
                  f"K6 {wname} w{width} {tag} |kernel - plain| {err} <= "
                  f"{K6_TOL}*{scale}")
            del got, want
            rec[tag] = {
                "max_abs_err": err, "max_abs_c": scale,
                "ws_consumers": k6_consumers(ws[0], b),
                "ms": cuda_time_ms(lambda: [k6(w, b) for w in ws])
                / len(ws),
                "device_ms": device_ms(lambda: [k6(w, b) for w in ws])
                / len(ws)}
        emit("bsr_kernel_olmo", **rec)
        del ws
    bsr_window = k6.launches
    emit("bsr_kernel_launches", bsr_stream=bsr_window)

    # ---- 5. serving path: tpuspmm_torch.spmm only -----------------------
    serving = {"panel": panel_spmm.spmm_panel, "pair": pair_spmm.spmm_pair,
               **{n: tile_entries[n][0] for n in ("tile", "staged", "cres")}}
    for fn in serving.values():
        fn.launches = 0

    def served_by(call):
        before = {n: fn.launches for n, fn in serving.items()}
        out = call()
        torch.cuda.synchronize()
        ran = [n for n, fn in serving.items() if fn.launches > before[n]]
        check(len(ran) == 1, f"one kernel served the call (got {ran})")
        return out, ran[0]

    def replay_ms(call):
        """The call's device time (graph replay), or None where the route
        cannot be captured (the gather path synchronises)."""
        try:
            return device_ms(call)
        except RuntimeError as e:
            emit("capture_error", error=str(e).splitlines()[0][:200])
            return None

    def modelled_kernel(a, n_pad, config) -> str:
        geom, pgeom = resolved(a, n_pad, config.panel_strips)
        return "pair" if pgeom.cost_us < geom.cost_us else "panel"

    def served_plan(ca, b):
        """The served kernel's plain ms on the plan the dispatcher serves
        from, and that plan's geometry."""
        kernel, plan = dispatch._resolve(ca, b)
        if kernel in entries:
            return (cuda_time_ms(lambda: entries[kernel][1](plan, b)),
                    geometry(plan))
        plain = tile_entries[kernel][2]
        return (cuda_time_ms(lambda: plain(plan, b, Config().precision_mode)),
                {"tile_m": plan.tile_m, "tile_k": plan.tile_k,
                 "chunks": plan.num_chunks})

    vendor_out = vendor.spmm_vendor(a, b32)
    check(allclose(vendor_out, refs[torch.float32]), "vendor gate")
    vendor_ms = cuda_time_ms(lambda: vendor.spmm_vendor(a, b32))
    csr_bound = bound(report.spmm_min_bytes(a.nnz, *a.shape, WIDTH),
                      report.spmm_flops(a.nnz, WIDTH), hbm)
    m, k = a.shape
    flops = report.spmm_flops(a.nnz, WIDTH)
    # the least bytes over the card's data-sheet rate (not the cost model's
    # fitted plan-stream rate, which is no bandwidth of the card)
    sol_s = report.spmm_min_bytes(a.nnz, m, k, WIDTH) / hbm
    # the headline through the priced dispatcher: each B dtype by the
    # route the model prices cheapest (SERVED_ROUTES)
    out32, kernel = served_by(lambda: tpuspmm_torch.spmm(a, b32))
    out16, kernel16 = served_by(lambda: tpuspmm_torch.spmm(a, b16))
    for kname, tb, want in ((kernel, b32, "f32"), (kernel16, b16, "bf16")):
        check(kname == dispatch.route(a, tb)
              == SERVED_ROUTES[HEADLINE, want],
              f"main path {want}: served {kname}, dispatch.route "
              f"{dispatch.route(a, tb)}, expected "
              f"{SERVED_ROUTES[HEADLINE, want]}")
    correct = allclose(out32, refs[torch.float32])
    check(correct, f"main path f32 gate vs f64 oracle ({kernel})")
    bf16_correct = allclose(out16, refs[torch.bfloat16])
    check(bf16_correct, f"main path bf16 gate vs f64 oracle ({kernel16})")
    kernel_ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(a, b32))
    bf16_ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(a, b16))
    # the same serves replayed in a CUDA graph: their device time, beside
    # kernel_ms, which carries the serve's host work as well
    serve_device_ms = device_ms(lambda: tpuspmm_torch.spmm(a, b32))
    bf16_device_ms = device_ms(lambda: tpuspmm_torch.spmm(a, b16))
    plain_ms, geom32 = served_plan(a, b32)
    emit("main_path", **{
        "metric": f"csr_spmm_gflops_{HEADLINE}_w{WIDTH}",
        "kernel": kernel, "bf16_kernel": kernel16,
        "route_costs_us": dispatch.route_costs(a, b32),
        "bf16_route_costs_us": dispatch.route_costs(a, b16),
        "value": flops / (kernel_ms * 1e-3) / 1e9,
        "unit": "GFLOP/s",
        "vs_baseline": vendor_ms / kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": serve_device_ms,
        "plain_ms": plain_ms,
        "vendor_ms": vendor_ms,
        "nnz_per_s": a.nnz / (kernel_ms * 1e-3),
        "hbm_roofline_frac": sol_s / (kernel_ms * 1e-3),
        "correct": correct,
        "bf16_serving_ms": bf16_ms,
        "bf16_device_ms": bf16_device_ms,
        "bf16_serving_correct": bf16_correct,
        "geometry": geom32,
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
              f"{name} is not served by the compensated path")
        b = torch.from_numpy(cdense.data).to(dev)
        ref = oracle.spmm_scipy_oracle(ca, cdense.data)
        # the route the priced dispatcher gives, as the CPU tests pin it
        out, served = served_by(lambda: tpuspmm_torch.spmm(ca, b))
        check(served == dispatch.route(ca, b) == SERVED_ROUTES[name, "f32"],
              f"{name} served {served}, dispatch.route names "
              f"{dispatch.route(ca, b)}, expected "
              f"{SERVED_ROUTES[name, 'f32']}")
        check(allclose(out, ref), f"{name} dispatch gate")
        ms = cuda_time_ms(lambda: tpuspmm_torch.spmm(ca, b))
        serve_device = device_ms(lambda: tpuspmm_torch.spmm(ca, b))
        # the same operand with bf16 B, by the route the model prices
        cb16 = b.to(torch.bfloat16)
        out16, served16 = fit_routing.served_route(
            lambda: tpuspmm_torch.spmm(ca, cb16))
        check(served16 == dispatch.route(ca, cb16)
              == SERVED_ROUTES[name, "bf16"],
              f"{name} bf16 served {served16}, dispatch.route names "
              f"{dispatch.route(ca, cb16)}, expected "
              f"{SERVED_ROUTES[name, 'bf16']}")
        check(allclose(out16, oracle.spmm_scipy_oracle(
            ca, cb16.float().cpu().numpy())), f"{name} bf16 dispatch gate")
        # the library call on the same operand, timed here only
        lib_ms = cuda_time_ms(lambda: vendor.spmm_vendor(ca, b))
        emit("corpus", **report.make_record(
            testcase=name, sparsity=ca.sparsity, fmt="csr", kernel_type=0,
            kernel_name=served, correct=True, kernel_ms=ms, n=b.shape[1],
            device=gpu, extra={
                "bSource": cdense.b_source, "device_ms": serve_device,
                "bf16_kernel": served16,
                "bf16_kernel_ms": cuda_time_ms(
                    lambda: tpuspmm_torch.spmm(ca, cb16)),
                "bf16_device_ms": replay_ms(
                    lambda: tpuspmm_torch.spmm(ca, cb16)),
                "cusparse_ms": lib_ms, "vs_cusparse": lib_ms / ms,
                "route_costs_us": dispatch.route_costs(ca, b)}))
        corpus[name] = (ca, b, ref)
        del out, out16, cb16

    launches = {n: fn.launches for n, fn in serving.items()}
    emit("serving_path_launches", **launches,
         note="tpuspmm_torch.spmm calls only (serves, timing loops)")
    for name in sorted(set(SERVED_ROUTES.values()) & set(serving)):
        check(launches[name] > 0, f"{name} kernel launched on the serving "
                                  "path")

    # the fitted model's prices beside the device times they stand for, on
    # every dir the default config serves by panel or pair at its width,
    # and the geometry the unfitted constants (step and strip 0, the data
    # sheet's bandwidth) served there, timed in the same run: data for the
    # next refit and for the fit's effect, not a check (launches made here
    # are outside the serving window)
    fit_row = {k: v for k, v in dispatch.thresholds(dev).items()
               if k.startswith("panel_")}
    unfitted = {"panel_step_us": 0.0, "panel_strip_us": 0.0,
                "panel_hbm_gbps": report.hbm_gbps(gpu)}
    fit_a, fit_b = load(FIT_EXTRA)
    fit_dirs = {HEADLINE: (a, b32), **{n: corpus[n][:2] for n in MAIN_CORPUS},
                FIT_EXTRA: (fit_a, torch.from_numpy(fit_b.data).to(dev))}
    fit_dirs = {n: (ca, b) for n, (ca, b) in fit_dirs.items()
                if dispatch.route(ca, b) in ("panel", "pair")}

    def timed_geometry(ca, b, kname, g, n_pad) -> dict:
        plan = plan_of(ca, kname, g, n_pad)
        fn = entries[kname][0]
        fn(plan, b)  # its device arrays built before the capture
        return {"cost_us": g.cost_us, "geometry": geometry(plan),
                "device_ms": device_ms(lambda: fn(plan, b))}

    for name, (ca, b) in fit_dirs.items():
        n_pad = round_up(int(b.shape[1]), 128)
        geoms = dict(zip(("panel", "pair"), resolved(ca, n_pad)))
        rec = {kname: timed_geometry(ca, b, kname, g, n_pad)
               for kname, g in geoms.items()}
        served = modelled_kernel(ca, n_pad, Config())
        with mock.patch.dict(dispatch.H100_FIT, unfitted):
            was_served = modelled_kernel(ca, n_pad, Config())
            was = dict(zip(("panel", "pair"), resolved(ca, n_pad)))
        rec["unfitted"] = dict(
            timed_geometry(ca, b, was_served, was[was_served], n_pad),
            kernel=was_served, constants=unfitted)
        emit("model_fit", testcase=name, bCols=int(b.shape[1]),
             served=served, constants=fit_row,
             served_over_unfitted_device_ms=(
                 rec[served]["device_ms"] / rec["unfitted"]["device_ms"]),
             gpu=gpu, power_limit=card.split(",")[-1].strip(), **rec)
    del fit_dirs, fit_a, fit_b

    # ---- 5b. BSR serving path: tpuspmm_torch.spmm only ------------------
    all_counters = {"panel": panel_spmm.spmm_panel,
                    "pair": pair_spmm.spmm_pair,
                    **{n: c for n, (c, *_) in tile_entries.items()},
                    "bsr_stream": k6}
    for counter in all_counters.values():
        counter.launches = 0

    def launched_by(call):
        before = {n: c.launches for n, c in all_counters.items()}
        out = call()
        torch.cuda.synchronize()
        return out, [n for n, c in all_counters.items()
                     if c.launches > before[n]]

    for wname, w in weights.items():
        for b in (pb32, pb16):
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            out, ran = launched_by(lambda: tpuspmm_torch.spmm(w, b))
            check(ran == ["bsr_stream"], f"K6 alone served ({wname}): {ran}")
            check(dispatch.route(w, b) == "bsr_stream",
                  f"({wname}) routes to bsr_stream")
            gate = allclose(out, k6_refs[wname, tag])
            check(gate, f"BSR main path ({wname}, {tag}) gate")
            emit("bsr_main_path", weight=wname, b_dtype=tag,
                 kernel="bsr_stream", gate=gate,
                 ms=cuda_time_ms(lambda: tpuspmm_torch.spmm(w, b)),
                 gpu=gpu, power_limit=card.split(",")[-1].strip())
            del out
    w4 = BSR.random_blocks(*PRUNED_4X4)
    check(bsr_spmm.pack_blocks(w4) is None, "4x4 weight: packing refused")
    got_route = dispatch.route(w4, pb32)
    (out, ran), served = fit_routing.served_route(
        lambda: launched_by(lambda: tpuspmm_torch.spmm(w4, pb32)))
    check(served == got_route, f"4x4 weight served {served}, "
                               f"dispatch.route names {got_route}")
    check(ran == ([got_route] if got_route in all_counters else []),
          f"the {got_route} route launched {ran}")
    gate = allclose(out, oracle.spmm_oracle(w4, pb32.cpu().numpy()))
    check(gate, f"4x4 weight {got_route} gate vs f64 oracle")
    emit("bsr_main_path", weight="4x4_d10", b_dtype="f32", kernel=got_route,
         gate=gate, stored_nnz=w4.nnz, sparsity=w4.sparsity,
         ms=cuda_time_ms(lambda: tpuspmm_torch.spmm(w4, pb32)))
    del out, w4
    bsr_launches = {n: c.launches for n, c in all_counters.items()}
    emit("bsr_serving_path_launches", **bsr_launches,
         note="tpuspmm_torch.spmm calls on BSR weights only")
    check(bsr_launches["bsr_stream"] > 0, "K6 launched on the serving path")

    # ---- 5c. served handles: bound launches against the entry points -----
    # Each kernel's launch as a served handle holds it (bound once per
    # plan, B width, B dtype and device; kernels/*_cuda.py bind) against
    # its entry point on the same plan, bit for bit, and against its plain
    # version; the handle's own call timed beside the entry point's and
    # its graph replay.  Launches here are outside every window.
    t_handles = time.perf_counter()
    config = Config()
    tplan = tiles.plan_from_container(a, tile_m=config.tile_m,
                                      tile_k=config.tile_k,
                                      chunk=config.chunk_nnz)
    # K1 and K2 on the headline's panel and pair plans (phase 3's, at the
    # geometries the dispatcher resolves)
    panel_plan, pair_plan = plans["panel"], plans["pair"]
    k6_weight = weights["a"]
    handle_cases = {
        # kernel: (operand, what it serves from, B pair, the handle's
        # launch for a B, the entry point, the plain version, tolerance)
        "panel": (a, panel_plan, (b32, b16),
                  lambda b: dispatch._launch("panel", a, panel_plan, b,
                                             config),
                  lambda b: panel_spmm.spmm_panel(panel_plan, b),
                  lambda b: panel_spmm.panel_spmm_plain(panel_plan, b),
                  PLAIN_TOL),
        "pair": (a, pair_plan, (b32, b16),
                 lambda b: dispatch._launch("pair", a, pair_plan, b,
                                            config),
                 lambda b: pair_spmm.spmm_pair(pair_plan, b),
                 lambda b: pair_spmm.pair_spmm_plain(pair_plan, b),
                 PLAIN_TOL),
        **{name: (a, tplan, (b32, b16),
                  lambda b, _n=name: dispatch._launch(_n, a, tplan, b,
                                                      config),
                  lambda b, _n=name: tile_entries[_n][1](tplan, b, "split"),
                  lambda b, _n=name: tile_entries[_n][2](tplan, b, "split"),
                  PLAIN_TOL)
           for name in ("tile", "staged", "cres")},
        # K5b has no route (as in JAX): the launch a handle would hold
        "cres_kloop": (a, tplan, (b32, b16),
                       lambda b: cres_spmm.cres_launch(tplan, b, "split",
                                                       "kloop"),
                       lambda b: cres_spmm.spmm_cres_kloop(tplan, b),
                       lambda b: cres_spmm.cres_spmm_plain(tplan, b, "split",
                                                           "kloop"),
                       PLAIN_TOL),
        "bsr_stream": (k6_weight, k6_weight, (pb32, pb16),
                       lambda b: dispatch._launch("bsr_stream", k6_weight,
                                                  k6_weight, b, config),
                       lambda b: bsr_spmm.spmm_bsr_stream(k6_weight, b),
                       lambda b: bsr_spmm.bsr_spmm_plain(k6_weight, b),
                       K6_TOL),
    }
    handle_stats = {}
    for name, (op, src, bs, launch_of, entry, plain, tol) in \
            handle_cases.items():
        rec = {}
        for b in bs:
            tag = "f32" if b.dtype == torch.float32 else "bf16"
            launch = launch_of(b)
            got, want = launch(b), entry(b)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} {tag}: the handle's "
                                          "output equals its entry point's")
            ref = plain(b)
            err = max_abs_err(got, ref)
            scale = float(ref.abs().max())
            check(err <= tol * scale, f"{name} {tag} handle |kernel - plain| "
                                      f"{err} <= {tol}*{scale}")
            rec[tag] = {"max_abs_err": err, "max_abs_c": scale,
                        "handle_ms": cuda_time_ms(lambda: launch(b)),
                        "entry_ms": cuda_time_ms(lambda: entry(b)),
                        "device_ms": device_ms(lambda: launch(b))}
            del got, want, ref
        # an f16 B is refused by the bound launch and by the entry point,
        # before anything launches
        b_f16 = bs[0].to(torch.float16)
        for what, call in (("handle", lambda: launch_of(bs[0])(b_f16)),
                           ("entry", lambda: entry(b_f16))):
            try:
                call()
            except ValueError as e:
                check("f32/bf16" in str(e) or "f32 or bf16" in str(e),
                      f"{name} {what}: f16 B refused by its type ({e})")
            else:
                check(False, f"{name} {what}: an f16 B was launched")
        emit("served_handle", kernel=name, gpu=gpu,
             power_limit=card.split(",")[-1].strip(), **rec)
        handle_stats[name] = rec
    # the served path end to end: spmm's repeat serve against the bound
    # launch it holds, on the headline
    for b in (b32, b16):
        tag = "f32" if b.dtype == torch.float32 else "bf16"
        h = dispatch.served(a, b)
        emit("served_headline", b_dtype=tag, route=h.route,
             spmm_ms=cuda_time_ms(lambda: tpuspmm_torch.spmm(a, b)),
             handle_ms=cuda_time_ms(lambda: h.launch(b)),
             device_ms=device_ms(lambda: h.launch(b)), vendor_ms=vendor_ms,
             gpu=gpu, power_limit=card.split(",")[-1].strip())
    emit("served_handle_phase", seconds=time.perf_counter() - t_handles)

    # ---- 6. engine: tpuspmm_torch.cli ------------------------------------
    os.makedirs(PRUNED_DIR, exist_ok=True)
    weights["a"].save(os.path.join(PRUNED_DIR, "pruned_b128.bsr"))
    fio.write_dense_text(os.path.join(PRUNED_DIR, "dense.in"),
                         pb32.cpu().numpy())
    for counter in all_counters.values():
        counter.launches = 0
    records_path = os.path.join(REPO, "build", "engine_records.jsonl")
    with open(records_path, "w"):
        pass
    for args in ENGINE_RUNS:
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            status = cli.main(args)
        secs = time.perf_counter() - t0
        auto = [line.split()[2:] for line in err.getvalue().splitlines()
                if line.startswith("# auto-selected")]
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
        selected = None
        if "--auto" in args:
            check(len(auto) == 1, f"engine {args} named its selection")
            selected = dict(kv.split("=", 1) for kv in auto[0])
            check(any(r["format"] == selected["format"]
                      and r["kernelName"] == selected["kernel"]
                      and r["correct"] == "1" for r in recs),
                  f"engine {args}: the selected {selected} passes the gate")
        emit("engine", args=" ".join(os.path.relpath(a, REPO)
                                     if a == PRUNED_DIR else a
                                     for a in args),
             seconds=secs, auto_selected=selected, records=[
            {"fmt": r["format"], "k": int(r["kernelType"]),
             "name": r["kernelName"],
             "correct": r.get("skipped") or r["correct"],
             "ms": r["cudaKernelTimeMs"],
             **({"verifiedOnly": 1} if r.get("verifiedOnly") else {}),
             **({"blockStream": r["blockStream"]}
                if "blockStream" in r else {})}
            for r in recs])
    engine_launches = {n: c.launches for n, c in all_counters.items()}
    emit("engine_launches", **engine_launches,
         note="tpuspmm_torch.cli.main runs only; no engine variant "
              "reaches the k-loop schedule, as in the JAX package")
    for name in ("panel", "pair", "tile", "staged", "cres", "bsr_stream"):
        check(engine_launches[name] > 0, f"{name} launched by the engine")

    # ---- 6b. tuned: the autotuner, the bench, --tuned, --trace, the API --
    t_tuned = time.perf_counter()
    for counter in all_counters.values():
        counter.launches = 0
    cfg = Config()
    med_a, med_dense = load("medium_4096")
    med_b = torch.from_numpy(med_dense.data).to(dev)
    tuned_ops = (
        (f"{HEADLINE} w{WIDTH} f32", a, b32, refs[torch.float32]),
        (f"{HEADLINE} w{WIDTH} bf16", a, b16, refs[torch.bfloat16]),
        ("medium_4096 w4096", med_a, med_b,
         oracle.spmm_scipy_oracle(med_a, med_dense.data)),
        (f"pruned (a) BSR w{PRUNED_WIDTH}", weights["a"], pb32,
         k6_refs["a", "f32"]))

    @contextlib.contextmanager
    def measurements():
        """The autotuner's measurements in the block, counted by wrapping
        its one timer."""
        calls, orig = [], timing.serve_time_ms

        def counted(*args, **kw):
            calls.append(1)
            return orig(*args, **kw)

        timing.serve_time_ms = counted
        try:
            yield calls
        finally:
            timing.serve_time_ms = orig

    def served_numbers(engine, call):
        """``call()`` and the kernel numbers it ran through
        ``engine.run_kernel``."""
        seen, orig = [], engine.run_kernel

        def spy(number, *args, **kw):
            seen.append(number)
            return orig(number, *args, **kw)

        engine.run_kernel = spy
        try:
            return call(), seen
        finally:
            del engine.run_kernel

    def resolved_record(family, container, n_pad, b_dtype) -> dict:
        """The geometry the serving call resolves, in the ranking's terms."""
        if family == "panel":
            g = panel_spmm.resolve_panel_geometry(
                container, n_pad, panel_strips=cfg.panel_strips,
                plan_bytes_cap=cap, device=dev, b_dtype=b_dtype)
            return {"tm": g.tm, "P": g.panel_strips, "tk": g.tk, "sm": g.sm,
                    "order": g.order_kind}
        g = pair_spmm.resolve_pair_geometry(container, n_pad,
                                            plan_bytes_cap=cap, device=dev,
                                            b_dtype=b_dtype)
        return {"CH": g.chunk_strips, "sm": g.sm, "order": g.order_kind}

    def serve_ms(fn, tb) -> float:
        """A serve's ms as the tuner times a variant: the least of 3
        medians of 20 back-to-back calls (host-bound serves spread)."""
        return timing.serve_time_ms(fn, tb, 20, windows=3)

    # what a user who does not tune is served: every operand before any
    # tune (a tune pins geometries that the default serve then resolves)
    defaults = {label: (dispatch.route(ta, tb),
                        serve_ms(lambda bb: tpuspmm_torch.spmm(ta, bb), tb))
                for label, ta, tb, _ in tuned_ops}
    tuned_ms, rankings = {}, {}
    for label, ta, tb, tref in tuned_ops:
        eng = get_engine(ta.format_name)
        default_route, default_ms = defaults[label]
        t0 = time.perf_counter()
        with measurements() as calls:
            ranking = autotune.tune(ta, tb, iters=8, config=cfg)
        tune_s = time.perf_counter() - t0
        check(ranking, f"{label}: tune ranked a variant")
        for r in ranking:
            check(allclose(eng.run_kernel(r.number, ta, tb, cfg), tref),
                  f"{label}: ranked {r.variant_name} passes the gate again")
        first = next((r for r in ranking if not r.verified_only), None)
        check(first is not None, f"{label}: an entry that is not "
                                 "verified-only")
        out, seen = served_numbers(eng, lambda: tpuspmm_torch.spmm(
            ta, tb, method="tuned", config=cfg))
        check(seen == [first.number], f"{label}: method='tuned' served "
              f"{seen}, the first entry not verified-only is "
              f"{first.number} ({first.variant_name})")
        want = eng.run_kernel(first.number, ta, tb, cfg)
        deterministic = torch.equal(want,
                                    eng.run_kernel(first.number, ta, tb, cfg))
        if deterministic:
            check(torch.equal(out, want), f"{label}: the tuned serve equals "
                                          f"kernel {first.number}'s output")
        check(allclose(out, tref), f"{label}: tuned serve gate")
        del out, want
        rankings[label] = ranking
        with measurements() as calls2:
            again = autotune.tune(dataclasses.replace(ta), tb, iters=8,
                                  config=cfg)
        check(not calls2, f"{label}: a second tune measured {len(calls2)}")
        check([(r.variant_name, r.ms) for r in again]
              == [(r.variant_name, r.ms) for r in ranking],
              f"{label}: a second tune returns the same ranking")
        tuned_serve = serve_ms(lambda bb: tpuspmm_torch.spmm(
            ta, bb, method="tuned", config=cfg), tb)
        lib_ms = serve_ms(lambda bb: vendor.spmm_vendor(ta, bb), tb)
        tuned_ms[label] = (tuned_serve, default_ms)
        emit("tuned", operand=label, tune_s=tune_s, measurements=len(calls),
             ranking=[{"name": r.variant_name, "number": r.number,
                       "ms": r.ms, "verified_only": r.verified_only,
                       **({"geometry": r.geom} if r.geom else {})}
                      for r in ranking],
             winner=first.variant_name,
             fastest=min(ranking, key=lambda r: r.ms).variant_name,
             winner_deterministic=deterministic,
             tuned_serve_ms=tuned_serve, default_serve_ms=default_ms,
             default_route=default_route, cusparse_ms=lib_ms,
             gpu=gpu, power_limit=card.split(",")[-1].strip())
    # every pin, read back after all the tunes: a later tune (another B
    # dtype of the same matrix) must not have replaced an earlier one's
    for label, ta, tb, _ in tuned_ops:
        fresh = dataclasses.replace(ta)  # the same matrix, no cache
        n_pad = round_up(int(tb.shape[1]), 128)
        for r in rankings[label]:
            family = autotune._GEOM_FAMILIES.get(r.variant_name)
            if family is None:
                continue
            check(r.geom is not None and r.geom["family"] == family,
                  f"{label}: {r.variant_name} carries its geometry")
            got = resolved_record(family, fresh, n_pad, tb.dtype)
            check(all(r.geom[key] == v for key, v in got.items()),
                  f"{label}: {r.variant_name}'s pinned geometry {r.geom} "
                  f"comes back from disk on a fresh container ({got})")
        del fresh
    # the default serve is priced: on medium_4096 w4096 it is the tile
    # family, which the tuner ranked first before the strip routine
    # (1.75 ms in JAX's order); host work spreads such serves, so the
    # check allows 2x
    tuned_serve, default_ms = tuned_ms["medium_4096 w4096"]
    check(defaults["medium_4096 w4096"][0] in dispatch.TILE_FAMILY
          and default_ms <= 2 * tuned_serve,
          f"medium_4096 w4096: the default serve "
          f"({defaults['medium_4096 w4096'][0]}, {default_ms} ms) is the "
          f"tile family within 2x of the tuned serve ({tuned_serve} ms)")
    tuned_window = {n: c.launches for n, c in all_counters.items()}
    emit("tuned_launches", **tuned_window,
         note="autotune.tune and spmm(method='tuned') on the four operands")
    for name in ("panel", "pair", "tile", "cres", "bsr_stream"):
        check(tuned_window[name] > 0, f"{name} launched by the tuner")

    # the headline bench, in a process of its own with caches of its own:
    # its default serve is the model's pick, not a geometry pinned above
    t0 = time.perf_counter()
    bench_cache = os.path.join(CACHE_DIR, "bench")
    res = subprocess.run([sys.executable, "-m", "tpuspmm_torch.bench"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600, env={
                             **os.environ,
                             "TPUSPMM_TORCH_TUNE_CACHE": os.path.join(
                                 bench_cache, "tune.json"),
                             "TPUSPMM_TORCH_GEOM_CACHE": os.path.join(
                                 bench_cache, "geom.json")})
    check(res.returncode == 0, f"bench exit status {res.returncode}: "
                               f"{res.stderr[-3000:]}")
    bench = json.loads(res.stdout.strip().splitlines()[-1])
    check(bench["correct"] and bench["bf16_serving_correct"],
          f"bench correct in f32 and bf16 ({bench})")
    emit("bench", seconds=time.perf_counter() - t0, record=bench)

    # --tuned through the CLI: the ranking is on disk, nothing is measured
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        status = cli.main(["--csr", "--tuned", "-d", HEADLINE, "--width",
                           str(WIDTH)])
    recs = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    check(status == 0 and len(recs) == 1 and recs[0]["tuned"] == "1"
          and recs[0]["correct"] == "1", f"cli --tuned: {status} {recs}")
    emit("cli_tuned", kernel=recs[0]["kernelName"],
         kernel_ms=recs[0]["cudaKernelTimeMs"], ranking=recs[0]["ranking"])

    # --trace: a panel run, whose Chrome trace names the kernel it launched
    trace_dir = os.path.join(REPO, "build", "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    before = panel_spmm.spmm_panel.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        status = cli.main(["--csr", "--kernel", "7", "-d", HEADLINE,
                           "--width", str(WIDTH), "--trace", trace_dir])
    check(status == 0, f"cli --trace exit status {status}")
    check(panel_spmm.spmm_panel.launches > before,
          "the traced run launched the panel kernel")
    trace_path = os.path.join(trace_dir, profiling.TRACE_FILE)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    symbols = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"})
    check(any("group_owner_kernel" in s_ for s_ in symbols),
          f"the trace names the strip kernel's symbol ({symbols[:10]})")
    emit("trace", path=os.path.relpath(trace_path, REPO),
         bytes=os.path.getsize(trace_path), kernel_symbols=symbols)

    # the API on the card: spmv (B rows of 4 and 2 bytes), spmm_batched
    # (one launch for the stack), spmm_fn's backward on Aᵀ
    def launched(call):
        before = {n: c.launches for n, c in all_counters.items()}
        result = call()
        torch.cuda.synchronize()
        return result, {n: c.launches - before[n]
                        for n, c in all_counters.items()
                        if c.launches > before[n]}

    rng = np.random.default_rng(11)
    m, k = a.shape
    api = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = torch.from_numpy(rng.uniform(-1, 1, k).astype(np.float32)).to(
            dev).to(dt)
        y, ran = launched(lambda: tpuspmm_torch.spmv(a, x))
        check(y.shape == (m,) and y.dtype == torch.float32,
              f"spmv {dt}: shape {tuple(y.shape)}")
        check(ran, f"spmv {dt}: a hand kernel served it")
        gate = allclose(y, oracle.spmm_scipy_oracle(
            a, x.float().cpu().numpy()[:, None])[:, 0])
        check(gate, f"spmv {dt} gate vs f64 oracle")
        api[f"spmv_{tag}"] = {"kernels": ran, "gate": gate, "ms": cuda_time_ms(
            lambda: tpuspmm_torch.spmv(a, x))}
    stack = torch.from_numpy(rng.uniform(-1, 1, (3, k, WIDTH)).astype(
        np.float32)).to(dev)
    y, ran = launched(lambda: tpuspmm_torch.spmm_batched(a, stack))
    check(y.shape == (3, m, WIDTH), f"spmm_batched shape {tuple(y.shape)}")
    check(sum(ran.values()) == 1, f"spmm_batched: one launch ({ran})")
    ref = oracle.spmm_scipy_oracle(
        a, stack.permute(1, 0, 2).reshape(k, -1).cpu().numpy())
    gate = allclose(y, ref.reshape(m, 3, WIDTH).transpose(1, 0, 2))
    check(gate, "spmm_batched gate vs f64 oracle")
    api["spmm_batched"] = {"kernels": ran, "gate": gate, "ms": cuda_time_ms(
        lambda: tpuspmm_torch.spmm_batched(a, stack))}
    del y, stack
    grad_c = torch.from_numpy(rng.uniform(-1, 1, (m, b32.shape[1])).astype(
        np.float32)).to(dev)
    grad_ref = (a.to_scipy().T.astype(np.float64)
                @ grad_c.cpu().numpy().astype(np.float64)).astype(np.float32)
    for bt in (b32, b16):
        leaf = bt.clone().requires_grad_(True)
        c = tpuspmm_torch.spmm_fn(a)(leaf)
        check(c.dtype == torch.float32 and allclose(c, refs[bt.dtype]),
              f"spmm_fn {bt.dtype} forward gate")
        _, ran = launched(lambda: c.backward(grad_c))
        check(ran, f"spmm_fn {bt.dtype}: the backward launched a hand "
                   "kernel on A^T")
        check(leaf.grad.dtype == bt.dtype, f"gradient in B's dtype "
                                           f"({leaf.grad.dtype})")
        gate = allclose(leaf.grad, grad_ref)
        check(gate, f"spmm_fn {bt.dtype} gradient gate vs f64 oracle of "
                    "A^T G")
        api["spmm_fn_" + ("f32" if bt.dtype == torch.float32 else "bf16")] = {
            "backward_kernels": ran, "gate": gate}
        del c, leaf
    emit("api", shape=[m, k], **api)
    emit("tuned_phase", seconds=time.perf_counter() - t_tuned)

    # ---- 7. dispatch routes ----------------------------------------------
    for name in ROUTE_DIRS:
        ra, rdense = load(name)
        rb = torch.from_numpy(rdense.data).to(dev)
        got_route = dispatch.route(ra, rb)
        out, served = fit_routing.served_route(
            lambda: tpuspmm_torch.spmm(ra, rb))
        check(served == got_route, f"{name} served {served}, "
                                   f"dispatch.route names {got_route}")
        gate = allclose(out, oracle.spmm_scipy_oracle(ra, rdense.data))
        check(gate, f"{name} {got_route} route gate vs f64 oracle")
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

    # ---- 9. extreme-value dirs: spmm's route and gate; kernels vs plain --
    for name in EXTREME_CORPUS:
        ca, cdense = load(name)
        b = torch.from_numpy(cdense.data).to(dev)
        ref = oracle.spmm_scipy_oracle(ca, cdense.data)
        got_route = dispatch.route(ca, b)
        served = tpuspmm_torch.spmm(ca, b)
        rec = {"needs_compensated": exact.needs_compensated(ca),
               "exact_admissible": exact.exact_admissible(ca),
               "bCols": int(b.shape[1]), "route": got_route,
               "spmm_gate": allclose(served, ref),
               "spmm_gate_ratio": gate_ratio(served, ref)}
        del served
        # the compensated / exact path must pass; a plain-f32 route (panel
        # or pair where exact is not admissible) is recorded
        if got_route == "exact":
            check(rec["spmm_gate"], f"{name}: spmm by {got_route} at the "
                                    "gate vs f64 oracle")
        cplans, _ = main_path_plans(ca, ((b.shape[1] + 127) // 128) * 128)
        for kname, plan in cplans.items():
            # held to PLAIN_TOL·max|C| inside against_plain; the kernels
            # line reports the headline's absolute errors, not these
            # (|C| reaches 1e16 here)
            r = against_plain(kname, plan, b, timed=False)
            rec[kname] = {"max_abs_err": r["max_abs_err"],
                          "max_abs_c": r["max_abs_c"],
                          "gate": allclose(r["out"], ref),
                          "gate_ratio": gate_ratio(r["out"], ref),
                          "plain_gate": allclose(r["want"], ref),
                          "plain_gate_ratio": gate_ratio(r["want"], ref)}
            del r
        emit("extreme_values", testcase=name, **rec,
             note="|values| beyond the 2e4 cut-off: spmm's gate is "
                  "required on the compensated route; a plain-f32 result "
                  "passes only by luck of the operand, so the panel / pair "
                  "gates are printed beside their plain versions'")
        del b

    # ---- 10. parallel: the distributed schedules in a one-rank NCCL group --
    t_par = time.perf_counter()
    from tpuspmm_torch import parallel
    from tpuspmm_torch.parallel import multihost
    from tpuspmm_torch.ops import xla

    check(multihost.initialize(device="cuda") is False,
          "a one-rank group starts with no launcher")
    try:
        check(torch.distributed.get_backend() == "nccl", "NCCL on the card")
        par_stats = parallel_phase(parallel, a, b32, b16, refs, pruned_csr,
                                   xla, tiles, tile_spmm, panel_spmm,
                                   pair_spmm, gpu, card)
    finally:
        multihost.shutdown()
    example = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m",
         "tpuspmm_torch.examples.distributed_serving", "--data-dir",
         HEADLINE, "--width", str(WIDTH), "-l", "panel"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    emit("distributed_serving_example", returncode=example.returncode,
         stdout=example.stdout.splitlines()[-6:])
    check(example.returncode == 0 and example.stdout.count("correct=True")
          == 4, f"the example under torch.distributed.run: "
                f"{example.stdout[-1500:]} {example.stderr[-1500:]}")
    par_launches = par_stats["launches"]
    emit("parallel_phase", seconds=time.perf_counter() - t_par,
         launches=par_launches)

    # ---- 10b. sweeps: native, tools, corpus, sparsity, pruned LLM / MLP --
    sweep_launches = sweeps_phase(os.path.join(REPO, "build", "sweeps"),
                                  gpu, card)

    # ---- 10c. tools: entry(), profile_variants, hbm_control, weak_scaling --
    tools = tools_phase(gpu, card)
    tools_launches = tools["launches"]

    # ---- 10d. the dispatcher's routing row ------------------------------
    routing_row_phase(gpu, card)

    # ---- 10e. the expert layer at published widths -----------------------
    moe_phase()

    # ---- 11. kernels line, card, ok --------------------------------------
    kernels = {  # name: (entry, source, TPU kernel body it replaces)
        "panel": ("panel_strip_spmm", "strip_spmm.cu",
                  "tpuspmm/kernels/panel_spmm.py:1050"),
        "pair": ("pair_strip_spmm", "strip_spmm.cu",
                 "tpuspmm/kernels/pair_spmm.py:267"),
        "tile": ("tile_chunk_spmm", "chunk_spmm.cu",
                 "tpuspmm/kernels/tile_spmm.py:43"),
        "staged": ("staged_chunk_spmm", "chunk_spmm.cu",
                   "tpuspmm/kernels/csr_vmem.py:89"),
        "cres": ("cres_cluster_spmm/block8", "chunk_spmm.cu",
                 "tpuspmm/kernels/cres_spmm.py:53"),
        "cres_kloop": ("cres_cluster_spmm/kloop", "chunk_spmm.cu",
                       "tpuspmm/kernels/cres_spmm.py:163"),
    }
    st = tools["stream"]
    stream_rate = st["bytes"] / (st["ms"] * 1e-3)  # bytes/s, this run
    lines = []
    for name, (entry, source, replaces) in kernels.items():
        if launches.get(name):  # K1, K2, K5a: the CSR serving path
            count, window = launches[name], "serving (tpuspmm_torch.spmm)"
        elif name == "cres_kloop":
            count, window = tile_window[name], "tile_kernels_vs_plain"
        else:
            count, window = engine_launches[name], "engine (cli.main)"
        line = {"name": entry, "route": "cuda",
                "source": f"tpuspmm_torch/csrc/{source}",
                "replaces": replaces, "launches": count,
                "launches_window": window,
                "tuned_launches": tuned_window[name],
                "parallel_launches": par_launches.get(name, 0),
                "sweeps_launches": sweep_launches[name],
                "tools_launches": tools_launches[name]}
        if name == "panel":  # entry()'s raw launches, counted apart
            line["entry_launches"] = tools_launches["entry_panel"]
            line["entry"] = {k: tools["entry"][k] for k in (
                "ms", "device_ms", "plain_ms", "max_abs_err", "bound_ms")}
        if name in entries:
            line.update({
                "max_abs_err": stats[name]["max_abs_err"],
                "max_abs_err_split2": stats[name].get("max_abs_err_split2"),
                "ms": stats[name]["ms_f32"],
                "plain_ms": stats[name]["plain_ms_f32"],
                "ms_bf16": stats[name]["ms_bf16"],
                "plain_ms_bf16": stats[name]["plain_ms_bf16"],
                "bound_ms": csr_bound["bound_ms"],
                "bound_by": csr_bound["bound_by"], "library_ms": vendor_ms,
                "engine_launches": engine_launches[name],
                "entry_point_launches": entry_launches[name],
                "device_ms": stats[name]["device_ms_f32"],
                "device_ms_bf16": stats[name]["device_ms_bf16"]})
        else:  # the tile family: the headline, then every phase-4 operand
            op = tile_ops[HEADLINE, WIDTH, 128, 128]
            r32 = tile_stats[name, HEADLINE, WIDTH, 128, 128, "f32"]
            r16 = tile_stats[name, HEADLINE, WIDTH, 128, 128, "bf16"]
            line.update({
                "max_abs_err": r32["split"]["max_abs_err"],
                "max_abs_err_split2": r32["split2"]["max_abs_err"],
                "ms": r32["ms"], "plain_ms": r32["plain_ms"],
                "device_ms": r32["device_ms"],
                "ms_bf16": r16["ms"], "plain_ms_bf16": r16["plain_ms"],
                "device_ms_bf16": r16["device_ms"],
                "bound_ms": op["bound_ms"], "bound_by": op["bound_by"],
                "library_ms": op["cusparse_ms"],
                "operands": [
                    {"operand": f"{o} tm{tm} tk{tk} w{w}",
                     "b_dtype": tag, "ms": r["ms"],
                     "device_ms": r["device_ms"],
                     "bound_ms": tile_ops[o, w, tm, tk]["bound_ms"],
                     "bound_ms_at_stream_rate": tile_ops[o, w, tm, tk][
                         "bound_ms"] * hbm / stream_rate,
                     "tc_floor_ms": tile_ops[o, w, tm, tk][
                         "tc_floor_ms" if tag == "f32"
                         else "tc_floor_ms_bf16"],
                     "cusparse_ms": tile_ops[o, w, tm, tk]["cusparse_ms"],
                     "cublas_dense_ms": tile_ops[o, w, tm, tk][
                         "cublas_dense_ms"],
                     "max_abs_err": r["split"]["max_abs_err"],
                     "max_abs_c": r["split"]["max_abs_c"],
                     **{key: r[key] for key in (
                         "multicast_issues", "b_copy", "b_panel_bytes")
                        if key in r}}
                    for (kname, o, w, tm, tk, tag), r in tile_stats.items()
                    if kname == name]})
            line["note"] = (
                "one tile index for K3, K4, K5a and K5b, output bit-identical "
                "to K3's; K3 and K4 on the owner routine, K5a and K5b on its "
                f"cluster launch ({chunk_cuda.CLUSTER} row tiles a cluster, "
                "each dense B chunk multicast once per cluster)"
                if name in clustered else
                "one tile index for K3, K4, K5a and K5b, output bit-identical "
                "to K3's; K3 and K4 on the owner routine")
            if name in clustered:
                line["cluster"] = chunk_cuda.CLUSTER
        # the served handle's bound launch called alone (phase 5c)
        line.update({"handle_ms": handle_stats[name]["f32"]["handle_ms"],
                     "handle_ms_bf16": handle_stats[name]["bf16"][
                         "handle_ms"]})
        line.update({"library_call": "torch.sparse CSR @ B (cuSPARSE)",
                     "shapes": f"{HEADLINE} w{WIDTH}"})
        lines.append(line)
    ka, kw1024 = k6_stats["a"], k6_stats["a_w1024"]
    lib_ms = ka.get("torch_bsr_ms")
    lines.append({
        "name": "bsr_block_spmm", "route": "cuda",
        "source": "tpuspmm_torch/csrc/bsr_spmm.cu",
        "replaces": "tpuspmm/kernels/bsr_spmm.py:34",
        "launches": bsr_launches["bsr_stream"],
        "launches_window": "serving (tpuspmm_torch.spmm on BSR weights)",
        "engine_launches": engine_launches["bsr_stream"],
        "tuned_launches": tuned_window["bsr_stream"],
        "parallel_launches": 0,
        "sweeps_launches": sweep_launches["bsr_stream"],
        "tools_launches": tools_launches["bsr_stream"],
        "kernel_phase_launches": bsr_window,
        "max_abs_err": max(r[t]["max_abs_err"] for r in k6_stats.values()
                           for t in ("f32", "bf16")),
        "ms": ka["f32"]["ms"], "plain_ms": ka["f32"]["plain_ms"],
        "ms_bf16": ka["bf16"]["ms"], "plain_ms_bf16": ka["bf16"]["plain_ms"],
        "device_ms": ka["f32"]["device_ms"],
        "device_ms_bf16": ka["bf16"]["device_ms"],
        "handle_ms": handle_stats["bsr_stream"]["f32"]["handle_ms"],
        "handle_ms_bf16": handle_stats["bsr_stream"]["bf16"]["handle_ms"],
        "bound_ms": ka["bound_ms"], "bound_by": ka["bound_by"],
        "w1024": {"device_ms": kw1024["f32"]["device_ms"],
                  "device_ms_bf16": kw1024["bf16"]["device_ms"],
                  "ms": kw1024["f32"]["ms"], "ms_bf16": kw1024["bf16"]["ms"],
                  "bound_ms": kw1024["bound_ms"],
                  "cusparse_csr_ms": kw1024["cusparse_csr_ms"]},
        # the tile-owner routine's dense path on weight (a) as CSR, this run
        "tile_family_device_ms": {
            f"w{w_}_{t}": tile_stats["tile", "pruned_a", w_, 128, 128,
                                     t]["device_ms"]
            for w_ in (PRUNED_WIDTH, 1024) for t in ("f32", "bf16")},
        "library_ms": lib_ms if lib_ms is not None
        else ka["cusparse_csr_ms"],
        "library_call": ("torch.sparse_bsr_tensor @ B" if lib_ms is not None
                         else "torch.sparse CSR @ B (cuSPARSE)"),
        "cusparse_csr_ms": ka["cusparse_csr_ms"],
        "shapes": "weight (a): 4096 x 4096, 128 x 128 blocks at 10%, B "
                  f"4096 x {PRUNED_WIDTH}"})
    lines.append({
        "name": "stream_2x_plus_1", "route": "cuda",
        "source": "tpuspmm_torch/csrc/stream.cu",
        "replaces": "bench/hbm_control.py:87",
        "note": "the memory control's y = 2x + 1 (an XLA fusion there, no "
                "pallas_call); equal to its plain version bit for bit",
        "launches": tools_launches["stream"],
        "launches_window": "tools (hbm_control)",
        "max_abs_err": st["max_abs_err"], "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bytes"] / (report.hbm_gbps(gpu) * 1e9) * 1e3,
        "bound_by": "bytes", "library_ms": st["library_ms"],
        "library_call": st["library_call"],
        "frac_of_nominal": st["frac_of_nominal"],
        "shapes": f"{st['elements']} f32"})
    print(json.dumps({"kernels": lines}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
