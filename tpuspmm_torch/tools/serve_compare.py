"""Serve and entry-point times of package roots, in turns, on one card.

Each root is a directory holding a ``tpuspmm_torch`` package: this
checkout, or an earlier commit unpacked with ``git archive`` into a
git-ignored directory.  For each root, in the order given (parent,
change, change, parent compares two versions within one call), a fresh
process imports that root's package and times on large_25605 at B width
256, f32 and bf16 B:

- ``tpuspmm_torch.spmm`` (``cuda_time_ms``: CUDA events, median of 50
  back-to-back serves, host work included) and its graph replay
  (``graph_time_ms``, the device time), and cuSPARSE on the same operand;
- each CSR kernel's entry point (K1 ``spmm_panel``, K2 ``spmm_pair`` on
  the geometries the dispatcher resolves; K3, K4, K5a, K5b on the default
  tile plan), both ways;
- K6's entry point and ``spmm`` on the pruned weight (4096², 128 × 128
  blocks at 10%, B 4096 × 512 ``standard_normal · 0.05``, seed 0).

Each run prints one JSON line with the card's name and power limit; the
outputs of the first two runs are compared bit for bit.  Needs a card::

    python3 tpuspmm_torch/tools/serve_compare.py build/parent . . build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ITERS = 50


def run_one(root: str, tag: str, out_dir: str) -> dict:
    """Time ``root``'s package (imported first on the path) and save its
    outputs to ``out_dir/tag.pt``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import tpuspmm_torch
    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import BSR, convert, tiles
    from tpuspmm_torch.kernels import (bsr_spmm, cres_spmm, csr_vmem,
                                       dispatch, pair_spmm, panel_spmm,
                                       tile_spmm)
    from tpuspmm_torch.ops import vendor
    from tpuspmm_torch.utils.timing import (card_line, cuda_time_ms,
                                            graph_time_ms)

    if not tpuspmm_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {tpuspmm_torch.__file__}, not {root}'s")
    dev = torch.device("cuda")
    d = data_dir("large_25605")
    a = convert.load_sparse(d, "csr")
    b32 = torch.from_numpy(convert.load_dense(d, width=256).data).to(dev)
    b16 = b32.to(torch.bfloat16)
    cap = panel_spmm.PLAN_BYTES_CAP
    geom = panel_spmm.resolve_panel_geometry(a, 256, plan_bytes_cap=cap,
                                             device=dev)
    pgeom = pair_spmm.resolve_pair_geometry(a, 256, plan_bytes_cap=cap,
                                            device=dev)
    panel = panel_spmm.panel_plan_from_geometry(a, geom)
    pair = pair_spmm.pair_plan_from_container(
        a, chunk_strips=pgeom.chunk_strips, n_pad=256, geom=pgeom,
        device=dev)
    tplan = tiles.plan_from_container(a)
    w = BSR.random_blocks(4096, 4096, (128, 128), 0.1, 0)
    wb32 = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (4096, 512)) * 0.05).astype(np.float32)).to(dev)
    calls = {
        "spmm": lambda b: tpuspmm_torch.spmm(a, b),
        "panel": lambda b: panel_spmm.spmm_panel(panel, b),
        "pair": lambda b: pair_spmm.spmm_pair(pair, b),
        "tile": lambda b: tile_spmm.spmm_tiles(tplan, b),
        "staged": lambda b: csr_vmem.spmm_staged(tplan, b),
        "cres": lambda b: cres_spmm.spmm_cres(tplan, b),
        "cres_kloop": lambda b: cres_spmm.spmm_cres_kloop(tplan, b),
    }
    operands = {"f32": (b32, wb32), "bf16": (b16, wb32.to(torch.bfloat16))}
    rec = {"tag": tag, "root": root, "card": card_line(),
           "cusparse_ms": cuda_time_ms(lambda: vendor.spmm_vendor(a, b32),
                                       iters=ITERS)}
    outputs = {}
    for dtype, (b, wb) in operands.items():
        rec[f"route_{dtype}"] = dispatch.route(a, b)
        for name, fn in {**{k: (lambda f=f: f(b)) for k, f in calls.items()},
                         "k6": lambda: bsr_spmm.spmm_bsr_stream(w, wb),
                         "k6_spmm": lambda: tpuspmm_torch.spmm(w, wb)
                         }.items():
            outputs[f"{name}_{dtype}"] = fn().cpu()
            rec[f"{name}_ms_{dtype}"] = cuda_time_ms(fn, iters=ITERS)
            rec[f"{name}_device_ms_{dtype}"] = graph_time_ms(fn)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(outputs, os.path.join(out_dir, f"{tag}.pt"))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+", help="package roots, in turn order")
    p.add_argument("--out-dir", default=os.path.join("build",
                                                     "serve_compare"),
                   help="where each run's outputs are kept until compared")
    p.add_argument("--one", nargs=2, metavar=("ROOT", "TAG"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("serve_compare needs a CUDA card", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(run_one(*args.one, args.out_dir)), flush=True)
        return 0
    tags = [f"run{i}" for i in range(len(args.roots))]
    for root, tag in zip(args.roots, tags):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--out-dir", args.out_dir, "--one", root, tag,
                        root], check=True)
    if len(tags) > 1:
        first, second = (torch.load(os.path.join(args.out_dir, f"{t}.pt"))
                         for t in tags[:2])
        differ = sorted(k for k in first if not torch.equal(first[k],
                                                            second[k]))
        print(json.dumps({"bit_equal": len(first) - len(differ),
                          "differ": differ, "between": args.roots[:2]}),
              flush=True)
    for tag in tags:
        os.remove(os.path.join(args.out_dir, f"{tag}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
