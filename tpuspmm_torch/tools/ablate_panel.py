"""Panel-geometry ablation on the card: the auto-resolved geometry against
pinned strip counts (P), strip heights (tm), k-tile widths (tk) and the
natural row order, at both precision tiers, each launch timed on the
device (replayed in a CUDA graph, so the wrapper's host work does not
show); then the pair kernel at the pair search's candidate geometries,
with the model's price beside each.

Counterpart of ``bench/ablate_panel.py``.  Prints one JSON line per
(matrix, kernel, geometry, mode), after a first line naming the card; the
panel "highest" records are what ``tpuspmm_torch.tools.fit_panel_model``
fits the cost constants of ``kernels/dispatch.py`` from.  ``correct`` is
the rel 1e-2 / abs 1e-3 gate against the f64 oracle.

Usage::

    python -m tpuspmm_torch.tools.ablate_panel [large_25605 ...]
        [--width 256] [--repeats 20] [--strips 16,32,64] [--tm 8,16,32]
        [--tk 128,256,512] [--natural] [--device cuda]

On a CPU device (``--device cpu``) the times are the host clock's
(``"timer": "host"``), which says nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

DEFAULT_CASES = ("large_25605", "large_21074", "large_20000", "medium_4096",
                 "large_15120")
# pair geometries timed per matrix: the pair search's cheapest first
PAIR_CANDIDATES = 4


def time_ms(fn, b: torch.Tensor, iters: int) -> float:
    """Device time of ``fn`` on a card (CUDA graph replay), the host
    clock's median on a CPU device (``fn`` has run once already)."""
    from tpuspmm_torch.utils.timing import graph_time_ms, serve_time_ms

    if b.device.type == "cuda":
        return graph_time_ms(fn, iters=iters)
    return serve_time_ms(lambda _: fn(), b, iters=iters)


def panel_geometries(args) -> list:
    """(label, resolver kwargs) of every panel geometry to ablate."""
    out = [("auto", {})]
    out += [(f"P{s}", {"panel_strips": int(s)})
            for s in args.strips.split(",") if s]
    out += [(f"tm{t}", {"tm": int(t)}) for t in args.tm.split(",") if t]
    out += [(f"tk{t}", {"tk": int(t)}) for t in args.tk.split(",") if t]
    if args.natural:
        out.append(("natural", {"reorder_rows": False}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("cases", nargs="*", default=list(DEFAULT_CASES))
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--strips", default="16,32,64",
                   help="pinned P values to ablate against auto")
    p.add_argument("--tm", default="",
                   help="comma list of strip heights to ablate (e.g. "
                        "8,16,32); empty = the geometry search's pick only")
    p.add_argument("--tk", default="",
                   help="comma list of k-tile widths to ablate (e.g. "
                        "128,256,512)")
    p.add_argument("--natural", action="store_true",
                   help="also ablate the geometry searched in the natural "
                        "row order (no un-permute: varies the gather term)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from tpuspmm_torch.data import data_dir
    from tpuspmm_torch.formats import convert
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm
    from tpuspmm_torch.kernels.common import round_up
    from tpuspmm_torch.ops import oracle, vendor
    from tpuspmm_torch.utils.compare import allclose
    from tpuspmm_torch.utils.timing import card_line, serve_time_ms

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line() if device.type == "cuda" else "cpu"
    timer = "cuda_graph" if device.type == "cuda" else "host"
    print(json.dumps({"tool": "ablate_panel", "card": card,
                      "torch": torch.__version__, "timer": timer,
                      "width": args.width}), flush=True)
    n_pad = round_up(args.width, 128)
    cap = panel_spmm.PLAN_BYTES_CAP
    rc = 0
    for name in args.cases:
        d = data_dir(name)
        if d is None:
            print(json.dumps({"matrix": name, "error": "no data dir"}))
            rc = 1
            continue
        a = convert.load_sparse(d, "csr")
        rng = np.random.default_rng(11)
        b_np = rng.uniform(-1, 1, (a.shape[1], args.width)).astype(
            np.float32)
        b = torch.from_numpy(b_np).to(device)
        ref = oracle.spmm_scipy_oracle(a, b_np)
        # the library call allocates its workspace, so it is timed by
        # events around back-to-back calls (the host clock on a CPU), not
        # in a graph
        vendor_ms = serve_time_ms(lambda bb: vendor.spmm_vendor(a, bb), b,
                                  iters=args.repeats)
        base = {"matrix": name, "m": int(a.shape[0]), "n": int(args.width),
                "vendor_ms": vendor_ms, "timer": timer}

        for label, kwargs in panel_geometries(args):
            geom = panel_spmm.resolve_panel_geometry(
                a, n_pad, plan_bytes_cap=cap, device=device, **kwargs)
            if geom is None:
                print(json.dumps({**base, "kernel": "panel", "geom": label,
                                  "error": "inadmissible"}), flush=True)
                continue
            plan = panel_spmm.panel_plan_from_geometry(a, geom)
            val_bytes = 2 if plan.a_dense.dtype == np.uint16 else 4
            for mode in ("highest", "split2"):
                def fn(md=mode):
                    return panel_spmm.spmm_panel(plan, b, mode=md)

                ok = allclose(fn(), ref)
                rc |= 0 if ok or mode == "split2" else 1
                print(json.dumps({
                    **base, "kernel": "panel", "geom": label, "mode": mode,
                    "P": geom.panel_strips, "tm": geom.tm, "tk": geom.tk,
                    "sm": geom.sm, "perm": geom.row_perm is not None,
                    "order": geom.order_kind,
                    "plan_mb": round(plan.plan_bytes / 1e6, 2),
                    "dtype": "bf16" if val_bytes == 2 else "f32",
                    # model-fit inputs (tools/fit_panel_model.py)
                    "strips": int(plan.offs.size),
                    "steps": int(plan.n_panels),
                    "strip_bytes": int(plan.tm * plan.tk * val_bytes),
                    "cost_us": geom.cost_us,
                    "ms": time_ms(fn, b, args.repeats),
                    "correct": bool(ok)}), flush=True)

        for i, g in enumerate(pair_spmm.resolve_pair_geometry_candidates(
                a, n_pad, k=PAIR_CANDIDATES, plan_bytes_cap=cap,
                device=device)):
            plan = pair_spmm.pair_plan_from_container(
                a, chunk_strips=g.chunk_strips, n_pad=n_pad, geom=g,
                device=device)
            val_bytes = 2 if plan.a_dense.dtype == np.uint16 else 4

            def fn():
                return pair_spmm.spmm_pair(plan, b)

            ok = allclose(fn(), ref)
            rc |= 0 if ok else 1
            print(json.dumps({
                **base, "kernel": "pair", "geom": f"pair{i}",
                "mode": "highest", "CH": g.chunk_strips, "tm": plan.tm,
                "tk": plan.tk, "sm": g.sm,
                "perm": g.row_perm is not None, "order": g.order_kind,
                "plan_mb": round(plan.plan_bytes / 1e6, 2),
                "dtype": "bf16" if val_bytes == 2 else "f32",
                "strips": int(plan.n_strips),
                "steps": int(plan.chunk_arrays()[0].shape[0]),
                "strip_bytes": int(plan.tm * plan.tk * val_bytes),
                "cost_us": g.cost_us,
                "ms": time_ms(fn, b, args.repeats),
                "correct": bool(ok)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
