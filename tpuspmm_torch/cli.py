"""tpuspmm_torch's command line: the CSR, COO, BSR and ELL engines.

Counterpart of ``tpuspmm/cli.py`` (the reference's ``cuspmm``,
reference/src/main.cu:19-217): per-format flags, a data directory with the
reference's file discovery, one JSON record per run on stdout, and exit
status 1 when a variant that is not verified-only fails the gate.

``--device`` (default ``cuda``) is where the engine runs; with no such
device the command exits non-zero and never moves to the CPU by itself.
``--auto`` runs the engine of the format that ``engine/select.py`` picks
for the directory's matrix (read from its `.coo` or `.mtx`, else from the
first of its `.csr`, `.bsr` and ELL files), and names the pick on stderr.
``--tuned`` autotunes each format (``engine/autotune.py``) and prints one
record per format: the winner's number and name, its ranked time, the
ranking, and ``correct`` from a fresh gate check of the winner; exit 1
when nothing passes or the winner fails.  ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of the run into DIR
(``utils/profiling.py``).

Usage::

    python -m tpuspmm_torch.cli --csr --coo -d data/large_25605 --width 256
    python -m tpuspmm_torch.cli --bsr --ell -d data/medium_4096
    python -m tpuspmm_torch.cli --auto -d data/large_25605 --width 256
    python -m tpuspmm_torch.cli --csr --tuned -d data/large_25605 --width 256
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuspmm_torch",
        description="SpMM verification and timing on an NVIDIA GPU "
                    "(reference: cuspmm --csr --coo -d DIR)")
    p.add_argument("--csr", action="store_true", help="run the CSR engine")
    p.add_argument("--coo", action="store_true", help="run the COO engine")
    p.add_argument("--bsr", action="store_true", help="run the BSR engine")
    p.add_argument("--ell", action="store_true", help="run the ELL engine")
    p.add_argument("--auto", action="store_true",
                   help="run the engine of the format the selection picks")
    p.add_argument("-d", "--data-dir", required=True,
                   help="data directory (reference layout) or corpus name")
    p.add_argument("--width", type=int, default=None,
                   help="dense-operand width when synthesising B")
    p.add_argument("--synth-b", action="store_true",
                   help="ignore on-disk dense operands; synthesise B of "
                        "--width")
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="dense-operand dtype; with bf16 the gate checks "
                        "every variant against the f64 oracle of the bf16 "
                        "operand")
    p.add_argument("--skip-seq", action="store_true",
                   help="skip the sequential oracle (verify vs scipy)")
    p.add_argument("--no-vendor", action="store_true",
                   help="skip the torch.sparse (cuSPARSE) baseline")
    p.add_argument("--repeats", type=int, default=3,
                   help="steady-state timing repeats")
    p.add_argument("--kernel", type=int, default=None,
                   help="run only this kernel number (-1/0/1..N)")
    p.add_argument("--out", type=str, default=None,
                   help="append JSON records to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--tuned", action="store_true",
                   help="autotune: check and time every admissible "
                        "variant, emit one record with the winner and the "
                        "ranking")
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run to "
                        "this directory")
    return p


def _run_one_kernel(engine, number: int, a, b, config, device,
                    repeats: int, common: dict) -> dict:
    """The reference's single-kernel run: first call, timed calls, the
    gate against the scipy oracle."""
    import torch

    from tpuspmm_torch.engine import report
    from tpuspmm_torch.engine.runner import timed_run
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.utils.compare import allclose

    b_dev = b.to(device).contiguous()
    host, prolog, kernel, epilog, per_call = timed_run(
        lambda bb: engine.run_kernel(number, a, bb, config), b_dev, repeats)
    ok = allclose(host, oracle.spmm_scipy_oracle(a, b.float().numpy()))
    name = (engine.variant(number).name if number > 0 else
            {0: "oracle_numpy_f64", -1: "torch_sparse_csr"}.get(number, ""))
    return report.make_record(
        kernel_type=number, kernel_name=name, correct=ok, prolog_ms=prolog,
        kernel_ms=kernel, epilog_ms=epilog,
        extra={"perCallLatencyMs": round(per_call, 4),
               "timer": ("cuda_events" if torch.device(device).type == "cuda"
                         else "host_clock")},
        **common)


def _run_tuned(engine, a, b, config, device, repeats: int,
               common: dict) -> dict:
    """Autotune ``a`` on ``device`` and check the winner afresh."""
    from tpuspmm_torch.engine import autotune, report
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.utils.compare import allclose

    b_dev = b.to(device).contiguous()
    ranking = autotune.tune(a, b_dev, iters=max(4, repeats), config=config,
                            verbose=True)
    if not ranking:
        return {}
    win = ranking[0]
    out = engine.run_kernel(win.number, a, b_dev, config)
    ok = allclose(out, oracle.spmm_scipy_oracle(a, b.float().numpy()))
    return report.make_record(
        kernel_type=win.number, kernel_name=win.variant_name, correct=ok,
        kernel_ms=win.ms,
        extra={"tuned": "1", "ranking": [
            {"kernel": r.variant_name, "number": r.number, "ms": r.ms,
             **({"verifiedOnly": "1"} if r.verified_only else {}),
             **({"geometry": r.geom} if r.geom else {})}
            for r in ranking]},
        **common)


def _probe(data: str):
    """The matrix ``--auto`` selects for: from the `.coo` or `.mtx` as the
    JAX package's CLI reads it, else from the first of `.csr`, `.bsr` and
    the ELL pair the directory holds."""
    from tpuspmm_torch.formats import convert

    found = convert.discover(data)
    for fmt, key in (("coo", "coo"), ("coo", "mtx"), ("csr", "csr"),
                     ("bsr", "bsr"), ("ell", "ell_rowind")):
        if found[key]:
            return convert.load_sparse(data, fmt)
    raise FileNotFoundError(f"no sparse operand in {data}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.data import data_dir as resolve_dir
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.engine.runner import run_engine
    from tpuspmm_torch.formats import convert

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        print(f"bad --device {args.device!r}: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"no CUDA device for --device {args.device}", file=sys.stderr)
        return 2
    if device.type not in ("cuda", "cpu"):
        print(f"--device must be a CUDA device or cpu, got {args.device}",
              file=sys.stderr)
        return 2

    data = args.data_dir
    if not os.path.isdir(data):
        data = resolve_dir(args.data_dir)
        if data is None:
            print(f"data directory {args.data_dir!r} does not exist",
                  file=sys.stderr)
            return 2
    fmts = [f for f in ("csr", "coo", "bsr", "ell") if getattr(args, f)]
    if args.auto:
        from tpuspmm_torch.engine.select import select_format

        fmt, kernel = select_format(_probe(data), device=device)
        print(f"# auto-selected format={fmt} kernel={kernel}",
              file=sys.stderr)
        fmts = [fmt]
    if not fmts:
        print("no format requested (--csr/--coo/--bsr/--ell/--auto)",
              file=sys.stderr)
        return 2

    config = default_config()
    testcase = os.path.basename(os.path.normpath(data))
    dense = convert.load_dense(data, width=args.width,
                               force_synthetic=args.synth_b)
    b = torch.from_numpy(np.ascontiguousarray(dense.data, dtype=np.float32))
    if args.b_dtype == "bf16":
        b = b.to(torch.bfloat16)

    def provenance(rec):
        rec.setdefault("bDtype", args.b_dtype)
        rec["bSource"] = getattr(dense, "b_source", "ondisk")
        if args.width is not None:
            rec["widthArg"] = args.width
        return rec

    out_stream = open(args.out, "a") if args.out else None
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    status = 0
    if args.trace:
        from tpuspmm_torch.utils.profiling import trace

        tracing = trace(args.trace)
    else:
        tracing = contextlib.nullcontext()
    try:
        with tracing:
            for fmt in fmts:
                a = convert.load_sparse(data, fmt)
                engine = get_engine(fmt)
                common = dict(testcase=testcase, sparsity=a.sparsity,
                              fmt=fmt, nnz=a.nnz, shape=a.shape,
                              n=b.shape[1], device=device_name)
                if args.tuned:
                    rec = _run_tuned(engine, a, b, config, device,
                                     args.repeats, common)
                    if not rec:
                        print(f"# {fmt}: no variant passed tuning",
                              file=sys.stderr)
                        status = 1
                        continue
                elif args.kernel is not None:
                    rec = _run_one_kernel(engine, args.kernel, a, b, config,
                                          device, args.repeats, common)
                else:
                    records = run_engine(
                        engine, a, b, testcase=testcase, config=config,
                        skip_seq=args.skip_seq,
                        run_vendor=not args.no_vendor,
                        repeats=args.repeats, emit=False, device=device)
                    for rec in records:
                        report.emit(provenance(rec),
                                    out_stream or sys.stdout)
                    if any(rec.get("correct") == "0"
                           and rec.get("verifiedOnly") != "1"
                           for rec in records):
                        status = 1
                    continue
                report.emit(provenance(rec), out_stream or sys.stdout)
                if rec["correct"] == "0":
                    status = 1
    finally:
        if out_stream:
            out_stream.close()
    return status

if __name__ == "__main__":
    sys.exit(main())
