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
Autotuning and tracing are not ported yet: their flags exit 2 naming
ROADMAP.

Usage::

    python -m tpuspmm_torch.cli --csr --coo -d data/large_25605 --width 256
    python -m tpuspmm_torch.cli --bsr --ell -d data/medium_4096
    python -m tpuspmm_torch.cli --auto -d data/large_25605 --width 256
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_NOT_YET = {
    "tuned": "the verified autotune (ROADMAP Queue 1 item 7)",
    "trace": "profiler tracing (ROADMAP Queue 1)",
}


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
                   help=f"not yet ported: {_NOT_YET['tuned']}")
    p.add_argument("--trace", type=str, default=None,
                   help=f"not yet ported: {_NOT_YET['trace']}")
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
    asked = [f for f in ("tuned", "trace") if getattr(args, f)]
    if asked:
        print(f"--{asked[0]} is not yet ported to tpuspmm_torch: "
              f"{_NOT_YET[asked[0]]}", file=sys.stderr)
        return 2

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
    status = 0
    try:
        for fmt in fmts:
            a = convert.load_sparse(data, fmt)
            engine = get_engine(fmt)
            if args.kernel is not None:
                common = dict(testcase=testcase, sparsity=a.sparsity,
                              fmt=fmt, nnz=a.nnz, shape=a.shape,
                              n=b.shape[1],
                              device=(torch.cuda.get_device_name(device)
                                      if device.type == "cuda" else "cpu"))
                rec = _run_one_kernel(engine, args.kernel, a, b, config,
                                      device, args.repeats, common)
                report.emit(provenance(rec), out_stream or sys.stdout)
                if rec["correct"] == "0":
                    status = 1
                continue
            records = run_engine(
                engine, a, b, testcase=testcase, config=config,
                skip_seq=args.skip_seq, run_vendor=not args.no_vendor,
                repeats=args.repeats, emit=False, device=device)
            for rec in records:
                report.emit(provenance(rec), out_stream or sys.stdout)
            if any(rec.get("correct") == "0"
                   and rec.get("verifiedOnly") != "1" for rec in records):
                status = 1
    finally:
        if out_stream:
            out_stream.close()
    return status


if __name__ == "__main__":
    sys.exit(main())
