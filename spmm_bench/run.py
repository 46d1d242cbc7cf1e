"""Run one cell of the benchmark on the card and print its result line.

    python3 -m spmm_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Exits 2, printing no result, without a CUDA
card (or with fewer than the cell asks for), or on a card that the table of
peaks (``counts.PEAKS``) does not hold; exits 3, printing no result, when
JAX or the JAX package was loaded by the time the window closed.  The
program's kernels build into ``build/`` of the checkout (a fixed path, so
only the first run there compiles); the program's geometry and tune caches
go to a directory made afresh under ``TMPDIR`` for each run and removed at
its end, so every run serves the default route as a fresh process would.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

# top-level module names the run must not have loaded: JAX, and the JAX
# package and its benchmarks, compared whole (``tpuspmm_torch`` passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuspmm", "bench")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def _json_number(x):
    return x if not isinstance(x, float) or math.isfinite(x) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from spmm_bench import counts, harness, spec

    root = spec.ROOT
    cell = spec.load_cell(args.workload, root)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "build", "triton"))
    work_dir = tempfile.mkdtemp(prefix="spmm_bench-",
                                dir=os.environ.get("TMPDIR") or None)
    os.environ["TPUSPMM_TORCH_GEOM_CACHE"] = os.path.join(work_dir,
                                                          "geom.json")
    os.environ["TPUSPMM_TORCH_TUNE_CACHE"] = os.path.join(work_dir,
                                                          "tune.json")
    try:
        import torch

        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
                  f"{found}", file=sys.stderr)
            return 2
        card = torch.cuda.get_device_name(0)
        print(f"card {card_line()}", file=sys.stderr)
        try:
            counts.peak(card)
        except KeyError as exc:
            print(exc, file=sys.stderr)
            return 2
        from spmm_bench.system import Program

        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", Program(),
                                  root, T_START, work_dir)
        loaded = forbidden_modules()
        if loaded:
            print(f"modules that must not load were loaded: {loaded}",
                  file=sys.stderr)
            return 3
        for name, check in result["checks"].items():
            check["value"] = _json_number(check["value"])
            print(f"check {name} {check['value']} limit {check['limit']}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
