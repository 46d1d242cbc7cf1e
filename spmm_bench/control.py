"""The readings that the limit of ``correct`` is set from: a cell's runs
over many seeds, the program's and the TF32 control's, in one process.

    python3 -m spmm_bench.control --workload <name> --seeds 1,2,3 \\
        --seconds 2 [--systems program,control]

Prints one JSON line a run: the seed, the system, ``correct`` and the
numbers compared (``max_rel_err`` against the configuration's limit,
``answers``).  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--systems", default="program,control")
    args = parser.parse_args(argv)

    import torch

    from spmm_bench import harness, spec
    from spmm_bench.system import Control, Program

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    systems = {"program": Program, "control": Control}
    with tempfile.TemporaryDirectory() as work:
        for name in args.systems.split(","):
            system = systems[name]()
            for seed in (int(s) for s in args.seeds.split(",")):
                r = harness.run_cell(cell, seed, args.seconds, False,
                                     "cuda:0", system, spec.ROOT,
                                     time.perf_counter(), work)
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  "system": name, "correct": r["correct"],
                                  **{k: v["value"]
                                     for k, v in r["checks"].items()}}),
                      flush=True)
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
