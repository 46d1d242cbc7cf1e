"""Splice re-run sweep groups into an existing sweep's records.

The port's own copy of ``bench/splice_sweep.py`` (standard library only,
the same output).  Replaces every (testcase, format) group that appears
in the PART file with the part file's records, keeping all other groups:
the repair path for a faulted group without re-running the whole corpus.
The reference's append-only .json (reference/test/csr.sh:3-14) has none.

Usage::

    python -m tpuspmm_torch.sweeps.splice_sweep \
        --into tpuspmm_torch/sweeps/h100/formats.jsonl --part PART.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def splice(into_path: str, part_path: str) -> dict:
    with open(part_path) as f:
        part = [json.loads(line) for line in f if line.strip()]
    groups = {(r.get("testcase"), r.get("format")) for r in part}
    kept, dropped = [], 0
    with open(into_path) as f:
        lines = f.readlines()
    for line in lines:
        if not line.strip():
            continue
        r = json.loads(line)
        if (r.get("testcase"), r.get("format")) in groups:
            dropped += 1
        else:
            kept.append(line.rstrip("\n"))
    kept += [json.dumps(r) for r in part]
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(into_path) or ".")
    with os.fdopen(fd, "w") as f:
        f.write("\n".join(kept) + "\n")
    os.replace(tmp, into_path)  # atomic: never a half-written artifact
    return {"groups_replaced": sorted(f"{t}/{fm}" for t, fm in groups),
            "records_dropped": dropped, "records_added": len(part),
            "records_total": len(kept)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--into", required=True, help="artifact to repair")
    p.add_argument("--part", required=True, help="re-run group records")
    args = p.parse_args(argv)
    print(json.dumps(splice(args.into, args.part)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
