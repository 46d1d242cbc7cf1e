"""Dispatch and plans: each served handle's binding, summed over the run,
in seconds: the program's span ``tpuspmm_torch.served.bind``
(``kernels/dispatch._launch``: the plan's device arrays, K6's term planes,
the kernel's launch bound once), read from its table of spans in this
process.  Nothing where the program records no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("tpuspmm_torch.utils.profiling")
    snapshot = getattr(prof, "snapshot", None)
    count, seconds = (snapshot() if snapshot else {}).get(
        "tpuspmm_torch.served.bind", (0, 0.0))
    return seconds if count else None
