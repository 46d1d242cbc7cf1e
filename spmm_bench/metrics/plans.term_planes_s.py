"""Dispatch and plans: K6's term planes built on the host, summed over the
run, in seconds: the program's span ``tpuspmm_torch.bsr.term_planes``
(``kernels/bsr_spmm.term_planes``, inside the binding of a BSR operand
served on the card), read from its table of spans in this process.
Nothing where the program records no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("tpuspmm_torch.utils.profiling")
    snapshot = getattr(prof, "snapshot", None)
    count, seconds = (snapshot() if snapshot else {}).get(
        "tpuspmm_torch.bsr.term_planes", (0, 0.0))
    return seconds if count else None
