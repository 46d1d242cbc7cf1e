"""Dispatch and plans: each served handle's route decision, summed over the
run, in seconds: the program's span ``tpuspmm_torch.served.decide``
(``kernels/dispatch._decide``: the compensated check, ``stream_operand``,
the pricing of the admitted routes, the chosen route's plan), read from its
table of spans in this process.  Nothing where the program records no such
span."""

import sys


def read(ctx):
    prof = sys.modules.get("tpuspmm_torch.utils.profiling")
    snapshot = getattr(prof, "snapshot", None)
    count, seconds = (snapshot() if snapshot else {}).get(
        "tpuspmm_torch.served.decide", (0, 0.0))
    return seconds if count else None
