"""Dispatch and plans: served handles built per operand of the cell: the
count of the program's span ``tpuspmm_torch.served.build``
(``kernels/dispatch.served``, a miss or a rebuild on a changed row) over
the operands served.  1.0 when no handle is built twice; nothing where the
program records no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("tpuspmm_torch.utils.profiling")
    snapshot = getattr(prof, "snapshot", None)
    count, _ = (snapshot() if snapshot else {}).get(
        "tpuspmm_torch.served.build", (0, 0.0))
    if not count or not ctx.first_serve_s:
        return None
    return count / len(ctx.first_serve_s)
