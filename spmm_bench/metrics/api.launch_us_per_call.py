"""API and served handle: the served handle's launch in one ``spmm`` call
(B's checks, C's allocation, the stream, the kernel's launch: the
program's spans ``tpuspmm_torch.launch.<route>`` in
``kernels/dispatch.spmm_pallas``, every route together), in microseconds,
mean.  The program enters them only while a profiler records, so the mean
is over the calls of the traced run's profiled steps (the device-only pass
and the named pass), under the profiler's own cost: not comparable with
``api.host_us_per_call``, timed with no profiler.  Nothing where the
program records no such span."""

import sys

PREFIX = "tpuspmm_torch.launch."


def read(ctx):
    prof = sys.modules.get("tpuspmm_torch.utils.profiling")
    snapshot = getattr(prof, "snapshot", None)
    spans = [v for k, v in (snapshot() if snapshot else {}).items()
             if k.startswith(PREFIX)]
    count = sum(c for c, _ in spans)
    return sum(s for _, s in spans) / count * 1e6 if count else None
