"""API and served handle: the served handle's lookup in one ``spmm`` call
(the program's span ``tpuspmm_torch.served`` in
``kernels/dispatch.spmm_pallas``), in microseconds, mean.  The program
enters it only while a profiler records, so the mean is over the calls of
the traced run's profiled steps (the device-only pass and the named pass),
under the profiler's own cost: not comparable with
``api.host_us_per_call``, timed with no profiler.  Nothing where the
program records no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("tpuspmm_torch.utils.profiling")
    snapshot = getattr(prof, "snapshot", None)
    count, seconds = (snapshot() if snapshot else {}).get(
        "tpuspmm_torch.served", (0, 0.0))
    return seconds / count * 1e6 if count else None
