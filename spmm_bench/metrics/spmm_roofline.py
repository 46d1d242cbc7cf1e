"""Kernels: the traced calls' least time (``counts.least_seconds``, from
the operand, B's width and dtype alone) over the device time of the traced
window, in percent.  Nothing without device operations or a card in the
table of peaks."""


def read(ctx):
    seg = ctx.segment
    if seg is None or not seg.busy_s or ctx.least_s is None:
        return None
    return ctx.least_s / seg.busy_s * 100.0
