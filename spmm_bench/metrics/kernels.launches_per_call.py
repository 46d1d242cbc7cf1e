"""Kernels: device operations (kernels, copies, sets) in the traced window
per ``spmm`` call traced."""


def read(ctx):
    seg = ctx.segment
    if seg is None or not seg.calls or not seg.device_ops:
        return None
    return len(seg.device_ops) / seg.calls
