"""Device: the share of the traced window in which no device operation
ran (one less the union of their intervals over the window)."""


def read(ctx):
    seg = ctx.segment
    if seg is None or not seg.device_ops or seg.window_s <= 0:
        return None
    return 1.0 - seg.busy_s / seg.window_s
