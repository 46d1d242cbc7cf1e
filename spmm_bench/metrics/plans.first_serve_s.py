"""Dispatch and plans: each operand's first ``spmm`` and a synchronize
(the route decided, its plans built and its launch bound), summed over the
cell's operands, in seconds."""


def read(ctx):
    if not ctx.first_serve_s:
        return None
    return float(sum(ctx.first_serve_s))
