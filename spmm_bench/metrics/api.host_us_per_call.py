"""API and served handle: host time of one ``spmm`` call, from entry to
return (enqueue only), in microseconds: the harness's spans around every
call of the traced run's window, mean."""


def read(ctx):
    if not ctx.calls:
        return None
    return ctx.call_host_s / ctx.calls * 1e6
