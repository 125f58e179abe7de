"""The device's idle share of the grad cell's profiled window, in %: 100 x
(1 - the union of device events / the window)."""


def read(ctx):
    if ctx.kind != "grad" or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
