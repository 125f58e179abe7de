"""Device ms a step of the work launched inside autograd's backward
(`evaluate_function` ranges) in the grad cell's profiled window: the
backward through `integrators/mc`, the glass and the texture lookups, and
`ops/fast_grad.take`."""


def read(ctx):
    if ctx.kind != "grad" or ctx.trace is None or ctx.trace.backward_s <= 0:
        return None
    return 1e3 * ctx.trace.backward_s / ctx.trace.units
