"""Device ms a train step of the work launched inside autograd's backward
(`evaluate_function` ranges): the backward through `integrators/mc` and
`ops/fast_grad.take`."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.trace.backward_s <= 0:
        return None
    return 1e3 * ctx.trace.backward_s / ctx.trace.units
