"""Kernel launches a train step: kernel events in the profiled window over
its steps (host dispatch of `parallel.make_train_step`)."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.trace.units
