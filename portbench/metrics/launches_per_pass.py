"""Kernel launches a pass: kernel events in the profiled window over its
passes (host dispatch of `render.render` / `render_pass_fn`)."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.trace.units
