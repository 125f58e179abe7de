"""The tile_walk kernel's share of its roofline, in %: the least time of the
profiled window's tile_walk queries by bytes (`roofline.query_bytes`) at
3.35 TB/s, over the kernel's device time in the trace."""
from portbench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.roofline_pct(ctx.trace, "tile_walk")
