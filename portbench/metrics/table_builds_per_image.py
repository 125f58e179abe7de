"""Tables that `render()` builds for itself, an image: the program's
`table_builds.<table>` counts (the LBVH's packed records, an attenuation
grid, photon maps) over the program window's images (`render.image`)."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    prog = program_trace.read(ctx)
    if prog is None or not prog.images:
        return None
    return program_trace.count_sum(prog, "table_builds.") / prog.images
