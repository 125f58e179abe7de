"""Device ms a pass of the work launched inside `render.pass` and outside every
intersection query (camera, integrator, surfaces, materials, lights,
textures, film), from the program window's trace."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    return program_trace.ms_per_unit(program_trace.read(ctx),
                                     "busy", "render.pass", "intersect.")
