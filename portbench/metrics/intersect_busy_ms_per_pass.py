"""Device ms a pass of the work launched inside the program's intersection
queries (spans `intersect.*`, with the accelerators' spans inside them), from
the program window's trace (`program_trace`)."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    return program_trace.ms_per_unit(program_trace.read(ctx),
                                     "busy", "intersect.")
