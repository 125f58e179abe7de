"""Host syncs a pass: the program's `sync.<site>` counts (every statement
of the render path that makes the host wait for the device) over the
program window's passes."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    prog = program_trace.read(ctx)
    return None if prog is None else (
        program_trace.count_sum(prog, "sync.") / prog.units)
