"""Idle ms a pass of the device while the program's innermost span lay inside
`render.pass` and outside every intersection query, from the program
window's trace."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    return program_trace.ms_per_unit(program_trace.read(ctx),
                                     "idle", "render.pass", "intersect.")
