"""Host syncs a train step: the program's `sync.<site>` counts over the
program window's steps (the benchmark's own read of each step's loss is not
the program's and is not counted)."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "train":
        return None
    prog = program_trace.read(ctx)
    return None if prog is None else (
        program_trace.count_sum(prog, "sync.") / prog.units)
