"""Idle ms a train step of the device while the program's innermost span lay
inside the step's forward (`train.forward`), from the program window's
trace."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "train":
        return None
    return program_trace.ms_per_unit(program_trace.read(ctx),
                                     "idle", "train.forward")
