"""Device ms a step launched inside the texel gradient's backward: the
`grad.take` spans of table `texel_pool` (`ops/fast_grad.take`'s one-hot
reduction onto the texture pool), from the program window's trace, whose
`grad.take` ranges the grad kind names by their tables."""
from portbench import program_trace

SPAN = "grad.take.texel_pool"


def read(ctx):
    if ctx.kind != "grad":
        return None
    prog = program_trace.read(ctx)
    if prog is None or not any(program_trace._under(p, SPAN)
                               for p in prog.busy):
        return None
    return program_trace.ms_per_unit(prog, "busy", SPAN)
