"""Candidate blocks a live tile of the block prepass: the program's
`prepass.candidates` over `prepass.live_tiles` (tiles with a live ray),
over the program window's passes."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    prog = program_trace.read(ctx)
    if prog is None or not prog.counts.get("prepass.live_tiles"):
        return None
    return prog.counts.get("prepass.candidates", 0) / prog.counts[
        "prepass.live_tiles"]
