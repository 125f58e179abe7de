"""The share of live lanes, in %: 100 x the program's `lanes.live` (lanes
whose t-range is not empty) over `lanes.total`, summed over every
intersection query of the program window's passes. Dead lanes still run
through shading; the share says what compaction could save."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "render":
        return None
    prog = program_trace.read(ctx)
    if prog is None or not prog.counts.get("lanes.total"):
        return None
    return 100.0 * prog.counts.get("lanes.live", 0) / prog.counts[
        "lanes.total"]
