"""The share of the live lanes sampled at the bounces whose sampled lobe
is delta (glass's reflection or transmission), in %: 100 x the program's
`bsdf.delta_lanes` over `bsdf.sampled_lanes`, summed over every bounce of
the program window's steps."""
from portbench import program_trace


def read(ctx):
    if ctx.kind != "grad":
        return None
    prog = program_trace.read(ctx)
    if prog is None or not prog.counts.get("bsdf.sampled_lanes"):
        return None
    return 100.0 * prog.counts.get("bsdf.delta_lanes", 0) / prog.counts[
        "bsdf.sampled_lanes"]
