"""Ms a pass in the block accelerator's prepass (`accel/tiles.
tile_candidates`): CUDA events around its calls in the spans window."""


def read(ctx):
    if ctx.kind != "render" or ctx.spans is None:
        return None
    if not ctx.spans["prepass_calls"] or ctx.spans["prepass_ms"] is None:
        return None
    return ctx.spans["prepass_ms"] / ctx.spans["passes"]
