"""Ms a pass outside the queries (camera, integrator, materials, lights,
textures, film): the mean synchronised pass time of the spans window less
its queries' ms a pass."""


def read(ctx):
    if (ctx.kind != "render" or ctx.spans is None
            or ctx.spans["query_ms"] is None or not ctx.spans["passes"]):
        return None
    sp = ctx.spans
    return (sum(sp["pass_ms"]) - sp["query_ms"]) / sp["passes"]
