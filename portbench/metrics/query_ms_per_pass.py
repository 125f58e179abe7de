"""Ms a pass in the intersection queries (`ops/intersect` and the
accelerators): CUDA events around every `closest_hit`, `any_hit` and
`shadow_hit_surface` call of the spans window, over its passes."""


def read(ctx):
    if (ctx.kind != "render" or ctx.spans is None
            or ctx.spans["query_ms"] is None or not ctx.spans["queries"]):
        return None
    return ctx.spans["query_ms"] / ctx.spans["passes"]
