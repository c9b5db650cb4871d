"""anchor.prefilter_ms: host ms per traced step inside the program's
`scaffold.prefilter` profiler range (scene/scaffold.py): the anchor
prefilter with its LOD mask."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    s = ctx.trace.host_seconds("scaffold.prefilter")
    return 1e3 * s / ctx.traced_steps if s > 0 else None
