"""launches_per_step: kernels on the device per traced step (the trace's
kernel events; copies and sets are not launches)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    return len(ctx.trace.kernels()) / ctx.traced_steps
