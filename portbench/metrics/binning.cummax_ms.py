"""binning.cummax_ms: device ms per traced step of the kernels that
aten::cummax launches (ops/binning.py's running max), from the trace."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    s = ctx.trace.op_device_seconds("aten::cummax")
    return 1e3 * s / ctx.traced_steps if s > 0 else None
