"""device_idle_pct: the share of the traced window in which no kernel, copy
or set ran on the device (torch.profiler's trace)."""


def read(ctx):
    if ctx.trace is None or ctx.traced_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.traced_s)
