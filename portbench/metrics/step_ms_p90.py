"""step_ms_p90: the nearest-rank 90th percentile of every window step's time,
each step timed between CUDA events recorded after it and after the step
before: the steps that host syncs and stalls hold up."""


def read(ctx):
    s = sorted(ctx.step_s)
    return 1e3 * s[max(0, -(-9 * len(s) // 10) - 1)]
