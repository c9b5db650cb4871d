"""step_mfu_pct: the FP32 operations a step needs (portbench/counts.py, from
the pairs the configuration's reference finds on sampled traced steps) over
the traced steps' mean time times the FP32 peak."""
from portbench import counts


def read(ctx):
    if ctx.work is None or not ctx.traced_steps:
        return None
    step_s = ctx.traced_s / ctx.traced_steps
    return 100.0 * ctx.work["step"]["ops"] / (step_s * counts.PEAK_FP32_OPS)
