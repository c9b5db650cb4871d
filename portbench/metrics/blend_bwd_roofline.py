"""blend_bwd_roofline: the least time the blend_bwd kernel's work needs on these
inputs (portbench/counts.py) over its device time per traced step, by the
kernel's name blend_bwd_kernel in the trace."""
from portbench import counts

KERNEL = "blend_bwd_kernel"
WORK = "blend_bwd"


def read(ctx):
    if ctx.trace is None or ctx.work is None or WORK not in ctx.work:
        return None
    t = ctx.trace.kernel_seconds(KERNEL) / ctx.traced_steps
    if t <= 0:
        return None
    w = ctx.work[WORK]
    return 100.0 * counts.least_seconds(w["ops"], w["bytes"]) / t
