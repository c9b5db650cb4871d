"""blend_pgsr_fwd_roofline: the least time the blend_pgsr_fwd kernel's work needs
on these inputs (portbench/reference/pgsr.py, both renders of a step) over
its device time per traced step, by the kernel's name blend_pgsr_fwd_kernel
in the trace."""
from portbench import counts

KERNEL = "blend_pgsr_fwd_kernel"
WORK = "blend_pgsr_fwd"


def read(ctx):
    if ctx.trace is None or ctx.work is None or WORK not in ctx.work:
        return None
    t = ctx.trace.kernel_seconds(KERNEL) / ctx.traced_steps
    if t <= 0:
        return None
    w = ctx.work[WORK]
    return 100.0 * counts.least_seconds(w["ops"], w["bytes"]) / t
