"""binning.expand_ms: device ms per traced step of bin_expand_kernel
(gssr_tpu_torch/csrc/binning.cu, binning's instance expansion), from the
trace; a program without the kernel reads nothing."""

KERNEL = "bin_expand_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    s = ctx.trace.kernel_seconds(KERNEL)
    return 1e3 * s / ctx.traced_steps if s > 0 else None
