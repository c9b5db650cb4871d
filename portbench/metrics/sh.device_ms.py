"""sh.device_ms: device ms per traced step of sh_fwd_kernel and
sh_bwd_kernel (gssr_tpu_torch/csrc/sh.cu, the renders' SH colour forward
and backward), from the trace; a program without the kernels reads
nothing."""

KERNELS = ("sh_fwd_kernel", "sh_bwd_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    s = sum(ctx.trace.kernel_seconds(k) for k in KERNELS)
    return 1e3 * s / ctx.traced_steps if s > 0 else None
