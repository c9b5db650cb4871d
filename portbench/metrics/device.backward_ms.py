"""device.backward_ms: device ms per traced step of the kernels, copies and
sets launched in the stage backward (`*.backward` outside the render spans
of autograd's thread: autograd's own backward of projection, SH, SSIM and
decode; portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "backward")
