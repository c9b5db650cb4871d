"""idle.backward_ms: idle device ms per traced step whose gap's midpoint lies
in the stage backward (`*.backward` outside the render spans of autograd's
thread: autograd's own backward of projection, SH, SSIM and decode;
portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "backward")
