"""device.gather_bwd_ms: device ms per traced step of the kernels, copies and
sets launched in the stage gather_bwd (render.gather_backward;
portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "gather_bwd")
