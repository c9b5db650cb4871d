"""near_render.device_ms: device ms per traced step of the kernels, copies and
sets launched inside the program's pgsr.near_render span: the neighbour
camera's render forward (portbench/multiview.py)."""
from portbench import multiview


def read(ctx):
    return multiview.device_ms(ctx, [multiview.NEAR])
