"""anchor_near.device_ms: device ms per traced step of the kernels, copies
and sets launched inside the program's scaffold.near_render span: the
neighbour camera's prefilter, level gate, decode and render forward of the
planar anchor step (portbench/multiview.py)."""
from portbench import multiview

NEAR = "scaffold.near_render"


def read(ctx):
    return multiview.device_ms(ctx, [NEAR])
