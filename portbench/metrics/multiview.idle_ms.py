"""multiview.idle_ms: idle device ms per traced step whose gap's midpoint lies
inside pgsr.near_render or pgsr.multiview (portbench/multiview.py)."""
from portbench import multiview


def read(ctx):
    return multiview.idle_ms(ctx, [multiview.NEAR, multiview.TERMS])
