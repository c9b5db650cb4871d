"""anchor_near.idle_ms: idle device ms per traced step whose gap's midpoint
lies inside scaffold.near_render or scaffold.multiview, the planar anchor
step's neighbour pipeline and multi-view terms (portbench/multiview.py)."""
from portbench import multiview

SPANS = ["scaffold.near_render", "scaffold.multiview"]


def read(ctx):
    return multiview.idle_ms(ctx, SPANS)
