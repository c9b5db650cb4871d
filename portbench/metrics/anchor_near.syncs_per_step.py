"""anchor_near.syncs_per_step: stream and event synchronizes and blocking
memcpys of the CUDA runtime per traced step inside scaffold.near_render or
scaffold.multiview, marked by a sync.* span or not
(portbench/multiview.py)."""
from portbench import multiview

SPANS = ["scaffold.near_render", "scaffold.multiview"]


def read(ctx):
    return multiview.waits(ctx, SPANS)
