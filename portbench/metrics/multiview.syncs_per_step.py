"""multiview.syncs_per_step: stream and event synchronizes and blocking memcpys
of the CUDA runtime per traced step inside pgsr.near_render or
pgsr.multiview, marked by a sync.* span or not (portbench/multiview.py)."""
from portbench import multiview


def read(ctx):
    return multiview.waits(ctx, [multiview.NEAR, multiview.TERMS])
