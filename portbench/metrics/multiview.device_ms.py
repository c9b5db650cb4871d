"""multiview.device_ms: device ms per traced step of the kernels, copies and
sets launched inside the program's pgsr.multiview span: the forward of the
normal, geo and NCC terms (portbench/multiview.py)."""
from portbench import multiview


def read(ctx):
    return multiview.device_ms(ctx, [multiview.TERMS])
