"""device.update_ms: device ms per traced step of the kernels, copies and sets
launched in the stage update (`*.adam`, `*.stats`; portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "update")
