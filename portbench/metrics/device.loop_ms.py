"""device.loop_ms: device ms per traced step of the kernels, copies and sets
launched in the stage loop (trainer.log, trainer.densify, and every time in
no stage span (the loop's glue, the camera upload, the harness's callback);
portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "loop")
