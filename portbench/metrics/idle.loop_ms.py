"""idle.loop_ms: idle device ms per traced step whose gap's midpoint lies in
the stage loop (trainer.log, trainer.densify, and every time in no stage
span (the loop's glue, the camera upload, the harness's callback);
portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "loop")
