"""idle.gather_bwd_ms: idle device ms per traced step whose gap's midpoint lies
in the stage gather_bwd (render.gather_backward; portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "gather_bwd")
