"""idle.blend_ms: idle device ms per traced step whose gap's midpoint lies in
the stage blend (render.blend, render.blend_backward; portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "blend")
