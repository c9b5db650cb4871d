"""idle.preprocess_ms: idle device ms per traced step whose gap's midpoint lies
in the stage preprocess (render.preprocess, render.color;
portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "preprocess")
