"""idle.prefilter_ms: idle device ms per traced step whose gap's midpoint lies
in the stage prefilter (scaffold.prefilter; portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "prefilter")
