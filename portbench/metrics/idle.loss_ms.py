"""idle.loss_ms: idle device ms per traced step whose gap's midpoint lies in
the stage loss (vanilla.loss, pgsr.loss, scaffold.loss; portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "loss")
