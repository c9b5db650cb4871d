"""dataio.host_ms: host ms per traced step inside the program's
trainer.next_train span (engine/trainer.py), the in-program twin of
dataio.wait_ms."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "trainer.next_train")
