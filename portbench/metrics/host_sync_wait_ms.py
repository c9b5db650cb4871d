"""host_sync_wait_ms: host ms per traced step inside the program's sync.*
spans: the host's wait for the device at its syncs."""
from portbench import spans


def read(ctx):
    return spans.sync_wait_ms(ctx)
