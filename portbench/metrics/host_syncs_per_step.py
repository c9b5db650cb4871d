"""host_syncs_per_step: the program's sync.* spans per traced step, one around
each host sync with the device (gssr_tpu_torch/utils/tracing.py lists the
sites)."""
from portbench import spans


def read(ctx):
    return spans.syncs_per_step(ctx)
