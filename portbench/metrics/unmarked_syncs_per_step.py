"""unmarked_syncs_per_step: stream and event synchronizes and blocking memcpys
of the CUDA runtime per traced step that lie in no sync.* span of the
program (the harness's cudaDeviceSynchronize is not one); 0 when the
program's sync counter is complete."""
from portbench import spans


def read(ctx):
    return spans.unmarked_per_step(ctx)
