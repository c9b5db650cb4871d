"""dataio.wait_ms: host ms per traced step inside the dataloader's
next_train, timed by the harness's own wrapper around it."""


def read(ctx):
    if not ctx.dataio_s:
        return None
    return 1e3 * sum(ctx.dataio_s) / len(ctx.dataio_s)
