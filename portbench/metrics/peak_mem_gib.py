"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window,
after a reset at the run's start: which card a scene fits on."""


def read(ctx):
    return ctx.peak_bytes / float(1 << 30)
