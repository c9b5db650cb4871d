"""step_ms: the window's seconds over the steps completed in it, through the
final synchronize (host clock). A user pays 30k steps times this."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.steps
