"""setup_s: process start to the first timed step: scene writing, the
program's model init, kernel loading and build, the first steps."""


def read(ctx):
    return ctx.setup_s
