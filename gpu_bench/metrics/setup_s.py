"""Process start to the first timed iteration, in seconds."""


def read(ctx):
    return ctx.setup_s
