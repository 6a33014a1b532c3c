"""dense kernels: the port's kernel launches (``ops._build.LAUNCHES``, all
kernels) in the window, per stream decoded."""

WRAPS = []


def read(ctx):
    if not ctx.streams:
        return None
    return ctx.launches / ctx.streams
