"""End to end: process start to the first timed request (imports, the
CUDA context, the built libraries, the inputs, the warm-up requests)."""

WRAPS = []


def read(ctx):
    return ctx.setup_s
