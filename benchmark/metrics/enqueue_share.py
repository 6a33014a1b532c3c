"""dense kernels: the share of the window in the port's ``enqueue`` spans
(each chunk's kernel-wrapper calls with their allocations), by self
time."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("enqueue",))
