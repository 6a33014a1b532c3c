"""lane packing + copies: the share of the window in the port's ``h2d``
and ``d2h`` spans, the host blocked on copies to and from the card (a
``d2h`` includes the wait for the kernels queued before it), by self
time."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("h2d", "d2h"))
