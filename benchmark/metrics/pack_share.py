"""lane packing + copies: the share of the window in the port's ``pack``
spans (the pooled extraction copied out, the streams' lanes padded and
concatenated, the chunks sliced), by self time."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("pack",))
