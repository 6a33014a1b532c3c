"""host entropy: the share of the window in the port's ``extract`` spans
(every batch decoder's native entropy stage, read from the span itself,
not from a wrapper of one decoder's method), by self time."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("extract",))
