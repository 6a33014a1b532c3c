"""device: the share of the traced window in which no kernel and no copy
ran on the card (100 less the union of their intervals)."""

WRAPS = []


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
