"""lane packing + copies: the share of the traced window in which a
host-to-device or device-to-host copy ran on the card (the union of the
profiler's memcpy intervals)."""

WRAPS = []


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace["copy_s"] / ctx.trace["window_s"]
