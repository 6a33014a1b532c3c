"""dense kernels: the least time the window's kernel work needs at the
card's published peaks (``benchmark/work``: counted from the streams the
requests decoded, not from the launches) over the summed device time of
every kernel in the traced window."""

WRAPS = []


def read(ctx):
    if ctx.trace is None or ctx.trace["kernel_s"] <= 0:
        return None
    return 100.0 * ctx.least_kernel_s / ctx.trace["kernel_s"]
