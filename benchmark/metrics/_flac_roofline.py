"""What the FLAC kernels' roofline readers share: the least time of a
kernel's bytes, from two of the port's counters summed over the traced
window (``benchmark/work/flac_music.py`` at ``peaks.json``'s rate), over
that kernel's own rows of the trace's ``device_ops``; None where the
counters or the rows are missing (an untraced run, a port without the
counters, or a window in which the kernel did not run)."""

from benchmark.metrics._program import window
from benchmark.work import bytes_bound_s


def roofline(ctx, kernel: str, count: str, samples: str, nbytes):
    if ctx.trace is None:
        return None
    reqs = window(ctx)
    if reqs is None:
        return None
    n = sum(r.counters.get(count, 0) for r in reqs)
    s = sum(r.counters.get(samples, 0) for r in reqs)
    if n <= 0 or s <= 0:
        return None
    device_s = sum(t for name, t in ctx.trace["breakdown"]["device_ops"]
                   if kernel in name)
    if device_s <= 0:
        return None
    return 100.0 * bytes_bound_s(nbytes(n, s)) / device_s
