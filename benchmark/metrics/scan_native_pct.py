"""demux: of the seekable MPEG audio readers the window built (the port's
counters ``mpa_walk_native_streams`` and ``mpa_walk_host_streams``, one a
reader), the percentage whose frame table the compiled walk found; None
where neither was counted (an untraced run, or a port without the
compiled walk)."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None:
        return None
    native = sum(r.counters.get("mpa_walk_native_streams", 0) for r in reqs)
    host = sum(r.counters.get("mpa_walk_host_streams", 0) for r in reqs)
    if native + host == 0:
        return None
    return 100.0 * native / (native + host)
