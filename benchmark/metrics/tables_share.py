"""dense kernels: the share of the window in the port's ``tables`` spans
(an MPEG audio decoder's constant operators built at their first use in
a call, by self time; their uploads are ``h2d`` spans under it, counted in
``h2d_bytes``); None where the port records no such span."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None or ctx.window_s <= 0:
        return None
    if not any(r.calls.get("tables") for r in reqs):
        return None
    ns = sum(r.self_ns.get("tables", 0) for r in reqs)
    return 100.0 * ns * 1e-9 / ctx.window_s
