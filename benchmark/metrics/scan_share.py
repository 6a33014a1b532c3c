"""demux: the share of the window in the port's ``scan`` spans (the MPEG
audio reader's construction: its frame-table walk, one header parse a
frame, in the probe and again when the decoder opens the stream), by
self time; None where the port records no such span."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None or ctx.window_s <= 0:
        return None
    if not any(r.calls.get("scan") for r in reqs):
        return None
    ns = sum(r.self_ns.get("scan", 0) for r in reqs)
    return 100.0 * ns * 1e-9 / ctx.window_s
