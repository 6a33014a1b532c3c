"""What the MP3 kernels' roofline readers share: the least time of a
kernel's work, from the port's counters ``mp3_lanes`` and ``mp3_frames``
over the traced window (``benchmark/work/mp3.py`` at ``peaks.json``'s
rates), over that kernel's device time in the trace (its rows among the
trace's ``device_ops``); None where either is missing."""

from benchmark.metrics._program import window


def roofline(ctx, kernel: str, least):
    if ctx.trace is None:
        return None
    reqs = window(ctx)
    if reqs is None:
        return None
    work = [(r.counters.get("mp3_lanes", 0), 2 * r.counters.get(
        "mp3_frames", 0)) for r in reqs]
    if not any(lanes for lanes, _ in work):
        return None
    device_s = sum(s for name, s in ctx.trace["breakdown"]["device_ops"]
                   if kernel in name)
    if device_s <= 0:
        return None
    return 100.0 * sum(least(l, g) for l, g in work if l) / device_s
