"""stitch / verify: of the Layer III clips whose entropy the window decoded
(the port's counters ``mp3_card_streams`` and ``mp3_host_streams``, one a
clip), the percentage whose trimmed planar PCM the card laid out (M3
``mp3_place``; counter ``mp3_placed_streams``); None where none was
counted (an untraced run, or a port without M3)."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None or not any("mp3_placed_streams" in r.counters
                               for r in reqs):
        return None
    placed = sum(r.counters.get("mp3_placed_streams", 0) for r in reqs)
    clips = sum(r.counters.get("mp3_card_streams", 0)
                + r.counters.get("mp3_host_streams", 0) for r in reqs)
    if clips == 0:
        return None
    return 100.0 * placed / clips
