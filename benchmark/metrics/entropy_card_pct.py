"""host entropy: of the Layer III clips the window decoded, the percentage
whose entropy the card decoded (M0; the port's counters
``mp3_card_streams`` and ``mp3_host_streams``, one a clip by where its
entropy ran); None where neither was counted (an untraced run, or a port
without them)."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None:
        return None
    card = sum(r.counters.get("mp3_card_streams", 0) for r in reqs)
    host = sum(r.counters.get("mp3_host_streams", 0) for r in reqs)
    if card + host == 0:
        return None
    return 100.0 * card / (card + host)
