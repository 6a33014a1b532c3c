"""stitch / verify: of the FLAC streams whose STREAMINFO MD5 the window
verified, the percentage whose MD5 the card computed (the port's counters
``md5_card_streams`` and ``md5_host_streams``); None where neither was
counted (an untraced run, or a port without them)."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None:
        return None
    card = sum(r.counters.get("md5_card_streams", 0) for r in reqs)
    host = sum(r.counters.get("md5_host_streams", 0) for r in reqs)
    if card + host == 0:
        return None
    return 100.0 * card / (card + host)
