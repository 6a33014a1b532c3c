"""stitch / verify: of the bytes F3 hashed on the card in the window, the
percentage on its serial chains: 100 x the port's counter
``md5_chain_bytes`` (each F3 launch's largest row: the one stream whose
bytes the launch waits for) over ``md5_card_bytes`` (every row's bytes).
100 / S where a launch's S streams hash alike, 100 where one stream holds
every launch. None where either counter is missing or zero (an untraced
run, every MD5 on the host, or a port without them)."""

from benchmark.metrics._program import window

WRAPS = []


def read(ctx):
    reqs = window(ctx)
    if reqs is None:
        return None
    chain = sum(r.counters.get("md5_chain_bytes", 0) for r in reqs)
    card = sum(r.counters.get("md5_card_bytes", 0) for r in reqs)
    if not chain or not card:
        return None
    return 100.0 * chain / card
