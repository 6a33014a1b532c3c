"""facade / routing: the share of the window in the port's own spans
``decode_many`` (its self time: routing and the glue between layers),
``setup`` (the four batch decoders built per call), ``probe`` and ``open``
(the second parse of each stream's header), by self time."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("decode_many", "setup", "probe", "open"))
