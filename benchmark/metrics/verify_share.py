"""stitch / verify: the share of the window in the port's ``verify``
spans, by self time: the host's STREAMINFO MD5 of each stream it verifies
(``batch._flac_md5_ok``), or the read-back of the digests F3 computed on
the card."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("verify",))
