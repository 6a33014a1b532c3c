"""stitch / verify: the share of the window in the port's ``stitch``
spans (the per-frame slices and concatenation of each chunk's output, the
per-stream split and trim), by self time; the MD5 inside is ``verify``,
read by ``md5_share``."""

from benchmark.metrics._program import share

WRAPS = []


def read(ctx):
    return share(ctx, ("stitch",))
