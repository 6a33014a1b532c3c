"""stitch / verify: the share of the window in FLAC's STREAMINFO MD5
check (``batch._flac_md5_ok``, self time)."""

WRAPS = ["symphonia_tpu_torch.batch:_flac_md5_ok"]


def read(ctx):
    return ctx.share(WRAPS)
