"""facade / routing: host milliseconds in ``batch._probe`` (self time)
per stream decoded in the window."""

WRAPS = ["symphonia_tpu_torch.batch:_probe"]


def read(ctx):
    if not ctx.calls.get(WRAPS[0]) or not ctx.streams:
        return None
    return ctx.self_s[WRAPS[0]] * 1e3 / ctx.streams
