"""End to end (bulk): seconds of audio of every request completed in the
window over the window's wall time (stretched to the end of the last
request that started before the deadline)."""

WRAPS = []


def read(ctx):
    if not ctx.requests:
        return None
    return ctx.audio_s / ctx.window_s
