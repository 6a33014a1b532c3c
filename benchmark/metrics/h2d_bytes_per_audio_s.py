"""lane packing + copies: bytes the port copied to the card (its counter
``h2d_bytes``) over the seconds of audio the window decoded."""

from benchmark.metrics._program import per_audio_s

WRAPS = []


def read(ctx):
    return per_audio_s(ctx, "h2d_bytes")
