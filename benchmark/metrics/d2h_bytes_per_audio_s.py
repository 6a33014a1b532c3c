"""lane packing + copies: bytes the port copied back from the card (its
counter ``d2h_bytes``) over the seconds of audio the window decoded."""

from benchmark.metrics._program import per_audio_s

WRAPS = []


def read(ctx):
    return per_audio_s(ctx, "d2h_bytes")
