"""dense kernels: F1 ``flac_lpc``'s share of its roofline: its bytes over
the lanes the window sent (the port's counters ``flac_lanes`` and
``flac_lane_samples``) at 3.35 TB/s, over its kernel's own rows of the
trace (``flac_lpc_kernel``; the lane-order helper's are not counted)."""

from benchmark.metrics._flac_roofline import roofline
from benchmark.work.flac_music import lpc_bytes

WRAPS = []


def read(ctx):
    return roofline(ctx, "flac_lpc_kernel", "flac_lanes",
                    "flac_lane_samples", lpc_bytes)
