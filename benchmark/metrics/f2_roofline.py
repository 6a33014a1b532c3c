"""dense kernels: F2 ``flac_decorrelate``'s share of its roofline: its
bytes over the stereo frames the window sent (the port's counters
``flac_stereo_frames`` and ``flac_stereo_samples``) at 3.35 TB/s, over its
kernel's own rows of the trace (``flac_decorrelate_kernel``)."""

from benchmark.metrics._flac_roofline import roofline
from benchmark.work.flac_music import decorrelate_bytes

WRAPS = []


def read(ctx):
    return roofline(ctx, "flac_decorrelate_kernel", "flac_stereo_frames",
                    "flac_stereo_samples", decorrelate_bytes)
