"""dense kernels: M1 ``mp3_hybrid``'s share of its roofline, the least
time of its work over the lanes the window sent (``mp3_lanes``) over its
kernel's device time in the trace."""

from benchmark.metrics._mp3_roofline import roofline
from benchmark.work.mp3 import hybrid_s

WRAPS = []


def read(ctx):
    return roofline(ctx, "mp3_hybrid_kernel", hybrid_s)
