"""dense kernels: M2 ``mp3_synth``'s share of its roofline, the least
time of its work over the lanes the window sent (``mp3_lanes``) over its
kernel's device time in the trace (the 18-slot instance of the synthesis
kernel; L1's 12- and 36-slot instances are not M2)."""

from benchmark.metrics._mp3_roofline import roofline
from benchmark.work.mp3 import synth_s

WRAPS = []


def read(ctx):
    return roofline(ctx, "synth_kernel<18", synth_s)
