"""dense kernels: M0 ``mp3_entropy``'s share of its roofline. Its least
time is its bytes at ``peaks.json``'s rate (``benchmark.work.bound_s``):
the frame bytes it read (the port's counter ``mp3_card_bytes``) and, for
each lane it wrote (``mp3_card_lanes``), 576 float32 values and a block
type and a mixed flag counted at 4 bytes each; over its kernel's own rows
of the trace's ``device_ops``. None where either is missing (an untraced
run, or a port without M0)."""

from benchmark.metrics._program import window
from benchmark.work import bound_s

WRAPS = []
KERNEL = "mp3_entropy_kernel"
LANE_BYTES = 576 * 4 + 8


def read(ctx):
    if ctx.trace is None:
        return None
    reqs = window(ctx)
    if reqs is None:
        return None
    nbytes = sum(r.counters.get("mp3_card_bytes", 0)
                 + LANE_BYTES * r.counters.get("mp3_card_lanes", 0)
                 for r in reqs)
    if nbytes <= 0:
        return None
    device_s = sum(s for name, s in ctx.trace["breakdown"]["device_ops"]
                   if KERNEL in name)
    if device_s <= 0:
        return None
    return 100.0 * bound_s(nbytes, 0) / device_s
