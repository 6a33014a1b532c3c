"""FLAC's kernel work (F1 and its lane-order helper; F2 decorrelates
stereo and is not on a mono stream's path).

F1 is bounded by its bytes alone: its multiply-adds are 32 x 32 + 64-bit
integer ones, for which NVIDIA publishes no peak (``chip_smoke.py`` bounds
them by a rate it measures in the run, which is no published yardstick).
"""

from . import bytes_bound_s


def work_flac_lpc(L: int, n: int):
    """(bytes, multiply-adds) of F1 over L lanes of n samples, as
    ``chip_smoke.work_flac_lpc`` counts the bytes (residuals in, samples
    out, 35 words of lane parameters)."""
    return 2 * L * n * 4 + L * 35 * 4


def work_flac_lane_order(L: int):
    return L * 32 * 4 + 2 * L * 4


def least_s(pool, idx) -> float:
    """Least seconds of the kernel work of one request over pool[idx]:
    its frames are the lanes of one merged dispatch (one channel), each
    lane as long as the longest block."""
    L = sum(len(pool[i].blocks) for i in idx)
    n = max(int(pool[i].blocks.max()) for i in idx)
    return (bytes_bound_s(work_flac_lpc(L, n))
            + bytes_bound_s(work_flac_lane_order(L)))
