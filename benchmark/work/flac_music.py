"""Stereo FLAC's kernel work: F1 (``flac_lpc``, with its lane-order
helper) over both subframes of every frame, and F2
(``flac_decorrelate``) over every frame. Both are bounded by their bytes
alone (F1's multiply-adds are integer ones, for which NVIDIA publishes no
peak; ``work/flac.py``)."""

from . import bytes_bound_s
from .flac import work_flac_lane_order


def lpc_bytes(lanes: int, lane_samples: int) -> int:
    """F1's bytes over ``lanes`` lanes holding ``lane_samples`` samples
    in all (the sum of L x n over its chunks): residuals in, samples out,
    35 words of lane parameters (``work_flac_lpc``)."""
    return 2 * lane_samples * 4 + lanes * 35 * 4


def decorrelate_bytes(frames: int, frame_samples: int) -> int:
    """F2's bytes over ``frames`` stereo frames of ``frame_samples``
    samples a channel in all (the sum of F x n over its chunks): [F, 2, n]
    int32 read and written, and each frame's assignment code."""
    return 16 * frame_samples + 4 * frames


def least_s(pool, idx) -> float:
    """Least seconds of the kernel work of one request over pool[idx]:
    its frames are the frames of one merged stereo dispatch, two lanes a
    frame, each lane as long as the longest block."""
    F = sum(len(pool[i].blocks) for i in idx)
    n = max(int(pool[i].blocks.max()) for i in idx)
    L = 2 * F
    return (bytes_bound_s(lpc_bytes(L, L * n))
            + bytes_bound_s(work_flac_lane_order(L))
            + bytes_bound_s(decorrelate_bytes(F, F * n)))
