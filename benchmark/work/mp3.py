"""MP3's kernel work: M1 (``mp3_hybrid``: the aliasing butterflies, the
IMDCT as a product with each block type's [36, 18] matrix, overlap-add,
frequency inversion) and M2 (``mp3_synth``: the factored polyphase
synthesis). Frozen copies of ``chip_smoke.work_mp3_hybrid`` and
``work_mp3_synth``, as functions of the lanes (granule x channel) and
granules a request sends, the carried tails and tables counted once a
request."""

from . import bound_s

# M2 per 32-sample slot: the matrixing's 32 folded rows (16 multiply-adds
# each), its row 16 (32 counted as 16) and the sums (32), and the 16-tap
# FIR (16 x 32) (chip_smoke.SYNTH_MACS_PER_SLOT).
SYNTH_MACS_PER_SLOT = 32 * 16 + 16 + 32 + 16 * 32


def work_mp3_hybrid(lanes: int, granules: int):
    """(bytes, fp32 multiply-adds) of M1 over ``lanes``."""
    return 2 * lanes * 576 * 4 + lanes * 5 + granules, lanes * 32 * 36 * 18.0


def work_mp3_synth(lanes: int, granules: int, channels: int = 2):
    """(bytes, fp32 multiply-adds) of M2 over ``lanes``."""
    nbytes = (2 * lanes * 576 * 4 + 2 * channels * 480 * 4
              + (64 + 16) * 32 * 4 + granules)
    return nbytes, float(lanes) * 18 * SYNTH_MACS_PER_SLOT


def hybrid_s(lanes: int, granules: int) -> float:
    return bound_s(*work_mp3_hybrid(lanes, granules))


def synth_s(lanes: int, granules: int) -> float:
    return bound_s(*work_mp3_synth(lanes, granules))


def least_s(pool, idx) -> float:
    """Least seconds of the kernel work of one request over pool[idx]:
    every (granule, channel) is a lane of M1 and of M2."""
    granules = sum(len(pool[i].granules["block_type"]) for i in idx)
    lanes = 2 * granules
    return hybrid_s(lanes, granules) + synth_s(lanes, granules)
