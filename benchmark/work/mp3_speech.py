"""MP3 speech's kernel work: M1 and M2 as the MP3 cell counts them
(``work/mp3.py``), for mono clips: every granule is one lane, and M2
carries one channel's tail."""

from . import bound_s
from .mp3 import work_mp3_hybrid, work_mp3_synth


def least_s(pool, idx) -> float:
    """Least seconds of the kernel work of one request over pool[idx]:
    every granule (one channel) is a lane of M1 and of M2."""
    granules = sum(len(pool[i].granules["block_type"]) for i in idx)
    lanes = granules
    return (bound_s(*work_mp3_hybrid(lanes, granules))
            + bound_s(*work_mp3_synth(lanes, granules, channels=1)))
