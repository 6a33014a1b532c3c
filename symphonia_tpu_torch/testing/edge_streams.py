"""Streams at the smallest shapes the batch decoders pack, which the
soak's random mutations reach only now and then. ``chip_smoke.py`` and the
tests decode them on the card and on the CPU."""

import numpy as np


def edge_inputs(seed: int = 0) -> list:
    """(name, bytes) of streams at the smallest shapes the batch decoders
    pack, which random mutations reach only now and then: one FLAC frame
    (one lane mono, two stereo), one MP3 frame (two granules, mono and
    stereo), an MP3 stream cut inside its first frame (no granule), one
    AAC frame (one lane mono, an EIGHT_SHORT one), a Vorbis stream of a
    few packets; each stream also with its end cut off."""
    from .aac_builder import build_adts, build_raw_block
    from .flac_builder import build_flac_file, random_walk
    from .mp3_builder import build_mpeg1_l3_stream
    from .vorbis_stream import build_vorbis

    rng = np.random.default_rng(seed)

    def spec():
        q = np.zeros(1024, np.int64)
        idx = rng.choice(1000, size=100, replace=False)
        q[idx] = rng.integers(-60, 61, size=100)
        return q

    def flac(n, ch, **kw):
        return build_flac_file(random_walk(n, 16, seed=seed + n + ch, ch=ch),
                               block_size=1024, kind="fixed", **kw)

    def aac(seqs):
        return build_adts([build_raw_block([spec() for _ in s], list(s), 12,
                                           140, 44100) for s in seqs],
                          44100, len(seqs[0]))

    streams = {
        "flac_one_frame_mono": flac(1024, 1, order=2),
        "flac_one_frame_stereo": flac(1024, 2, order=2,
                                      stereo_mode="left_side"),
        "flac_two_frames_stereo": flac(2048, 2, order=3,
                                       stereo_mode="mid_side"),
        "mp3_one_frame_mono": build_mpeg1_l3_stream(1, n_ch=1, seed=seed),
        "mp3_one_frame_stereo": build_mpeg1_l3_stream(1, n_ch=2,
                                                      seed=seed + 1),
        "mp3_three_frames_stereo": build_mpeg1_l3_stream(3, n_ch=2,
                                                         seed=seed + 2),
        "aac_one_frame_mono": aac([(0,)]),
        "aac_one_short_frame_mono": aac([(2,)]),
        "aac_one_frame_stereo": aac([(0, 0)]),
        "aac_two_frames_stereo": aac([(1, 1), (2, 2)]),
        "vorbis_few_packets": build_vorbis(44100, 8, 11, 0.02, seed),
    }
    out = []
    for name, data in streams.items():
        out += [(name, data),
                (name + "_cut", data[: len(data) - max(1, len(data) // 7)])]
    out.append(("mp3_no_granule", streams["mp3_one_frame_stereo"][:40]))
    return out
