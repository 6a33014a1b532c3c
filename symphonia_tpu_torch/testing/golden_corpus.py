"""The reference's golden PCM corpus, built from this package's encoders.

``tests/test_golden_pcm.py`` pins the decoded PCM of one deterministic
fixture per codec family in ``tests/golden_pcm.npz``, generated once from
the reference. :func:`corpus` builds the same fixtures, byte for byte, from
the copies in this package (``signal`` is ``tests/test_alac.py``'s, copied
here), so that the port can be held to that anchor on a machine without
the reference: the CPU tests and ``chip_smoke.py`` on the card.
:func:`compare` applies the anchor's protocol: integer outputs bit-exact,
float outputs within 1e-5 absolute, both after the first :data:`CAP`
samples of each channel.

Two entries are real media that the anchor read from pygame's example
data (``house_lo.mp3``, ``house_lo.ogg``); where pygame is not installed
they are left out and named in :func:`corpus`'s second result.
"""

from __future__ import annotations

import importlib.util
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# Samples a channel the anchor keeps (the head exercises every stage).
CAP = 32768
# The real-media entries: (name, file in pygame's examples/data).
PYGAME_ENTRIES = (("mp3_real", "house_lo.mp3"), ("vorbis_real", "house_lo.ogg"))
FLOAT_BAR = 1e-5


def signal(n, seed, ch=1, bits=16):
    rng = np.random.default_rng(seed)
    lim = (1 << (bits - 1)) - 1
    out = []
    for _ in range(ch):
        x = np.clip(np.cumsum(rng.integers(-300, 301, size=n)), -lim, lim)
        out.append(x.astype(np.int64))
    return out


def _build_alac_caf() -> bytes:
    """ALAC (compressed frames, order-2 predictor) in a CAF container, as
    the anchor builds it."""
    from .alac_builder import build_cookie, encode_frame_compressed

    frame_len = 512
    ch = signal(frame_len * 4, seed=106)
    cookie_dict = dict(frame_length=frame_len, bit_depth=16, pb=40, mb=10,
                       kb=14)
    frames = [
        encode_frame_compressed(
            [ch[0][i * frame_len:(i + 1) * frame_len]], cookie_dict, order=2)
        for i in range(4)
    ]
    cookie_bytes = build_cookie(frame_len, 16, 1, 44100)
    desc = struct.pack(">d", 44100.0) + b"alac" + struct.pack(
        ">IIIII", 0, 0, frame_len, 1, 16)
    pakt_body = struct.pack(">qqii", len(frames), len(frames) * frame_len,
                            0, 0)
    for f in frames:
        n = len(f)
        varint = bytearray()
        while True:
            varint.insert(0, n & 0x7F)
            n >>= 7
            if not n:
                break
        for i in range(len(varint) - 1):
            varint[i] |= 0x80
        pakt_body += bytes(varint)
    payload = b"".join(frames)
    data = b"caff" + struct.pack(">HH", 1, 0)
    data += b"desc" + struct.pack(">q", len(desc)) + desc
    data += b"kuki" + struct.pack(">q", len(cookie_bytes)) + cookie_bytes
    data += b"pakt" + struct.pack(">q", len(pakt_body)) + pakt_body
    data += (b"data" + struct.pack(">q", len(payload) + 4)
             + struct.pack(">I", 0) + payload)
    return data


def pygame_data() -> Optional[Path]:
    """pygame's ``examples/data`` directory, or None without pygame."""
    spec = importlib.util.find_spec("pygame")
    if spec is None or not spec.submodule_search_locations:
        return None
    path = Path(spec.submodule_search_locations[0]) / "examples" / "data"
    return path if path.is_dir() else None


def corpus(data_dir: Optional[Path] = None
           ) -> Tuple[Dict[str, bytes], List[str]]:
    """``(entries, absent)``: the anchor's fixtures by family name, in its
    order, and the names of the real-media entries whose files are not in
    ``data_dir`` (pygame's example data by default)."""
    from .aac_builder import build_adts, build_raw_block, random_quant_spectrum
    from .adpcm_builder import (ima_encode, make_adpcm_wav, ms_encode,
                                smooth_signal)
    from .flac_builder import build_flac_file, random_walk
    from .mp3_builder import build_mpeg1_l3_stream
    from .mpa_l12_builder import _rand_l2_frame
    from .wav_builder import make_wav

    data_dir = pygame_data() if data_dir is None else data_dir
    entries, absent = {}, []

    ch = random_walk(8192, 16, seed=101, ch=2)
    entries["flac"] = build_flac_file(
        ch, block_size=1024, stereo_mode="mid_side", kind="lpc",
        lpc_coefs=[900, -500, 120], lpc_shift=10)

    entries["mp3_mpeg1_stereo"] = build_mpeg1_l3_stream(8, n_ch=2, seed=102)
    for name, fname in PYGAME_ENTRIES:
        path = None if data_dir is None else data_dir / fname
        if path is not None and path.is_file():
            entries[name] = path.read_bytes()
        else:
            absent.append(name)

    rng = np.random.default_rng(103)
    frames = [build_raw_block([random_quant_spectrum(rng, 40, 44100)], [0],
                              40, 140, 44100) for _ in range(6)]
    entries["aac_44k_mono"] = build_adts(frames, 44100, 1)
    rng = np.random.default_rng(104)
    frames = [build_raw_block([random_quant_spectrum(rng, 40, 48000),
                               random_quant_spectrum(rng, 40, 48000)],
                              [0, 0], 40, 140, 48000) for _ in range(6)]
    entries["aac_48k_stereo"] = build_adts(frames, 48000, 2)

    entries["alac_caf"] = _build_alac_caf()

    sig = smooth_signal(4000, 105)
    payload, ba = ima_encode(sig)
    entries["adpcm_ima"] = make_adpcm_wav(payload, 0x11, ba, 505, len(sig))
    payload, ba = ms_encode(sig)
    entries["adpcm_ms"] = make_adpcm_wav(payload, 0x02, ba, 500, len(sig))

    l2_frames = [_rand_l2_frame(s)[0] for s in range(4)]
    entries["mp2"] = b"".join(l2_frames)

    rng = np.random.default_rng(107)
    pcm = rng.integers(-20000, 20000, size=(2048, 2)).astype(np.int64)
    entries["wav_s16"] = make_wav(pcm, rate=22050, fmt_tag=1, bits=16)

    return entries, absent


def compare(name: str, samples, rate: int, golden) -> dict:
    """One decoded entry (``samples [C, n]``, ``rate``) against the anchor
    ``golden`` (the loaded npz), under its protocol: the rate and the shape
    of the first :data:`CAP` samples equal, integers bit-exact, floats
    within :data:`FLOAT_BAR`. Returns the row with ``ok``."""
    pcm = np.asarray(samples)[:, :CAP]
    ref = golden[f"{name}__pcm"]
    row = {"name": name, "shape": list(pcm.shape), "dtype": str(pcm.dtype),
           "rate_ok": int(rate) == int(golden[f"{name}__rate"])}
    if pcm.shape != ref.shape:
        return dict(row, ok=False, golden_shape=list(ref.shape))
    if ref.dtype.kind == "f":
        err = float(np.abs(pcm.astype(np.float64) - ref).max(initial=0.0))
        row.update(max_abs_err=err, ok=row["rate_ok"] and err <= FLOAT_BAR)
    else:
        row.update(ok=row["rate_ok"] and pcm.dtype == ref.dtype
                   and bool(np.array_equal(pcm, ref)))
    return row
