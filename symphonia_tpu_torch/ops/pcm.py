"""PCM sample conversion on the host.

The numpy half of ``symphonia_tpu/ops/pcm.py`` (its G.711 tables and
``decode_pcm_np``, lines 25-166, copied): raw packet bytes -> planar
samples, the oracle and the per-packet decoder's path
(``codecs/pcm.py``). The device kernel (K12) is not ported yet.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# G.711 companding tables (codec-pcm lib.rs:154-181)
# ---------------------------------------------------------------------------


def _build_mulaw_table() -> np.ndarray:
    """CCITT G.711 mu-law -> linear16."""
    out = np.zeros(256, dtype=np.int16)
    for u in range(256):
        v = ~u & 0xFF
        t = ((v & 0x0F) << 3) + 0x84
        t <<= (v & 0x70) >> 4
        out[u] = (0x84 - t) if (v & 0x80) else (t - 0x84)
    return out


def _build_alaw_table() -> np.ndarray:
    """CCITT G.711 A-law -> linear16."""
    out = np.zeros(256, dtype=np.int16)
    for a in range(256):
        v = a ^ 0x55
        t = (v & 0x0F) << 4
        seg = (v & 0x70) >> 4
        if seg == 0:
            t += 8
        elif seg == 1:
            t += 0x108
        else:
            t = (t + 0x108) << (seg - 1)
        out[a] = t if (v & 0x80) else -t
    return out


MULAW_TABLE = _build_mulaw_table()
ALAW_TABLE = _build_alaw_table()


# ---------------------------------------------------------------------------
# Host (numpy) decode — the oracle
# ---------------------------------------------------------------------------

_INT_DTYPES = {
    ("s16", False): "<i2", ("s16", True): ">i2",
    ("u16", False): "<u2", ("u16", True): ">u2",
    ("s32", False): "<i4", ("s32", True): ">i4",
    ("u32", False): "<u4", ("u32", True): ">u4",
    ("f32", False): "<f4", ("f32", True): ">f4",
    ("f64", False): "<f8", ("f64", True): ">f8",
}


def decode_pcm_np(
    data: bytes,
    codec: str,
    channels: int,
    bits_per_coded_sample: int | None = None,
) -> np.ndarray:
    """Decode interleaved PCM bytes -> planar [ch, frames] samples.

    Integer output is int32 right-justified at the *coded* width; float
    output is float32/float64. Mirrors codec-pcm lib.rs:318-412 incl. the
    bits_per_coded_sample sub-width shift.
    """
    # Truncated final sample (malformed/cut streams): clip to whole
    # samples like the reference's frame-bounded reads; a partial trailing
    # sample is dropped rather than raising out of the taxonomy.
    _widths = {"pcm_u8": 1, "pcm_s8": 1, "pcm_alaw": 1, "pcm_mulaw": 1,
               "pcm_s16le": 2, "pcm_s16be": 2, "pcm_u16le": 2,
               "pcm_u16be": 2, "pcm_s24le": 3, "pcm_s24be": 3,
               "pcm_u24le": 3, "pcm_u24be": 3, "pcm_s32le": 4,
               "pcm_s32be": 4, "pcm_u32le": 4, "pcm_u32be": 4,
               "pcm_f32le": 4, "pcm_f32be": 4, "pcm_f64le": 8,
               "pcm_f64be": 8}
    if channels < 1:
        raise ValueError("PCM decode requires at least one channel")
    w = _widths.get(codec, 1) * max(1, channels)
    if len(data) % w:
        data = data[: len(data) - (len(data) % w)]
    if codec == "pcm_u8":
        x = np.frombuffer(data, dtype=np.uint8).astype(np.int32) - 128
        bits = 8
    elif codec == "pcm_s8":
        x = np.frombuffer(data, dtype=np.int8).astype(np.int32)
        bits = 8
    elif codec in ("pcm_s16le", "pcm_s16be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("s16", codec.endswith("be"))]).astype(np.int32)
        bits = 16
    elif codec in ("pcm_u16le", "pcm_u16be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("u16", codec.endswith("be"))]).astype(np.int32) - 32768
        bits = 16
    elif codec in ("pcm_s24le", "pcm_s24be"):
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if codec.endswith("be"):
            b = b[:, ::-1]
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x << 8) >> 8  # sign-extend 24 -> 32
        bits = 24
    elif codec in ("pcm_u24le", "pcm_u24be"):
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if codec.endswith("be"):
            b = b[:, ::-1]
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        ) - (1 << 23)
        bits = 24
    elif codec in ("pcm_s32le", "pcm_s32be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("s32", codec.endswith("be"))]).astype(np.int32)
        bits = 32
    elif codec in ("pcm_u32le", "pcm_u32be"):
        x = (
            np.frombuffer(data, dtype=_INT_DTYPES[("u32", codec.endswith("be"))]).astype(np.int64)
            - (1 << 31)
        ).astype(np.int32)
        bits = 32
    elif codec in ("pcm_f32le", "pcm_f32be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("f32", codec.endswith("be"))]).astype(np.float32)
        bits = None
    elif codec in ("pcm_f64le", "pcm_f64be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("f64", codec.endswith("be"))]).astype(np.float64)
        bits = None
    elif codec == "pcm_mulaw":
        x = MULAW_TABLE[np.frombuffer(data, dtype=np.uint8)].astype(np.int32)
        bits = 16
    elif codec == "pcm_alaw":
        x = ALAW_TABLE[np.frombuffer(data, dtype=np.uint8)].astype(np.int32)
        bits = 16
    else:
        raise ValueError(f"not a PCM codec: {codec}")

    # Sub-width samples stored right-justified in a wider container
    # (lib.rs:318-412): shift down to the coded width.
    if (
        bits is not None
        and bits_per_coded_sample
        and bits_per_coded_sample < bits
        and codec not in ("pcm_alaw", "pcm_mulaw")
    ):
        x = x >> (bits - bits_per_coded_sample)

    frames = len(x) // channels
    return np.ascontiguousarray(x[: frames * channels].reshape(frames, channels).T)
