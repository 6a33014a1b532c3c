"""IMA and MS ADPCM encoders and their WAV container for decoder tests:
``ima_encode``, ``ms_encode`` and ``make_adpcm_wav`` of
``tests/test_adpcm.py``, copied with its test signal ``smooth_signal``; the
tables they read are the decoder's."""

import struct

import numpy as np

from ..codecs.adpcm import (
    IMA_INDEX_TABLE,
    IMA_STEP_TABLE,
    MS_ADAPT_TABLE,
    MS_COEFFS,
)


def ima_encode(samples: np.ndarray, block_frames: int = 505) -> tuple:
    """Mono IMA-WAV encoder. Returns (blocks bytes, block_align)."""
    blocks = bytearray()
    idx = 0
    n = len(samples)
    bpb = 4 + (block_frames - 1) // 2  # mono block size
    for start in range(0, n, block_frames):
        chunk = samples[start : start + block_frames]
        if len(chunk) < block_frames:
            chunk = np.pad(chunk, (0, block_frames - len(chunk)))
        pred = int(chunk[0])
        blocks += struct.pack("<hBB", pred, idx, 0)
        nibbles = []
        for s in chunk[1:]:
            step = int(IMA_STEP_TABLE[idx])
            diff = int(s) - pred
            nib = 0
            if diff < 0:
                nib = 8
                diff = -diff
            if diff >= step:
                nib |= 4
                diff -= step
            if diff >= step >> 1:
                nib |= 2
                diff -= step >> 1
            if diff >= step >> 2:
                nib |= 1
            # Decoder recurrence to track state.
            step_ = int(IMA_STEP_TABLE[idx])
            d = step_ >> 3
            if nib & 1:
                d += step_ >> 2
            if nib & 2:
                d += step_ >> 1
            if nib & 4:
                d += step_
            pred = pred - d if nib & 8 else pred + d
            pred = max(-32768, min(32767, pred))
            idx = max(0, min(88, idx + int(IMA_INDEX_TABLE[nib & 7])))
            nibbles.append(nib)
        for i in range(0, len(nibbles), 2):
            lo = nibbles[i]
            hi = nibbles[i + 1] if i + 1 < len(nibbles) else 0
            blocks.append(lo | (hi << 4))
    return bytes(blocks), bpb


def ms_encode(samples: np.ndarray, block_frames: int = 500) -> tuple:
    """Mono MS-ADPCM encoder with predictor 0. Returns (bytes, align)."""
    blocks = bytearray()
    n = len(samples)
    bpb = 7 + (block_frames - 2 + 1) // 2
    for start in range(0, n, block_frames):
        chunk = samples[start : start + block_frames]
        if len(chunk) < block_frames:
            chunk = np.pad(chunk, (0, block_frames - len(chunk)))
        s2, s1 = int(chunk[0]), int(chunk[1])
        delta = 256
        blocks += struct.pack("<Bhhh", 0, delta, s1, s2)
        c1, c2 = (int(v) for v in MS_COEFFS[0])
        nibbles = []
        for s in chunk[2:]:
            pred = (s1 * c1 + s2 * c2) // 256
            err = int(s) - pred
            nib = max(-8, min(7, int(round(err / delta)))) & 0xF
            signed = nib - 16 if nib & 8 else nib
            rec = max(-32768, min(32767, pred + signed * delta))
            s2, s1 = s1, rec
            delta = max(16, int(MS_ADAPT_TABLE[nib]) * delta // 256)
            nibbles.append(nib)
        for i in range(0, len(nibbles), 2):
            hi = nibbles[i]
            lo = nibbles[i + 1] if i + 1 < len(nibbles) else 0
            blocks.append((hi << 4) | lo)
    return bytes(blocks), bpb


def make_adpcm_wav(payload: bytes, fmt_tag: int, block_align: int,
                   frames_per_block: int, n_frames: int, rate=22050) -> bytes:
    if fmt_tag == 0x02:
        # MS ADPCM: samples/block + coefficient table (Microsoft WAVE spec).
        extra = struct.pack("<HH", frames_per_block, 7)
        for c1, c2 in MS_COEFFS:
            extra += struct.pack("<hh", int(c1), int(c2))
    else:
        extra = struct.pack("<H", frames_per_block)
    fmt = struct.pack("<HHIIHHH", fmt_tag, 1, rate,
                      rate * block_align // frames_per_block, block_align, 4,
                      len(extra)) + extra
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"fact" + struct.pack("<II", 4, n_frames)
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def smooth_signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(-400, 401, size=n))
    return np.clip(x, -30000, 30000).astype(np.int32)
