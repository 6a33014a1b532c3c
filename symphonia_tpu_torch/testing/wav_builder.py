"""WAV file builder for decoder tests: ``make_wav`` of
``tests/test_wav_pcm.py``, copied."""

import struct

import numpy as np


def make_wav(
    frames: np.ndarray, rate: int = 44100, fmt_tag: int = 1, bits: int = 16
) -> bytes:
    """Synthesize a WAV file. frames: [n, ch] int (right-justified) or float."""
    n, ch = frames.shape
    if fmt_tag == 1:
        if bits == 16:
            payload = frames.astype("<i2").tobytes()
        elif bits == 8:
            payload = (frames + 128).astype(np.uint8).tobytes()
        elif bits == 24:
            x = frames.astype("<i4").tobytes()
            payload = b"".join(x[i : i + 3] for i in range(0, len(x), 4))
        elif bits == 32:
            payload = frames.astype("<i4").tobytes()
        block = ch * ((bits + 7) // 8)
    elif fmt_tag == 3:
        payload = frames.astype("<f4").tobytes()
        bits = 32
        block = ch * 4
    fmt = struct.pack("<HHIIHH", fmt_tag, ch, rate, rate * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunks += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
