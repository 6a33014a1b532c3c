"""AIFF and CAF file builders for decoder tests: ``pack_f80``,
``make_aiff`` and ``make_caf`` of ``tests/test_aiff_caf.py``, copied."""

import struct

import numpy as np


def pack_f80(rate: float) -> bytes:
    import math

    if rate == 0:
        return b"\x00" * 10
    exp = int(math.floor(math.log2(rate)))
    mantissa = int(rate / 2.0**exp * (1 << 63))
    return struct.pack(">H", exp + 16383) + mantissa.to_bytes(8, "big")


def make_aiff(frames: np.ndarray, rate=44100, bits=16, aifc=False, comp=b"NONE"):
    n, ch = frames.shape
    if comp == b"sowt":
        payload = frames.astype("<i2").tobytes()
    elif bits == 16:
        payload = frames.astype(">i2").tobytes()
    elif bits == 8:
        payload = frames.astype(np.int8).tobytes()
    elif bits == 24:
        b = frames.astype(">i4").tobytes()
        payload = b"".join(b[i + 1 : i + 4] for i in range(0, len(b), 4))
    comm = struct.pack(">HIH", ch, n, bits) + pack_f80(rate)
    if aifc:
        comm += comp + b"\x00\x00"  # empty pascal string, padded
    chunks = b"COMM" + struct.pack(">I", len(comm)) + comm
    ssnd = struct.pack(">II", 0, 0) + payload
    chunks += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    if len(ssnd) & 1:
        chunks += b"\x00"
    form_type = b"AIFC" if aifc else b"AIFF"
    return b"FORM" + struct.pack(">I", 4 + len(chunks)) + form_type + chunks


def make_caf(frames: np.ndarray, rate=44100, fmt=b"lpcm", flags=0x2, bits=16):
    n, ch = frames.shape
    if flags & 0x2:
        payload = frames.astype("<i2").tobytes()
    else:
        payload = frames.astype(">i2").tobytes()
    bpp = ch * bits // 8
    desc = struct.pack(">d", float(rate)) + fmt + struct.pack(
        ">IIIII", flags, bpp, 1, ch, bits
    )
    out = b"caff" + struct.pack(">HH", 1, 0)
    out += b"desc" + struct.pack(">q", len(desc)) + desc
    data = struct.pack(">I", 0) + payload
    out += b"data" + struct.pack(">q", len(data)) + data
    return out
