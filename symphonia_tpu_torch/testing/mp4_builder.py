"""A QuickTime uncompressed-audio (PCM) M4A muxer for decoder tests:
``atom``, ``full_atom`` and ``build_pcm_m4a`` of ``tests/test_mp4.py``,
copied."""

import struct

import numpy as np


def atom(atype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + atype + payload


def full_atom(atype: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return atom(atype, bytes([version]) + flags.to_bytes(3, "big") + payload)


def build_pcm_m4a(pcm, fourcc=b"sowt", rate=22050, frames_per_chunk=400,
                  extra_traks=b"") -> bytes:
    """QuickTime uncompressed-audio M4A: interleaved PCM in chunks.

    ``pcm`` is int16 [channels, frames]. v0 sample entries for
    sowt/twos; a version-2 ``lpcm`` entry when fourcc == b"lpcm".
    ``extra_traks`` appends prebuilt trak atoms (video/subtitle tests).
    """
    n_ch, n_frames = pcm.shape
    le = fourcc != b"twos"
    inter = np.ascontiguousarray(pcm.T.astype("<i2" if le else ">i2"))
    payload = inter.tobytes()
    fb = 2 * n_ch

    common = (b"\x00" * 6 + struct.pack(">H", 1)          # dref index
              + struct.pack(">H", 2 if fourcc == b"lpcm" else 0)  # version
              + b"\x00" * 6                                # revision+vendor
              + struct.pack(">HH", n_ch, 16)
              + b"\x00" * 4
              + struct.pack(">I", rate << 16))
    if fourcc == b"lpcm":
        body = (common[:20] + struct.pack(">HH", 3, 16) + common[24:]
                + struct.pack(">I", 0)                    # sizeof ext
                + struct.pack(">d", float(rate))
                + struct.pack(">I", n_ch)
                + struct.pack(">I", 0x7F000000)
                + struct.pack(">IIII", 16, 0x4,           # s16, signed LE
                              frames_per_chunk * fb, frames_per_chunk))
        entry = atom(b"lpcm", body)
    else:
        entry = atom(fourcc, common)
    stsd = full_atom(b"stsd", struct.pack(">I", 1) + entry)

    n_chunks = (n_frames + frames_per_chunk - 1) // frames_per_chunk
    if fourcc == b"lpcm":
        # v2: each MP4 sample is one multi-frame packet.
        stts_rows = [(n_chunks - 1, frames_per_chunk)] if n_chunks > 1 else []
        last = n_frames - (n_chunks - 1) * frames_per_chunk
        stts_rows.append((1, last))
        stts = full_atom(b"stts", struct.pack(">I", len(stts_rows))
                         + b"".join(struct.pack(">II", c, d)
                                    for c, d in stts_rows))
        stsc = full_atom(b"stsc", struct.pack(">IIII", 1, 1, 1, 1))
        sz = [frames_per_chunk * fb] * (n_chunks - 1) + [last * fb]
        stsz = full_atom(b"stsz", struct.pack(">II", 0, n_chunks)
                         + b"".join(struct.pack(">I", s) for s in sz))
    else:
        # v0: each MP4 sample is one PCM frame.
        stts = full_atom(b"stts", struct.pack(">III", 1, n_frames, 1))
        stsc = full_atom(b"stsc",
                         struct.pack(">IIII", 1, 1, frames_per_chunk, 1))
        stsz = full_atom(b"stsz", struct.pack(">III", fb, n_frames, 0)[:12])

    def build(mdat_offset):
        offs = [mdat_offset + i * frames_per_chunk * fb
                for i in range(n_chunks)]
        stco = full_atom(b"stco", struct.pack(">I", n_chunks)
                         + b"".join(struct.pack(">I", o) for o in offs))
        stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = atom(b"minf", stbl)
        mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate,
                                              n_frames, 0x55C4, 0))
        mdia = atom(b"mdia", mdhd + minf)
        tkhd = full_atom(b"tkhd",
                         struct.pack(">IIII", 0, 0, 1, 0) + b"\x00" * 72)
        trak = atom(b"trak", tkhd + mdia)
        mvhd = full_atom(b"mvhd",
                         struct.pack(">III", 0, 0, rate) + b"\x00" * 88)
        return atom(b"moov", mvhd + trak + extra_traks)

    ftyp = atom(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42isom")
    moov = build(0)
    moov = build(len(ftyp) + len(moov) + 8)
    return ftyp + moov + atom(b"mdat", payload)
