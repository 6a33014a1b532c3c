"""MPEG audio Layer III streams for checking M0 (``ops/mp3_entropy.py``)
against the native library, and the comparison itself.

:func:`streams` builds seeded streams of each kind the test encoders
write, and variants of them: MPEG-1 mono and stereo, MPEG-2 and 2.5,
intensity stereo (MPEG-1 and MPEG-2's own scalefactor tables), linbits
tables, CRC-protected frames (the protection bit cleared and two bytes
inserted after each header, in place of two bytes of stuffing), LAME-style
joint stereo with the bit reservoir, short blocks and scfsi
(``mp3_lame_builder``), those with the mixed-block flag set on short
granules, a stream cut after its first audio frames (the reservoir
underflows at its start), and streams with bits flipped in side info and
main data. The bit-flipped and mixed-flag streams are not valid encodings:
what matters is that M0 and the host read them the same way.

:func:`expected` runs ``native.mp3_extract`` over each clip and lays its
output out in M0's lanes; :func:`compare` holds M0's output to it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import mp3_builder as sb
from . import mp3_lame_builder as lb


def _simple_granule(rng, n_big: int, big_table: int, big_max: int) -> dict:
    quads = [tuple(int(v) for v in rng.integers(-1, 2, size=4))
             for _ in range(int(rng.integers(2, 12)))]
    bigs = [(int(rng.integers(-big_max, big_max + 1)),
             int(rng.integers(-big_max, big_max + 1))) for _ in range(n_big)]
    return {"quad_pattern": quads, "big_pairs": bigs, "big_table": big_table,
            "global_gain": int(rng.integers(185, 206)),
            "count1table": int(rng.integers(0, 2))}


def mpeg1_stream(rng, frames: int, n_ch: int, *, mode_ext: int = 0,
                 big_table: int = 1, big_max: int = 1) -> bytes:
    """MPEG-1 frames of the simple builder (no reservoir): joint stereo
    with ``mode_ext`` where nonzero (bit 0 intensity, bit 1 mid/side)."""
    out = []
    for _ in range(frames):
        spec = [[_simple_granule(rng, int(rng.integers(0, 8)), big_table,
                                 big_max) for _ in range(n_ch)]
                for _ in range(2)]
        if mode_ext & 1 and n_ch == 2:
            for gr in spec:  # channel 1 ends early: intensity bands above
                gr[1]["quad_pattern"] = gr[1]["quad_pattern"][:1]
        out.append(sb.build_mpeg1_l3_frame(
            spec, n_ch=n_ch, channel_mode=1 if mode_ext else None,
            mode_ext=mode_ext))
    return b"".join(out)


def lsf_stream(rng, frames: int, n_ch: int, version: float, *,
               mode_ext: int = 0, scalefac_compress: int = 0) -> bytes:
    """MPEG-2 (``version`` 2.0) or 2.5 frames of the simple builder."""
    out = []
    for _ in range(frames):
        spec = [_simple_granule(rng, int(rng.integers(0, 8)), 7, 5)
                for _ in range(n_ch)]
        out.append(sb.build_mpeg2_l3_frame(
            spec, n_ch=n_ch, channel_mode=1 if mode_ext else None,
            mode_ext=mode_ext, scalefac_compress=scalefac_compress,
            version=version))
    return b"".join(out)


def frame_offsets(data: bytes):
    """(offsets, sizes) of the frames the port's MPEG audio reader
    finds."""
    from ..core.formats import FormatOptions
    from ..core.io import MediaSourceStream
    from ..formats.mpa import MpaReader

    r = MpaReader(MediaSourceStream(data), FormatOptions(enable_gapless=True))
    return r._offsets, r._sizes


def with_crc(data: bytes) -> bytes:
    """Each frame CRC-protected: the protection bit cleared and two bytes
    inserted after the header, two bytes of the frame's end dropped (the
    simple builder's frames end in stuffing)."""
    offs, sizes = frame_offsets(data)
    out = bytearray(data[: int(offs[0])])
    for o, s in zip(offs.tolist(), sizes.tolist()):
        fr = bytearray(data[o : o + s])
        fr[1] &= 0xFE
        out += fr[:4] + b"\x5a\xa5" + fr[4 : s - 2]
    return bytes(out)


def lame(seed: int, n: int = 30000, **draw) -> bytes:
    rng = np.random.default_rng(seed)
    return lb.build_stream(lb.draw(rng, n, **draw), n).data


def set_bits(data: bytes, where) -> bytes:
    """``data`` with the bits ``where`` (byte, bit from the top) set in
    every audio frame, counted from the frame's first byte."""
    offs, _ = frame_offsets(data)
    out = bytearray(data)
    for o in offs.tolist():
        for byte, bit in where:
            out[o + byte] |= 0x80 >> bit
    return bytes(out)


def mixed_flags(data: bytes) -> bytes:
    """A LAME-style stream with the mixed-block flag of every granule and
    channel set (only window-switched ones read it): MPEG-1 stereo side
    info, the flag 36 bits into each 59-bit granule-channel after 20."""
    where = []
    for k in range(4):
        b = 32 + 20 + 59 * k + 36
        where.append((b // 8, b % 8))
    return set_bits(data, where)


def flipped(data: bytes, seed: int, n: int, side_share: float) -> bytes:
    """``n`` bits flipped at seeded places in the audio frames (header
    bytes spared), ``side_share`` of them in side info."""
    rng = np.random.default_rng(seed)
    offs, sizes = frame_offsets(data)
    out = bytearray(data)
    for _ in range(n):
        f = int(rng.integers(len(offs)))
        o, s = int(offs[f]), int(sizes[f])
        if rng.random() < side_share:
            pos = o + 4 + int(rng.integers(0, min(17, s - 4)))
        else:
            pos = o + 4 + int(rng.integers(0, s - 4))
        out[pos] ^= 1 << int(rng.integers(8))
    return bytes(out)


def cut_start(data: bytes, frames: int) -> bytes:
    """The stream without its first ``frames`` audio frames after the
    first one (the LAME Info frame): the reservoir underflows at its
    start."""
    offs, sizes = frame_offsets(data)
    a = int(offs[0])
    b = int(offs[frames])
    return data[:a] + data[b:]


def streams(seed: int = 7) -> Dict[str, bytes]:
    """Named seeded streams (see the module docstring)."""
    rng = np.random.default_rng(seed)
    out = {
        "mpeg1_mono": mpeg1_stream(rng, 6, 1),
        "mpeg1_stereo": mpeg1_stream(rng, 6, 2),
        "mpeg1_linbits": mpeg1_stream(rng, 6, 2, big_table=24, big_max=30),
        "mpeg1_table23": mpeg1_stream(rng, 6, 1, big_table=23, big_max=3000),
        "mpeg1_table13": mpeg1_stream(rng, 6, 1, big_table=13, big_max=15),
        "mpeg1_intensity": mpeg1_stream(rng, 6, 2, mode_ext=1),
        "mpeg1_intensity_ms": mpeg1_stream(rng, 6, 2, mode_ext=3),
        "mpeg2_mono": lsf_stream(rng, 8, 1, 2.0),
        "mpeg2_stereo": lsf_stream(rng, 8, 2, 2.0, scalefac_compress=100),
        "mpeg2_intensity": lsf_stream(rng, 8, 2, 2.0, mode_ext=1,
                                      scalefac_compress=150),
        "mpeg2_intensity_ms": lsf_stream(rng, 8, 2, 2.0, mode_ext=3,
                                         scalefac_compress=420),
        "mpeg25_stereo": lsf_stream(rng, 8, 2, 2.5, scalefac_compress=505),
        "mpeg25_mono": lsf_stream(rng, 8, 1, 2.5),
    }
    out["mpeg1_crc"] = with_crc(out["mpeg1_stereo"])
    out["mpeg2_crc"] = with_crc(out["mpeg2_stereo"])
    out["lame"] = lame(seed)
    out["lame_plain"] = lame(seed + 1, ms_share=0.0, transient_every=0,
                             max_value=15, scfsi_share=0.0,
                             preflag_share=0.0, subblock_share=0.0)
    out["lame_short"] = lame(seed + 2, transient_every=4)
    out["lame_mixed"] = mixed_flags(lame(seed + 3, transient_every=4))
    out["lame_intensity"] = set_bits(lame(seed + 4, transient_every=6),
                                     [(3, 3)])
    out["lame_underflow"] = cut_start(lame(seed + 5), 4)
    for k in range(4):
        out[f"lame_flipped{k}"] = flipped(lame(seed + 6 + k), seed + k,
                                          40, 0.5)
    out["mpeg2_flipped"] = flipped(out["mpeg2_stereo"], seed + 11, 12, 0.5)
    return out


def expected(readers) -> List[dict]:
    """``native.mp3_extract`` over each reader's frames: its status [F],
    and for each frame whose status is 0 its granules' spectra [., C,
    576], block types and mixed flags, in frame order."""
    from .. import native

    out = []
    for r in readers:
        ext = native.mp3_extract(r._buf, r._offsets, r._sizes,
                                 max_granules=2 * len(r._offsets) + 2)
        C = r.header.n_channels
        G = ext["n_granules"]
        out.append(dict(status=np.array(ext["status"], copy=True),
                        spectra=np.array(ext["spectra"][:G, :C], copy=True),
                        bt=np.array(ext["bt"][:G, :C], copy=True),
                        mixed=np.array(ext["mixed"][:G, :C], copy=True)))
    return out


def compare(plan, want: List[dict], spectra: np.ndarray, bt: np.ndarray,
            mixed: np.ndarray, status: np.ndarray) -> dict:
    """M0's output (numpy) against :func:`expected`, clip by clip:
    statuses, and for the frames both decode, block types, mixed flags
    and spectra. Returns the counts; ``ok`` where statuses, flags and
    spectra are equal (``ulp1`` counts the values one unit in the last
    place apart, ``worse`` those further)."""
    res = dict(clips=len(want), frames=0, lanes=0, status_diff=0,
               flag_diff=0, values=0, bits_diff=0, ulp1=0, worse=0)
    for i, w in enumerate(want):
        f0, n = int(plan.first[i]), int(plan.count[i])
        st = status[f0 : f0 + n]
        res["frames"] += n
        res["status_diff"] += int((st != w["status"]).sum())
        ok = np.flatnonzero((st == 0) & (w["status"] == 0))
        C, gpf = int(plan.channels[i]), int(plan.granules[i]) // max(n, 1)
        # native's granules: gpf for each frame of status 0, in order
        g_of = np.cumsum(w["status"] == 0) - 1
        lanes, nat = [], []
        for f in ok:
            for g in range(gpf):
                lanes.append(int(plan.lane[i]) + (f * gpf + g) * C)
                nat.append(int(g_of[f]) * gpf + g)
        if not lanes:
            continue
        lanes = np.asarray(lanes)[:, None] + np.arange(C)[None, :]
        nat = np.asarray(nat)
        got_s = spectra[lanes]
        want_s = w["spectra"][nat]
        res["lanes"] += lanes.size
        res["flag_diff"] += int((bt[lanes] != w["bt"][nat]).sum()
                                + (mixed[lanes].astype(np.int32)
                                   != w["mixed"][nat]).sum())
        a = got_s.view(np.int32).astype(np.int64)
        b = want_s.view(np.int32).astype(np.int64)
        d = np.abs(a - b)
        res["values"] += got_s.size
        res["bits_diff"] += int((d != 0).sum())
        res["ulp1"] += int((d == 1).sum())
        res["worse"] += int((d > 1).sum())
    res["ok"] = (res["status_diff"] == 0 and res["flag_diff"] == 0
                 and res["bits_diff"] == 0)
    return res
