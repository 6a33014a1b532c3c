"""A minimal MPEG-1 Layer III *encoder* for structural decode tests.

Emits conformant frames with chosen side-info/spectrum content: long
blocks, count1-only or table-1 big_values spectra, mono or stereo, CRC-less.
Used to exercise the MPEG1 paths (4-bit scalefac_compress, scfsi, two
granules, bit reservoir layout) that the available real-file fixtures
(MPEG2/2.5) do not cover. Independent of decoder code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, val: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def pad_to_bytes(self) -> bytes:
        while len(self.bits) % 8:
            self.bits.append(0)
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | self.bits[i + j]
            out.append(b)
        return bytes(out)

    def __len__(self):
        return len(self.bits)


# Huffman table 1 (ISO 11172-3 B.7): (x, y) -> (code, len)
TABLE1 = {(0, 0): (1, 1), (0, 1): (1, 3), (1, 0): (1, 2), (1, 1): (0, 3)}
# Quads table B: value i (vwxy bits) -> code 15-i, 4 bits.


def big_table_encoder(table_select: int):
    """Encode map for an arbitrary big-values table: (|x|, |y|) ->
    (code, len), plus its linbits. Built by inverting the decoder's own
    spec tables so the builder stays a mirror encoder."""
    from ..codecs.mpa_layer3 import tables

    t = tables()
    n = 16 if 16 <= table_select <= 23 else (24 if table_select >= 24
                                             else table_select)
    codes, bits = t[f"codes_{n}"], t[f"bits_{n}"]
    wrap = {4: 2, 9: 3, 16: 4, 36: 6, 64: 8, 256: 16}[len(codes)]
    m = {}
    for i in range(len(codes)):
        if int(bits[i]):
            m[(i // wrap, i % wrap)] = (int(codes[i]), int(bits[i]))
    return m, int(t["linbits"][table_select])


def quad_table_encoder(select: int):
    from ..codecs.mpa_layer3 import tables

    t = tables()
    suffix = "a" if select == 0 else "b"
    codes, bits = t[f"quads_codes_{suffix}"], t[f"quads_bits_{suffix}"]
    return {i: (int(codes[i]), int(bits[i])) for i in range(len(codes))}


def encode_granule_channel(
    bw: BitWriter,
    quad_pattern: Sequence[int],
    big_pairs: Sequence[tuple] = (),
    global_gain: int = 210,
    big_table: int = 1,
    count1table: int = 1,
):
    """Write main_data for one granule-channel: all scalefactors zero-length
    (scalefac_compress=0 -> slen 0,0), big_values via `big_table` (linbits
    escapes encode magnitudes above 15 for tables 16..31), then count1
    quads via table A or B. Returns part2_3_length in bits."""
    start = len(bw)
    tbl, linbits = big_table_encoder(big_table)
    qt = quad_table_encoder(count1table)
    # part2: scalefac_compress=0 => slen1=slen2=0 => no scalefactor bits.
    # part3: big_values pairs first.
    for x, y in big_pairs:
        ax, ay = abs(x), abs(y)
        ex = min(ax, 15) if linbits else ax
        ey = min(ay, 15) if linbits else ay
        code, ln = tbl[(ex, ey)]
        bw.write(code, ln)
        # Decoder field order: x linbits, x sign, y linbits, y sign.
        if ex == 15 and linbits:
            assert ax - 15 < (1 << linbits)
            bw.write(ax - 15, linbits)
        if x:
            bw.write(1 if x < 0 else 0, 1)
        if ey == 15 and linbits:
            assert ay - 15 < (1 << linbits)
            bw.write(ay - 15, linbits)
        if y:
            bw.write(1 if y < 0 else 0, 1)
    for quad in quad_pattern:
        v, w, x, y = quad
        idx = (abs(v) << 3) | (abs(w) << 2) | (abs(x) << 1) | abs(y)
        code, ln = qt[idx]
        bw.write(code, ln)
        for sgn in (v, w, x, y):
            if sgn:
                bw.write(1 if sgn < 0 else 0, 1)
    return len(bw) - start


def build_mpeg1_l3_frame(
    granule_specs,
    n_ch: int = 1,
    sample_rate_idx: int = 0,  # 0 = 44100
    bitrate_idx: int = 9,  # 128 kbps
    channel_mode: int = 3 if False else None,
    mode_ext: int = 0,  # joint stereo: bit0 intensity, bit1 mid-side
):
    """Build one MPEG1 Layer III frame.

    granule_specs: [2][n_ch] dicts with keys quad_pattern, big_pairs,
    global_gain. Returns frame bytes (padded with stuffing to frame size).
    """
    if channel_mode is None:
        channel_mode = 3 if n_ch == 1 else 0  # mono or stereo

    # Main data bits.
    md = BitWriter()
    lengths = [[0] * n_ch for _ in range(2)]
    for gr in range(2):
        for ch in range(n_ch):
            spec = granule_specs[gr][ch]
            lengths[gr][ch] = encode_granule_channel(
                md,
                spec.get("quad_pattern", ()),
                spec.get("big_pairs", ()),
                spec.get("global_gain", 210),
                spec.get("big_table", 1),
                spec.get("count1table", 1),
            )
    main_data = md.pad_to_bytes()

    # Side info.
    si = BitWriter()
    si.write(0, 9)  # main_data_begin = 0
    si.write(0, 5 if n_ch == 1 else 3)  # private
    for _ch in range(n_ch):
        si.write(0, 4)  # scfsi: all fresh
    for gr in range(2):
        for ch in range(n_ch):
            spec = granule_specs[gr][ch]
            n_big = len(spec.get("big_pairs", ()))
            si.write(lengths[gr][ch], 12)  # part2_3_length
            si.write(n_big, 9)  # big_values
            si.write(spec.get("global_gain", 210), 8)
            si.write(0, 4)  # scalefac_compress = 0
            si.write(0, 1)  # window_switching = 0 (long block)
            ts = spec.get("big_table", 1)
            si.write(ts, 5)  # table_select[0]
            si.write(ts, 5)  # table_select[1]
            si.write(ts, 5)  # table_select[2]
            si.write(0, 4)  # region0_count - 1... (stored value 0 -> count 1)
            si.write(7, 3)  # region1_count stored
            si.write(0, 1)  # preflag
            si.write(0, 1)  # scalefac_scale
            si.write(spec.get("count1table", 1), 1)  # count1table_select
    side_info = si.pad_to_bytes()
    assert len(side_info) == (17 if n_ch == 1 else 32), len(side_info)

    # Header: MPEG1 (11), Layer III (01), no CRC (1).
    rates = {0: 44100, 1: 48000, 2: 32000}
    b0 = 0xFF
    b1 = 0xFB  # 1111 1011: sync + MPEG1 + Layer3 + no CRC
    b2 = (bitrate_idx << 4) | (sample_rate_idx << 2)  # no padding
    b3 = (channel_mode << 6) | (mode_ext << 4)
    header = bytes([b0, b1, b2, b3])

    bitrate = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320][bitrate_idx] * 1000
    frame_size = 144 * bitrate // rates[sample_rate_idx]

    body = header + side_info + main_data
    if len(body) > frame_size:
        raise ValueError("main data too large for frame")
    return body + bytes(frame_size - len(body))


def build_mpeg2_l3_frame(
    granule_specs,
    n_ch: int = 2,
    sample_rate_idx: int = 0,  # 0 = 22050
    bitrate_idx: int = 8,      # 64 kbps (MPEG2 table)
    channel_mode: int = None,
    mode_ext: int = 0,
    scalefac_compress: int = 0,
    version: float = 2.0,
):
    """Build one MPEG2 (LSF) Layer III frame: single granule, 8-bit
    main_data_begin, no scfsi/preflag, 9-bit scalefac_compress.
    ``version=2.5`` emits the MPEG2.5 header (version bits 00, halved
    sample-rate table) with the same LSF side-info layout."""
    if channel_mode is None:
        channel_mode = 3 if n_ch == 1 else 0

    md = BitWriter()
    lengths = [0] * n_ch
    for ch in range(n_ch):
        spec = granule_specs[ch]
        lengths[ch] = encode_granule_channel(
            md,
            spec.get("quad_pattern", ()),
            spec.get("big_pairs", ()),
            spec.get("global_gain", 210),
            spec.get("big_table", 1),
            spec.get("count1table", 1),
        )
    main_data = md.pad_to_bytes()

    si = BitWriter()
    si.write(0, 8)  # main_data_begin
    si.write(0, 1 if n_ch == 1 else 2)  # private
    for ch in range(n_ch):
        spec = granule_specs[ch]
        n_big = len(spec.get("big_pairs", ()))
        si.write(lengths[ch], 12)
        si.write(n_big, 9)
        si.write(spec.get("global_gain", 210), 8)
        si.write(scalefac_compress, 9)
        si.write(0, 1)  # window_switching = 0 (long block)
        ts = spec.get("big_table", 1)
        si.write(ts, 5)
        si.write(ts, 5)
        si.write(ts, 5)
        si.write(0, 4)  # region0_count stored
        si.write(7, 3)  # region1_count stored
        si.write(0, 1)  # scalefac_scale (no preflag bit in MPEG2)
        si.write(spec.get("count1table", 1), 1)
    side_info = si.pad_to_bytes()
    assert len(side_info) == (9 if n_ch == 1 else 17), len(side_info)

    if version == 2.5:
        rates = {0: 11025, 1: 12000, 2: 8000}
        b1 = 0xE3  # 1110 0011: sync + MPEG2.5 + Layer3 + no CRC
    else:
        rates = {0: 22050, 1: 24000, 2: 16000}
        b1 = 0xF3  # 1111 0011: sync + MPEG2 + Layer3 + no CRC
    b0 = 0xFF
    b2 = (bitrate_idx << 4) | (sample_rate_idx << 2)
    b3 = (channel_mode << 6) | (mode_ext << 4)
    header = bytes([b0, b1, b2, b3])

    bitrate = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
               160][bitrate_idx] * 1000
    frame_size = 72 * bitrate // rates[sample_rate_idx]

    body = header + side_info + main_data
    if len(body) > frame_size:
        raise ValueError("main data too large for frame")
    return body + b"\x00" * (frame_size - len(body))


def build_mpeg1_l3_stream(n_frames: int, n_ch: int = 1, seed: int = 0) -> bytes:
    """A stream of simple frames with pseudo-random sparse spectra."""
    rng = np.random.default_rng(seed)
    frames = []
    for _f in range(n_frames):
        gspecs = []
        for _gr in range(2):
            chans = []
            for _ch in range(n_ch):
                n_quads = int(rng.integers(2, 12))
                quads = [
                    tuple(int(v) for v in rng.integers(-1, 2, size=4))
                    for _ in range(n_quads)
                ]
                n_big = int(rng.integers(0, 6))
                bigs = [
                    (int(rng.integers(-1, 2)), int(rng.integers(-1, 2)))
                    for _ in range(n_big)
                ]
                chans.append({
                    "quad_pattern": quads,
                    "big_pairs": bigs,
                    "global_gain": int(rng.integers(185, 206)),
                })
            gspecs.append(chans)
        frames.append(build_mpeg1_l3_frame(gspecs, n_ch=n_ch))
    return b"".join(frames)
