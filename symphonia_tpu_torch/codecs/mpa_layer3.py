"""MPEG Layer III bitstream decode: side info, scalefactors, Huffman
spectrum, requantization, stereo, and short-block reordering.

Host entropy/prep stage of the MP3 pipeline. Semantics follow ISO/IEC
11172-3 / 13818-3 as realized in symphonia-bundle-mp3/src/layer3/
(bitstream.rs:57-427, requantize.rs:47-381, stereo.rs:143-556,
hybrid_synthesis.rs:153-222); the dense math downstream lives in
``symphonia_tpu.ops.mp3_dense``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from ..core.errors import DecodeError
from ..core.io.bits import BitReaderLtr
from ..core.io.codebook import Codebook
from ..ops.mp3_dense import BLOCK_END, BLOCK_LONG, BLOCK_SHORT, BLOCK_START
from .mpa_common import MODE_JOINT, MODE_MONO, MpaHeader, tables

NGRANULES = {True: 2, False: 1}  # is_mpeg1 -> granule count


@dataclass
class GranuleChannel:
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    block_type: int = BLOCK_LONG
    mixed: bool = False
    table_select: Tuple[int, int, int] = (0, 0, 0)
    subblock_gain: Tuple[int, int, int] = (0, 0, 0)
    region1_start: int = 0
    region2_start: int = 0
    preflag: bool = False
    scalefac_scale: bool = False
    count1table_select: int = 0
    scalefacs: np.ndarray = field(default_factory=lambda: np.zeros(40, np.int32))
    rzero: int = 0


@dataclass
class FrameData:
    main_data_begin: int = 0
    scfsi: List[List[bool]] = field(default_factory=list)
    granules: List[List[GranuleChannel]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def big_values_codebook(table_select: int) -> Tuple[Optional[Codebook], int]:
    """Codebook + linbits for a table_select (requantize.rs:85-92).

    Values pack the (x, y) pair as (x << 4) | y.
    """
    t = tables()
    linbits = int(t["linbits"][table_select])
    base = {0: None, 4: None, 14: None}
    n = table_select
    if n in (0, 4, 14):
        return None, linbits
    if 16 <= n <= 23:
        n = 16
    elif n >= 24:
        n = 24
    codes = t[f"codes_{n}"]
    bits = t[f"bits_{n}"]
    wrap = {4: 2, 9: 3, 16: 4, 36: 6, 64: 8, 256: 16}[len(codes)]
    values = [((i // wrap) << 4) | (i % wrap) for i in range(len(codes))]
    return Codebook.from_codes(codes, bits, values), linbits


@lru_cache(maxsize=None)
def quads_codebook(select: int) -> Codebook:
    t = tables()
    suffix = "a" if select == 0 else "b"
    codes = t[f"quads_codes_{suffix}"]
    bits = t[f"quads_bits_{suffix}"]
    return Codebook.from_codes(codes, bits, list(range(len(codes))))


@lru_cache(maxsize=None)
def pow43_table() -> np.ndarray:
    return (np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Side info (bitstream.rs:57-236)
# ---------------------------------------------------------------------------


def read_side_info(br: BitReaderLtr, header: MpaHeader) -> FrameData:
    fd = FrameData()
    n_ch = header.n_channels
    sfb_long = tables()["sfb_long"][header.sample_rate_idx]

    if header.is_mpeg1:
        fd.main_data_begin = br.read_bits(9)
        br.ignore_bits(5 if header.channel_mode == MODE_MONO else 3)
        fd.scfsi = [[bool(br.read_bit()) for _ in range(4)] for _ in range(n_ch)]
    else:
        fd.main_data_begin = br.read_bits(8)
        br.ignore_bits(1 if header.channel_mode == MODE_MONO else 2)
        fd.scfsi = [[False] * 4 for _ in range(n_ch)]

    n_granules = NGRANULES[header.is_mpeg1]
    for _gr in range(n_granules):
        chans = []
        for _ch in range(n_ch):
            c = GranuleChannel()
            c.part2_3_length = br.read_bits(12)
            c.big_values = br.read_bits(9)
            if c.big_values > 288:
                raise DecodeError("big_values > 288")
            c.global_gain = br.read_bits(8)
            c.scalefac_compress = br.read_bits(4 if header.is_mpeg1 else 9)
            window_switching = bool(br.read_bit())
            if window_switching:
                bt_enc = br.read_bits(2)
                mixed = bool(br.read_bit())
                if bt_enc == 0:
                    raise DecodeError("invalid block_type")
                c.block_type = {1: BLOCK_START, 2: BLOCK_SHORT, 3: BLOCK_END}[bt_enc]
                c.mixed = mixed and c.block_type == BLOCK_SHORT
                c.table_select = (br.read_bits(5), br.read_bits(5), 0)
                c.subblock_gain = (br.read_bits(3), br.read_bits(3), br.read_bits(3))
                # Implicit region boundaries (bitstream.rs:103-150).
                if header.version == 3:  # MPEG2.5
                    r0 = 6 if (c.block_type == BLOCK_SHORT and not c.mixed) else 8
                    c.region1_start = int(sfb_long[r0])
                elif header.is_mpeg1 or bt_enc == 2:
                    c.region1_start = 36
                else:
                    c.region1_start = 54
                c.region2_start = 576
            else:
                c.block_type = BLOCK_LONG
                c.table_select = (br.read_bits(5), br.read_bits(5), br.read_bits(5))
                r0 = br.read_bits(4) + 1
                r01 = br.read_bits(3) + r0 + 1
                c.region1_start = int(sfb_long[r0])
                c.region2_start = int(sfb_long[r01]) if r01 <= 22 else 576
            c.preflag = bool(br.read_bit()) if header.is_mpeg1 else False
            c.scalefac_scale = bool(br.read_bit())
            c.count1table_select = br.read_bit()
            chans.append(c)
        fd.granules.append(chans)
    return fd


# ---------------------------------------------------------------------------
# Scalefactors (bitstream.rs:240-427)
# ---------------------------------------------------------------------------


def read_scale_factors_mpeg1(br: BitReaderLtr, gr: int, ch: int, fd: FrameData) -> int:
    """Returns bits read."""
    c = fd.granules[gr][ch]
    slen1, slen2 = (int(v) for v in tables()["slen"][c.scalefac_compress])
    bits = 0
    if c.block_type == BLOCK_SHORT:
        n_sfb = 8 + 3 * 3 if c.mixed else 6 * 3
        if slen1:
            for sfb in range(n_sfb):
                c.scalefacs[sfb] = br.read_bits(slen1)
            bits += n_sfb * slen1
        if slen2:
            for sfb in range(n_sfb, n_sfb + 18):
                c.scalefacs[sfb] = br.read_bits(slen2)
            bits += 18 * slen2
    else:
        ranges = [(0, 6), (6, 11), (11, 16), (16, 21)]
        for i, (start, end) in enumerate(ranges):
            slen = slen1 if i < 2 else slen2
            if gr > 0 and fd.scfsi[ch][i]:
                c.scalefacs[start:end] = fd.granules[0][ch].scalefacs[start:end]
            elif slen:
                for sfb in range(start, end):
                    c.scalefacs[sfb] = br.read_bits(slen)
                bits += slen * (end - start)
    return bits


def read_scale_factors_mpeg2(
    br: BitReaderLtr, is_intensity: bool, c: GranuleChannel
) -> int:
    t = tables()
    block_index = 2 if (c.block_type == BLOCK_SHORT and c.mixed) else (
        1 if c.block_type == BLOCK_SHORT else 0
    )
    if is_intensity:
        sfc = c.scalefac_compress >> 1
        if sfc < 180:
            slens = [sfc // 36, (sfc % 36) // 6, (sfc % 36) % 6, 0]
            nsfb = t["mpeg2_nsfb"][0][block_index]
        elif sfc < 244:
            slens = [((sfc - 180) % 64) >> 4, ((sfc - 180) % 16) >> 2,
                     (sfc - 180) % 4, 0]
            nsfb = t["mpeg2_nsfb"][1][block_index]
        else:
            slens = [(sfc - 244) // 3, (sfc - 244) % 3, 0, 0]
            nsfb = t["mpeg2_nsfb"][2][block_index]
    else:
        sfc = c.scalefac_compress
        c.preflag = sfc >= 500
        if sfc < 400:
            slens = [(sfc >> 4) // 5, (sfc >> 4) % 5, (sfc % 16) >> 2, sfc % 4]
            nsfb = t["mpeg2_nsfb"][3][block_index]
        elif sfc < 500:
            slens = [((sfc - 400) >> 2) // 5, ((sfc - 400) >> 2) % 5,
                     (sfc - 400) % 4, 0]
            nsfb = t["mpeg2_nsfb"][4][block_index]
        else:
            slens = [(sfc - 500) // 3, (sfc - 500) % 3, 0, 0]
            nsfb = t["mpeg2_nsfb"][5][block_index]
    bits = 0
    start = 0
    for slen, n_sfb in zip(slens, (int(v) for v in nsfb)):
        if slen:
            for sfb in range(start, start + n_sfb):
                c.scalefacs[sfb] = br.read_bits(int(slen))
            bits += int(slen) * n_sfb
        start += n_sfb
    return bits


# ---------------------------------------------------------------------------
# Huffman spectrum (requantize.rs:47-237)
# ---------------------------------------------------------------------------


def read_huffman_samples(
    br: BitReaderLtr, c: GranuleChannel, part3_bits: int
) -> np.ndarray:
    """Decode spectral samples; returns buf[576] of +/-|s|^(4/3); sets
    ``c.rzero``."""
    buf = np.zeros(576, dtype=np.float32)
    if part3_bits == 0:
        c.rzero = 0
        return buf
    pow43 = pow43_table()
    bits_read = 0
    i = 0
    big_values_len = 2 * c.big_values
    regions = [
        min(c.region1_start, big_values_len),
        min(c.region2_start, big_values_len),
        min(576, big_values_len),
    ]
    start_bits = br.bits_read()
    for region_idx, region_end in enumerate(regions):
        codebook, linbits = big_values_codebook(c.table_select[region_idx])
        if codebook is None:
            i = max(i, region_end)
            continue
        while i < region_end and bits_read < part3_bits:
            value = codebook.decode_ltr(br)
            x = value >> 4
            y = value & 0xF
            if x:
                if x == 15 and linbits:
                    x += br.read_bits(linbits)
                sign = br.read_bit()
                buf[i] = -pow43[x] if sign else pow43[x]
            i += 1
            if y:
                if y == 15 and linbits:
                    y += br.read_bits(linbits)
                sign = br.read_bit()
                buf[i] = -pow43[y] if sign else pow43[y]
            i += 1
            bits_read = br.bits_read() - start_bits
    # count1 partition: quads.
    cb1 = quads_codebook(c.count1table_select)
    while i <= 572 and bits_read < part3_bits:
        value = cb1.decode_ltr(br)
        for bitpos, off in ((0x8, 0), (0x4, 1), (0x2, 2), (0x1, 3)):
            if value & bitpos:
                buf[i + off] = -1.0 if br.read_bit() else 1.0
        i += 4
        bits_read = br.bits_read() - start_bits
    if bits_read < part3_bits:
        br.ignore_bits(part3_bits - bits_read)
    elif bits_read > part3_bits and i > big_values_len:
        # count1 overrun (requantize.rs:218): undo the last quad.
        i -= 4
        buf[i : i + 4] = 0.0
    c.rzero = i
    return buf


# ---------------------------------------------------------------------------
# Requantization (requantize.rs:240-381)
# ---------------------------------------------------------------------------

PRE_EMPHASIS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0],
    dtype=np.int32,
)


def _band_exponents_long(c: GranuleChannel, bands: np.ndarray) -> np.ndarray:
    """Per-band exponent (A - B)/4 factors for long bands."""
    a = c.global_gain - 210
    shift = 2 if c.scalefac_scale else 1
    n = len(bands) - 1
    pre = PRE_EMPHASIS[:n] if c.preflag else np.zeros(n, np.int32)
    b = (c.scalefacs[:n] + pre) << shift
    return np.exp2(0.25 * (a - b)).astype(np.float32)


def requantize(header: MpaHeader, c: GranuleChannel, buf: np.ndarray) -> None:
    """In-place requantization of the 576-sample buffer."""
    t = tables()
    sr = header.sample_rate_idx
    if c.block_type == BLOCK_SHORT and not c.mixed:
        bands = t["sfb_short"][sr]
        _requantize_short(c, bands, 0, buf)
    elif c.block_type == BLOCK_SHORT and c.mixed:
        bands = t[f"sfb_mixed_{sr}"]
        switch = int(t["sfb_mixed_switch"][sr])
        _requantize_long(c, bands[: switch + 1], buf)
        _requantize_short(c, bands[switch:], switch, buf)
    else:
        _requantize_long(c, t["sfb_long"][sr], buf)


def _requantize_long(c: GranuleChannel, bands, buf: np.ndarray) -> None:
    a = c.global_gain - 210
    shift = 2 if c.scalefac_scale else 1
    for i in range(len(bands) - 1):
        start, end = int(bands[i]), int(bands[i + 1])
        if start >= c.rzero:
            break
        pre = int(PRE_EMPHASIS[i]) if c.preflag else 0
        b = int(c.scalefacs[i] + pre) << shift
        buf[start : min(end, c.rzero)] *= np.float32(2.0 ** (0.25 * (a - b)))


def _requantize_short(c: GranuleChannel, bands, switch: int, buf: np.ndarray) -> None:
    gain = c.global_gain - 210
    a = [gain - 8 * g for g in c.subblock_gain]
    shift = 2 if c.scalefac_scale else 1
    for i in range(len(bands) - 1):
        start, end = int(bands[i]), int(bands[i + 1])
        if start >= c.rzero:
            break
        b = int(c.scalefacs[switch + i]) << shift
        buf[start : min(end, c.rzero)] *= np.float32(2.0 ** (0.25 * (a[i % 3] - b)))


# ---------------------------------------------------------------------------
# Reorder (hybrid_synthesis.rs:153-222)
# ---------------------------------------------------------------------------


def reorder(header: MpaHeader, c: GranuleChannel, buf: np.ndarray) -> None:
    if c.block_type != BLOCK_SHORT:
        return
    t = tables()
    sr = header.sample_rate_idx
    if c.mixed:
        switch = int(t["sfb_mixed_switch"][sr])
        bands = t[f"sfb_mixed_{sr}"][switch:]
    else:
        bands = t["sfb_short"][sr]
    out = buf.copy()
    start = int(bands[0])
    i = start
    for bi in range(0, len(bands) - 3, 3):
        s0, s1, s2, s3 = (int(v) for v in bands[bi : bi + 4])
        if s0 >= c.rzero:
            break
        w = s1 - s0
        win0, win1, win2 = buf[s0:s1], buf[s1:s2], buf[s2:s3]
        block = np.empty(3 * w, dtype=np.float32)
        block[0::3] = win0
        block[1::3] = win1
        block[2::3] = win2
        out[i : i + 3 * w] = block
        i += 3 * w
    buf[start:i] = out[start:i]
    c.rzero = max(c.rzero, i)


# ---------------------------------------------------------------------------
# Stereo (stereo.rs:143-556)
# ---------------------------------------------------------------------------

SQRT1_2 = np.float32(1.0 / np.sqrt(2.0))


@lru_cache(maxsize=None)
def intensity_ratios_mpeg1() -> np.ndarray:
    """[7, 2] (k_l, k_r) from is_ratio = tan(is_pos * pi/12)."""
    out = np.zeros((7, 2), dtype=np.float32)
    for p in range(7):
        r = np.tan(p * np.pi / 12)
        out[p] = (r / (1 + r), 1 / (1 + r))
    out[6] = (1.0, 0.0)
    return out


@lru_cache(maxsize=None)
def intensity_ratios_mpeg2() -> np.ndarray:
    """[2, 32, 2] per (scalefac_compress & 1, is_pos)."""
    out = np.zeros((2, 32, 2), dtype=np.float32)
    scales = [1.0 / np.sqrt(np.sqrt(2.0)), 1.0 / np.sqrt(2.0)]
    for s, i0 in enumerate(scales):
        for p in range(32):
            if p & 1:
                out[s, p] = (i0 ** ((p + 1) / 2.0), 1.0)
            else:
                out[s, p] = (1.0, i0 ** (p / 2.0))
    return out


def _mid_side(ch0: np.ndarray, ch1: np.ndarray) -> None:
    left = (ch0 + ch1) * SQRT1_2
    right = (ch0 - ch1) * SQRT1_2
    ch0[:] = left
    ch1[:] = right


def _intensity(pos, table, inv_pos, mid_side, ch0, ch1) -> None:
    if pos < inv_pos:
        kl, kr = table[pos]
        s = ch0.copy()
        ch0[:] = kl * s
        ch1[:] = kr * s
    elif mid_side:
        _mid_side(ch0, ch1)


def stereo(header: MpaHeader, granule: List[GranuleChannel], ch0: np.ndarray, ch1: np.ndarray) -> None:
    """Joint stereo decode for one granule (stereo.rs:487-556)."""
    if header.channel_mode != MODE_JOINT:
        return
    mid_side = header.is_mid_side
    intensity = header.is_intensity_stereo
    if not mid_side and not intensity:
        return
    c0, c1 = granule[0], granule[1]
    if c0.block_type != c1.block_type or c0.mixed != c1.mixed:
        raise DecodeError("stereo block_type mismatch")
    end = max(c0.rzero, c1.rzero)

    if header.is_mpeg1:
        is_table, inv_pos = intensity_ratios_mpeg1(), 7
    else:
        is_table = intensity_ratios_mpeg2()[c1.scalefac_compress & 1]
        inv_pos = 31

    t = tables()
    sr = header.sample_rate_idx

    if intensity:
        if c1.block_type == BLOCK_SHORT:
            bound = _intensity_short(header, c1, is_table, inv_pos, mid_side,
                                     end, ch0, ch1)
        else:
            bound = _intensity_long(header, c1, is_table, inv_pos, mid_side,
                                    end, ch0, ch1)
    else:
        bound = end

    if mid_side and bound > 0:
        _mid_side(ch0[:bound], ch1[:bound])

    if intensity or mid_side:
        c0.rzero = end
        c1.rzero = end


def _intensity_long(header, c1, is_table, inv_pos, mid_side, max_bound, ch0, ch1):
    bands = tables()["sfb_long"][header.sample_rate_idx]
    is_pos = np.empty(22, dtype=np.int64)
    is_pos[:22] = c1.scalefacs[:22]
    is_pos[21] = is_pos[20]
    bound = max_bound
    for i in range(21, -1, -1):
        start, end = int(bands[i]), int(bands[i + 1])
        zero = start >= c1.rzero or not np.any(ch1[start:end])
        if not zero:
            break
        _intensity(int(is_pos[i]), is_table, inv_pos, mid_side,
                   ch0[start:end], ch1[start:end])
        bound = start
    return bound


def _intensity_short(header, c1, is_table, inv_pos, mid_side, max_bound, ch0, ch1):
    t = tables()
    sr = header.sample_rate_idx
    if c1.mixed:
        bands = t[f"sfb_mixed_{sr}"]
        switch = int(t["sfb_mixed_switch"][sr])
        short_bands = bands[switch:]
        long_bands = bands[: switch + 1]
        sfi = len(bands) - 1
    else:
        short_bands = t["sfb_short"][sr]
        long_bands = None
        sfi = 39
    is_pos = np.zeros(39, dtype=np.int64)
    is_pos[:36] = c1.scalefacs[:36]
    is_pos[36:39] = c1.scalefacs[33:36]

    window_is_zero = [True, True, True]
    bound = max_bound
    found = False
    n_bands = (len(short_bands) - 1) // 3
    for bi in range(n_bands - 1, -1, -1):
        s = [int(short_bands[3 * bi + j]) for j in range(4)]
        for w in (2, 1, 0):
            lo, hi = s[w], s[w + 1]
            window_is_zero[w] = window_is_zero[w] and not np.any(ch1[lo:hi])
            if window_is_zero[w]:
                _intensity(int(is_pos[sfi - 1]), is_table, inv_pos, mid_side,
                           ch0[lo:hi], ch1[lo:hi])
            elif mid_side:
                _mid_side(ch0[lo:hi], ch1[lo:hi])
            sfi -= 1
        bound = s[0]
        found = not any(window_is_zero)
        if found:
            break

    if not found and long_bands is not None:
        for i in range(len(long_bands) - 2, -1, -1):
            start, end = int(long_bands[i]), int(long_bands[i + 1])
            if np.any(ch1[start:end]):
                break
            _intensity(int(is_pos[sfi - 1]), is_table, inv_pos, mid_side,
                       ch0[start:end], ch1[start:end])
            sfi -= 1
            bound = start
    return bound
