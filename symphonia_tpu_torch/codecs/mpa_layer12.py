"""MPEG Layer I / Layer II decode.

Analog of symphonia-bundle-mp3/src/layer1/mod.rs:62 and layer2/mod.rs:219:
per-subband bit allocation, scalefactors (Layer II with scfsi sharing and
grouped quantization classes from ISO 11172-3 Tables 3-B.2/3-B.4), linear
dequantization, intensity-stereo bound handling, and the shared 32-band
polyphase synthesis (via the superposition form in ops.mp3_dense).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np

from ..core.errors import DecodeError
from ..core.io.bits import BitReaderLtr
from ..ops.mp3_dense import polyphase_response_np
from .mpa_common import LAYER1, MODE_JOINT, MpaHeader, tables
from .. import native as _native_mod


@lru_cache(maxsize=None)
def _l1_factor() -> np.ndarray:
    """Layer 1 dequantization factors (layer1/mod.rs FACTOR)."""
    f = np.zeros(16, dtype=np.float32)
    for i in range(2, 16):
        a = 1 << i
        b = 1 << (i - 1)
        f[i] = (a / (a - 1)) / b
    return f


def _sign_extend(v: int, bits: int) -> int:
    v ^= 1 << (bits - 1)  # invert MSB
    if v & (1 << (bits - 1)):
        v -= 1 << bits
    return v


# Layer 2 quantization classes (ISO 11172-3 Table 3-B.4):
# (c, d, grouping, bits, nlevels)
QUANT_CLASS = [
    (4 / 3, 0.5, True, 5, 3),
    (8 / 5, 0.5, True, 7, 5),
    (8 / 7, 0.25, False, 3, 7),
    (16 / 9, 0.5, True, 10, 9),
    (16 / 15, 0.125, False, 4, 15),
    (32 / 31, 0.0625, False, 5, 31),
    (64 / 63, 0.03125, False, 6, 63),
    (128 / 127, 0.015625, False, 7, 127),
    (256 / 255, 0.0078125, False, 8, 255),
    (512 / 511, 0.00390625, False, 9, 511),
    (1024 / 1023, 0.001953125, False, 10, 1023),
    (2048 / 2047, 0.0009765625, False, 11, 2047),
    (4096 / 4095, 0.00048828125, False, 12, 4095),
    (8192 / 8191, 0.000244140625, False, 13, 8191),
    (16384 / 16383, 0.0001220703125, False, 14, 16383),
    (32768 / 32767, 0.00006103515625, False, 15, 32767),
    (65536 / 65535, 0.000030517578125, False, 16, 65535),
]

# Sub-band quantization info (Tables 3-B.2a-d): (nbal, class indices).
SB_QUANT_INFO = [
    (2, [0, 0, 1, 16]),
    (2, [0, 0, 1, 3]),
    (3, [0, 0, 1, 3, 4, 5, 6, 7]),
    (3, [0, 0, 1, 2, 3, 4, 5, 16]),
    (4, [0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]),
    (4, [0, 0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]),
    (4, [0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16]),
    (4, [0, 0, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]),
]

# (sblimit, per-subband row into SB_QUANT_INFO) — Tables 3-B.2a-d + 13818-3.
SB_INFO = [
    (27, [7, 7, 7, 6, 6, 6, 6, 6, 6, 6, 6, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3]),
    (30, [7, 7, 7, 6, 6, 6, 6, 6, 6, 6, 6, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0]),
    (8, [5, 5, 2, 2, 2, 2, 2, 2]),
    (12, [5, 5, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]),
    (30, [4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]),
]
# Row 0 (table 3-B.2a) covers 27 sub-bands: bands 23-26 use class row 0,
# exactly as 3-B.2b's trailing bands do (reference layer2/mod.rs:81-87).
SB_INFO[0] = (27, SB_INFO[0][1] + [0] * 4)


def _find_sb_info(header: MpaHeader):
    if header.is_mpeg1:
        n_ch = header.n_channels
        per_ch = header.bitrate // n_ch
        if per_ch <= 48000:
            idx = 3 if header.sample_rate == 32000 else 2
        elif per_ch <= 80000:
            idx = 0
        else:
            idx = 0 if header.sample_rate == 48000 else 1
    else:
        idx = 4
    return SB_INFO[idx]


class Layer12State:
    def __init__(self):
        # One contiguous [2, 480] tail shared by the fused native path
        # (sh_l12_stream_decode updates it in place) and the Python
        # _synthesize fallback, so either path can pick up mid-stream.
        self.synth_tails = np.zeros((2, 480), np.float32)
        self.pcm_buf = np.zeros((2, 1152), np.float32)
        self.stream = None  # None = undecided, False = fused path off
        # (header, precomputed native-call args): parse_header memoizes by
        # word, so identity is a valid key and the per-frame table/bound
        # lookups amortize to one dict hit.
        self._cfg = None

    def reset(self):
        self.synth_tails[:] = 0


def _synthesize(samples: np.ndarray, n_frames: int, state: Layer12State, ch: int) -> np.ndarray:
    """32-band polyphase synthesis with carried tail (synthesis.rs)."""
    sb = samples.reshape(32, n_frames)
    # Native polyphase (native/mp3_dense.cpp sh_mp3_polyphase) when
    # available; numpy oracle otherwise.
    resp = _native_mod.mp3_polyphase(sb.T)  # wrapper copies into its pool
    if resp is None:
        resp = polyphase_response_np(sb)
    out_len = 32 * n_frames
    tail = state.synth_tails[ch]
    out = resp[:out_len].copy()
    k = min(480, out_len)
    out[:k] += tail[:k]
    new_tail = resp[out_len:].copy()
    if out_len < 480:
        # The 480-sample tail reaches past one Layer I frame (384 samples):
        # carry the unconsumed remainder forward (synthesis.rs FIR state;
        # without this, taps 12-15 frames out are dropped).
        new_tail[: 480 - out_len] += tail[out_len:]
    tail[:] = new_tail
    return out


def _intensity_bound(header: MpaHeader) -> int:
    if header.channel_mode == MODE_JOINT:
        return (header.mode_ext + 1) * 4
    return 32


def decode_layer1(header: MpaHeader, frame: bytes, state: Layer12State) -> np.ndarray:
    pos = 4 + (2 if header.has_crc else 0)
    n_ch = header.n_channels
    sf_table = tables()["layer12_scalefactors"]
    bound = min(_intensity_bound(header), 32)

    # Native bitstream stage (native/mpa_layer12.cpp, bit-exact mirror);
    # any error status falls back to this Python path so malformed-input
    # behavior is identical.
    from .. import native as _native

    fast = _native.mpa_l12_extract(
        1, bytes(frame[pos:header.frame_size]), n_ch, bound, 32, None,
        sf_table)
    if fast is not None:
        out = np.zeros((n_ch, 384), dtype=np.float32)
        for ch in range(n_ch):
            out[ch] = _synthesize(fast[ch], 12, state, ch)
        return out

    br = BitReaderLtr(frame[pos : header.frame_size])
    factor = _l1_factor()

    alloc = np.zeros((2, 32), dtype=np.int64)
    for sb in range(bound):
        for ch in range(n_ch):
            bits = br.read_bits(4)
            if bits > 0xE:
                raise DecodeError("invalid L1 bit allocation")
            alloc[ch][sb] = bits + 1 if bits else 0
    for sb in range(bound, 32):
        bits = br.read_bits(4)
        if bits > 0xE:
            raise DecodeError("invalid L1 bit allocation")
        alloc[0][sb] = alloc[1][sb] = bits + 1 if bits else 0

    scalefacs = np.zeros((2, 32), dtype=np.float32)
    for sb in range(32):
        for ch in range(n_ch):
            if alloc[ch][sb]:
                scalefacs[ch][sb] = sf_table[br.read_bits(6)]

    samples = np.zeros((2, 384), dtype=np.float32)
    for s in range(12):
        for sb in range(bound):
            for ch in range(n_ch):
                bits = int(alloc[ch][sb])
                if bits:
                    raw = br.read_bits(bits)
                    v = float(factor[bits]) * (_sign_extend(raw, bits) + 1)
                    samples[ch][12 * sb + s] = scalefacs[ch][sb] * v
        for sb in range(bound, 32):
            bits = int(alloc[0][sb])
            if bits:
                raw = br.read_bits(bits)
                v = float(factor[bits]) * (_sign_extend(raw, bits) + 1)
                for ch in range(n_ch):
                    samples[ch][12 * sb + s] = scalefacs[ch][sb] * v

    out = np.zeros((n_ch, 384), dtype=np.float32)
    for ch in range(n_ch):
        out[ch] = _synthesize(samples[ch], 12, state, ch)
    return out


def decode_layer2(header: MpaHeader, frame: bytes, state: Layer12State) -> np.ndarray:
    pos = 4 + (2 if header.has_crc else 0)
    n_ch = header.n_channels
    sf_table = tables()["layer12_scalefactors"]
    sblimit, band_rows = _find_sb_info(header)
    bound = min(_intensity_bound(header), sblimit)

    # Native bitstream stage; see decode_layer1's note.
    from .. import native as _native

    fast = _native.mpa_l12_extract(
        2, bytes(frame[pos:header.frame_size]), n_ch, bound, sblimit,
        band_rows, sf_table)
    if fast is not None:
        out = np.zeros((n_ch, 1152), dtype=np.float32)
        for ch in range(n_ch):
            out[ch] = _synthesize(fast[ch], 36, state, ch)
        return out

    br = BitReaderLtr(frame[pos : header.frame_size])

    alloc = np.zeros((2, 32), dtype=np.int64)
    for sb in range(bound):
        nbal = SB_QUANT_INFO[band_rows[sb]][0]
        for ch in range(n_ch):
            alloc[ch][sb] = br.read_bits(nbal)
    for sb in range(bound, sblimit):
        nbal = SB_QUANT_INFO[band_rows[sb]][0]
        v = br.read_bits(nbal)
        alloc[0][sb] = alloc[1][sb] = v

    scfsi = np.zeros((2, 32), dtype=np.int64)
    for sb in range(sblimit):
        for ch in range(n_ch):
            if alloc[ch][sb]:
                scfsi[ch][sb] = br.read_bits(2)

    scalefacs = np.zeros((2, 3, 32), dtype=np.int64)
    for sb in range(sblimit):
        for ch in range(n_ch):
            if alloc[ch][sb]:
                i0 = br.read_bits(6)
                idx = [i0, i0, i0]
                s = scfsi[ch][sb]
                if s == 0:
                    idx[1] = br.read_bits(6)
                    idx[2] = br.read_bits(6)
                elif s == 1:
                    idx[2] = br.read_bits(6)
                elif s == 3:
                    idx[1] = br.read_bits(6)
                    idx[2] = idx[1]
                scalefacs[ch, :, sb] = idx

    def dequant_triplet(class_idx, row):
        c, d, grouping, bits, nlevels = QUANT_CLASS[SB_QUANT_INFO[row][1][class_idx]]
        raw = [0, 0, 0]
        if grouping:
            cw = br.read_bits(bits)
            for i in range(3):
                raw[i] = cw % nlevels
                cw //= nlevels
            # Effective sample width: bits of next_power_of_two(nlevels)
            # (layer2/mod.rs dequantize); grouped nlevels are 3/5/9.
            bits_eff = {3: 2, 5: 3, 9: 4}[nlevels]
        else:
            for i in range(3):
                raw[i] = br.read_bits(bits)
            bits_eff = bits
        div = float(1 << (bits_eff - 1))
        out = [0.0, 0.0, 0.0]
        for i in range(3):
            a = _sign_extend(raw[i], bits_eff)
            out[i] = c * (a / div + d)
        return out

    samples = np.zeros((2, 1152), dtype=np.float32)
    for gr in range(12):
        for sb in range(bound):
            row = band_rows[sb]
            for ch in range(n_ch):
                ci = int(alloc[ch][sb])
                if ci:
                    t = dequant_triplet(ci, row)
                    sf = float(sf_table[scalefacs[ch, gr // 4, sb]])
                    samples[ch, 36 * sb + 3 * gr : 36 * sb + 3 * gr + 3] = [
                        sf * t[0], sf * t[1], sf * t[2]
                    ]
        for sb in range(bound, sblimit):
            row = band_rows[sb]
            ci = int(alloc[0][sb])
            if ci:
                t = dequant_triplet(ci, row)
                for ch in range(n_ch):
                    sf = float(sf_table[scalefacs[ch, gr // 4, sb]])
                    samples[ch, 36 * sb + 3 * gr : 36 * sb + 3 * gr + 3] = [
                        sf * t[0], sf * t[1], sf * t[2]
                    ]

    out = np.zeros((n_ch, 1152), dtype=np.float32)
    for ch in range(n_ch):
        out[ch] = _synthesize(samples[ch], 36, state, ch)
    return out


def _decode_native(header: MpaHeader, frame: bytes, state: Layer12State):
    """Fused native per-packet path (native/mpa_layer12.cpp
    sh_l12_stream_decode): bitstream stage + polyphase + carried tail in
    one C++ call, the treatment sh_mp3_stream_decode gives Layer III.
    Returns the frame PCM, or None to fall back to decode_layer1/2 (the
    native side touches synth_tails only on success, so the fallback
    picks up with identical state)."""
    if state.stream is None:
        import os

        # SYMPHONIA_TPU_L12_STREAM=off forces the non-fused path
        # (parity testing / A-B measurement).
        if os.environ.get("SYMPHONIA_TPU_L12_STREAM") == "off":
            state.stream = False
        else:
            state.stream = _native_mod.l12_stream_caller(
                state.synth_tails, state.pcm_buf) or False
    if not state.stream:
        return None
    if state._cfg is None:
        state._cfg = {}
    cfg = state._cfg.get(id(header))
    if cfg is None or cfg[0] is not header:
        pos = 4 + (2 if header.has_crc else 0)
        n_ch = header.n_channels
        if header.layer == LAYER1:
            bound, sblimit, band_rows = (min(_intensity_bound(header), 32),
                                         32, None)
        else:
            sblimit, band_rows = _find_sb_info(header)
            bound = min(_intensity_bound(header), sblimit)
        cfg = (header, 1 if header.layer == LAYER1 else 2, pos, n_ch, bound,
               sblimit, _native_mod.l12_rows_ptr(band_rows),
               _native_mod.l12_sf_ptr(tables()["layer12_scalefactors"]))
        if len(state._cfg) < 64:  # headers vary by the padding bit only
            state._cfg[id(header)] = cfg
    _, layer, pos, n_ch, bound, sblimit, p_rows, p_sf = cfg
    n = state.stream(layer, frame[pos:header.frame_size], n_ch, bound,
                     sblimit, p_rows, p_sf)
    if n <= 0:
        return None
    return state.pcm_buf[:n_ch, :n].copy()


def decode_frame(header: MpaHeader, frame: bytes, state: Layer12State) -> np.ndarray:
    pcm = _decode_native(header, frame, state)
    if pcm is not None:
        return pcm
    if header.layer == LAYER1:
        return decode_layer1(header, frame, state)
    return decode_layer2(header, frame, state)
