"""AAC-LC decoder.

Analog of symphonia-codec-aac (``AacDecoder``, aac/mod.rs:42): GA syntactic
element loop SCE/CPE/LFE/DSE/PCE/FIL (aac/mod.rs:126-223); per ICS: window
info (ics/mod.rs:300), section data (:234), scalefactors (:310), spectral
Huffman quads/pairs with escapes (:365-616), PNS noise via LCG (:472),
pulse (ics/pulse.rs), TNS all-pole filter (ics/tns.rs); CPE mid-side +
intensity (cpe.rs); filterbank: IMDCT 2048/256 + sine/KBD windows with the
four window-sequence overlap-add shapes (dsp.rs:22-159, window.rs:63).

HE-AAC (SBR/PS) payloads are skipped, matching the reference's support
level (README:105-107).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..common.mpeg import AOT_AAC_LC, SAMPLE_RATES, AudioSpecificConfig
from ..core.audio import AudioBuffer, AudioSpec, Channels
from ..core.codecs import (
    CODEC_ID_AAC,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
)
from ..core.errors import DecodeError, Unsupported
from ..core.io.bits import BitReaderLtr
from ..core.io.codebook import Codebook
from ..ops.imdct_host import have_fast_imdct, imdct_dct4
from .. import native as _native_mod

MAX_WINDOWS = 8
MAX_SFBS = 64

ONLY_LONG = 0
LONG_START = 1
EIGHT_SHORT = 2
LONG_STOP = 3

ZERO_HCB = 0
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15
RESERVED_HCB = 12

# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _tables():
    path = Path(__file__).resolve().parent.parent / "data" / "aac_tables.npz"
    return dict(np.load(path))


# (sample-rate threshold, long table, short table) — aac/common.rs
# AAC_SUBBAND_INFO; rate_idx is the row index (for TNS band limits).
_SUBBAND_INFO = [
    (92017, "swb_96k_long", "swb_64k_short"),
    (75132, "swb_96k_long", "swb_64k_short"),
    (55426, "swb_64k_long", "swb_64k_short"),
    (46009, "swb_48k_long", "swb_48k_short"),
    (37566, "swb_48k_long", "swb_48k_short"),
    (27713, "swb_32k_long", "swb_48k_short"),
    (23004, "swb_24k_long", "swb_24k_short"),
    (18783, "swb_24k_long", "swb_24k_short"),
    (13856, "swb_16k_long", "swb_16k_short"),
    (11502, "swb_16k_long", "swb_16k_short"),
    (9391, "swb_16k_long", "swb_16k_short"),
    (0, "swb_8k_long", "swb_8k_short"),
]

TNS_MAX_LONG_BANDS = [31, 31, 34, 40, 42, 51, 46, 46, 42, 42, 42, 39]
TNS_MAX_SHORT_BANDS = [9, 9, 10, 14, 14, 14, 14, 14, 14, 14, 14, 14]


def subband_info(rate: int):
    for i, (thresh, ln, sn) in enumerate(_SUBBAND_INFO):
        if rate >= thresh:
            t = _tables()
            return i, t[ln].tolist(), t[sn].tolist()
    raise DecodeError("invalid sample rate")


@lru_cache(maxsize=None)
def spectrum_codebook(n: int) -> Codebook:
    t = _tables()
    codes = t[f"spec_codes_{n}"]
    lens = t[f"spec_lens_{n}"]
    return Codebook.from_codes(codes, lens, list(range(len(codes))))


@lru_cache(maxsize=None)
def scf_codebook() -> Codebook:
    t = _tables()
    return Codebook.from_codes(t["scf_codes"], t["scf_lens"],
                               list(range(len(t["scf_codes"]))))


@lru_cache(maxsize=None)
def pow43_table() -> np.ndarray:
    return (np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)).astype(np.float32)


@lru_cache(maxsize=None)
def normal_scf_table() -> np.ndarray:
    i = np.arange(256, dtype=np.float64)
    return np.exp2(0.25 * (i - 56 - 100)).astype(np.float32)


@lru_cache(maxsize=None)
def intensity_scf_table() -> np.ndarray:
    i = np.arange(256, dtype=np.float64)
    return np.exp2(-0.25 * (i - 155)).astype(np.float32)


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    val = np.ones_like(x)
    for n in range(63, 0, -1):
        val = val * x / (n * n) + 1.0
    return val


@lru_cache(maxsize=None)
def kbd_window(size: int, alpha: float) -> np.ndarray:
    """Kaiser-Bessel derived half-window (window.rs generate_window)."""
    n = np.arange(size, dtype=np.float64)
    a2 = (alpha * np.pi / size) ** 2
    b = _bessel_i0(n * (size - n) * a2)
    cum = np.cumsum(b)
    total = cum[-1] + 1.0
    return np.sqrt(cum / total).astype(np.float32)


@lru_cache(maxsize=None)
def sine_window(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    return np.sin((n + 0.5) * np.pi / (2 * size)).astype(np.float32)


@lru_cache(maxsize=None)
def imdct_matrix_scaled(n_in: int) -> np.ndarray:
    """[2*n_in, n_in] IMDCT matrix with the AAC 1/(2*n_in) scale
    (dsp.rs: Imdct::new_scaled(n, 1/(2n)))."""
    n_out = 2 * n_in
    i = np.arange(n_out)[:, None]
    j = np.arange(n_in)[None, :]
    m = np.cos(np.pi / (2 * n_out) * (2 * i + 1 + n_in) * (2 * j + 1))
    return (m / n_out).astype(np.float32)


@lru_cache(maxsize=None)
def aac_quad(idx: int):
    return (idx // 27, (idx // 9) % 3, (idx // 3) % 3, idx % 3)


def _pair_value(cb_idx: int, code: int):
    if cb_idx in (5, 6):
        return code // 9 - 4, code % 9 - 4
    if cb_idx in (7, 8):
        return code // 8, code % 8
    if cb_idx in (9, 10):
        return code // 13, code % 13
    return code // 17, code % 17  # cb 11


class Lcg:
    """Numerical Recipes LCG (aac/common.rs), ffmpeg-compatible seed."""

    def __init__(self, state: int = 0x1F2E3D4C):
        self.state = state

    def next(self) -> int:
        self.state = (self.state * 1664525 + 1013904223) & 0xFFFFFFFF
        v = self.state
        return v - (1 << 32) if v & 0x80000000 else v


# ---------------------------------------------------------------------------
# ICS
# ---------------------------------------------------------------------------


@dataclass
class IcsInfo:
    window_sequence: int = ONLY_LONG
    prev_window_sequence: int = ONLY_LONG
    window_shape: bool = False
    prev_window_shape: bool = False
    scale_factor_grouping: List[bool] = field(default_factory=lambda: [False] * 7)
    group_start: List[int] = field(default_factory=lambda: [0] * MAX_WINDOWS)
    window_groups: int = 1
    num_windows: int = 1
    max_sfb: int = 0
    long_win: bool = True

    def decode(self, br: BitReaderLtr) -> None:
        self.prev_window_sequence = self.window_sequence
        self.prev_window_shape = self.window_shape
        if br.read_bits(1):
            raise DecodeError("ics reserved bit set")
        self.window_sequence = br.read_bits(2)
        self.window_shape = bool(br.read_bits(1))
        self.window_groups = 1
        self.group_start = [0] * MAX_WINDOWS
        if self.window_sequence == EIGHT_SHORT:
            self.long_win = False
            self.num_windows = 8
            self.max_sfb = br.read_bits(4)
            self.scale_factor_grouping = []
            for i in range(7):
                grouped = bool(br.read_bits(1))
                self.scale_factor_grouping.append(grouped)
                if not grouped:
                    self.group_start[self.window_groups] = i + 1
                    self.window_groups += 1
        else:
            self.long_win = True
            self.num_windows = 1
            self.max_sfb = br.read_bits(6)
            if br.read_bits(1):
                raise Unsupported("AAC LTP data")

    def get_group_start(self, g: int) -> int:
        if g == 0:
            return 0
        if g >= self.window_groups:
            return 1 if self.long_win else 8
        return self.group_start[g]

    def copy_from_common(self, other: "IcsInfo") -> None:
        prev_seq = self.window_sequence
        prev_shape = self.window_shape
        for k, v in vars(other).items():
            setattr(self, k, list(v) if isinstance(v, list) else v)
        self.prev_window_sequence = prev_seq
        self.prev_window_shape = prev_shape


@dataclass
class TnsFilter:
    length: int = 0
    order: int = 0
    direction: bool = False
    coef: np.ndarray = field(default_factory=lambda: np.zeros(21, np.float32))


class Ics:
    def __init__(self, bands_long, bands_short):
        self.info = IcsInfo()
        self.bands_long = bands_long
        self.bands_short = bands_short
        self.global_gain = 0
        self.sfb_cb = np.zeros((MAX_WINDOWS, MAX_SFBS), np.int32)
        self.scales = np.zeros((MAX_WINDOWS, MAX_SFBS), np.float32)
        self.coeffs = np.zeros(1024, np.float32)
        self.delay = np.zeros(1024, np.float32)
        self.tns: Optional[List] = None
        self.pulse = None

    def reset(self):
        self.info = IcsInfo()
        self.delay[:] = 0

    def get_bands(self):
        return self.bands_long if self.info.long_win else self.bands_short

    # -- section data (ics/mod.rs:234) ------------------------------------

    def decode_section_data(self, br: BitReaderLtr) -> None:
        sect_bits = 5 if self.info.long_win else 3
        esc = (1 << sect_bits) - 1
        self.sfb_cb[:] = 0
        for g in range(self.info.window_groups):
            k = 0
            l = 0
            while k < self.info.max_sfb:
                if l >= MAX_SFBS:
                    raise DecodeError("too many sections")
                cb = br.read_bits(4)
                if cb == RESERVED_HCB:
                    raise DecodeError("invalid band type")
                length = 0
                while True:
                    incr = br.read_bits(sect_bits)
                    length += incr
                    if incr < esc:
                        break
                if k + length > self.info.max_sfb:
                    raise DecodeError("section overruns max_sfb")
                self.sfb_cb[g, k : k + length] = cb
                k += length
                l += 1

    # -- scalefactors (ics/mod.rs:310) ------------------------------------

    def decode_scale_factors(self, br: BitReaderLtr) -> None:
        noise_pcm_flag = True
        scf_intensity = 155
        scf_noise = self.global_gain - 90 + 100
        scf_normal = self.global_gain
        scf = scf_codebook()
        tn = normal_scf_table()
        ti = intensity_scf_table()
        self.scales[:] = 0
        for g in range(self.info.window_groups):
            for sfb in range(self.info.max_sfb):
                cb = self.sfb_cb[g, sfb]
                if cb == ZERO_HCB:
                    self.scales[g, sfb] = 0.0
                elif cb in (INTENSITY_HCB, INTENSITY_HCB2):
                    scf_intensity += scf.decode_ltr(br) - 60
                    if not 0 <= scf_intensity < 256:
                        raise DecodeError("intensity scalefactor out of range")
                    self.scales[g, sfb] = ti[scf_intensity]
                elif cb == NOISE_HCB:
                    if noise_pcm_flag:
                        noise_pcm_flag = False
                        scf_noise += br.read_bits(9) - 256
                    else:
                        scf_noise += scf.decode_ltr(br) - 60
                    if not 0 <= scf_noise < 256:
                        raise DecodeError("noise scalefactor out of range")
                    self.scales[g, sfb] = tn[scf_noise]
                else:
                    scf_normal += scf.decode_ltr(br) - 60
                    if not 0 <= scf_normal < 256:
                        raise DecodeError("scalefactor out of range")
                    self.scales[g, sfb] = tn[scf_normal]

    # -- pulse (ics/pulse.rs) ---------------------------------------------

    def decode_pulse(self, br: BitReaderLtr) -> None:
        if not br.read_bits(1):
            self.pulse = None
            return
        n = br.read_bits(2) + 1
        start_sfb = br.read_bits(6)
        pulses = [(br.read_bits(5), br.read_bits(4)) for _ in range(n)]
        self.pulse = (start_sfb, pulses)
        if not self.info.long_win:
            raise DecodeError("pulse data in short window")

    def synth_pulse(self) -> None:
        if self.pulse is None:
            return
        bands = self.get_bands()
        start_sfb, pulses = self.pulse
        if start_sfb >= len(bands) - 1:
            return
        k = bands[start_sfb]
        band = start_sfb
        for off, amp in pulses:
            k += off
            if k >= 1024:
                return
            while bands[band + 1] <= k:
                band += 1
            scale = self.scales[0, band]
            # Return to the quantized domain, add the pulse amplitude toward
            # the sign, and requantize (ics/pulse.rs synth).
            base = self.coeffs[k]
            if base != 0.0:
                base = np.sign(base) * abs(base) ** 0.75
            base = base + amp if base > 0 else base - amp
            self.coeffs[k] = np.sign(base) * abs(base) ** (4.0 / 3.0) * scale

    # -- TNS (ics/tns.rs) --------------------------------------------------

    def decode_tns(self, br: BitReaderLtr) -> None:
        if not br.read_bits(1):
            self.tns = None
            return
        max_order = 7 if not self.info.long_win else 12
        filters: List[List[TnsFilter]] = []
        for w in range(self.info.num_windows):
            n_filt = br.read_bits(2 if self.info.long_win else 1)
            coef_res = bool(br.read_bits(1)) if n_filt else False
            wf = []
            for _ in range(n_filt):
                f = TnsFilter()
                f.length = br.read_bits(6 if self.info.long_win else 4)
                f.order = br.read_bits(5 if self.info.long_win else 3)
                if f.order > max_order:
                    raise DecodeError("TNS order too high")
                if f.order:
                    f.direction = bool(br.read_bits(1))
                    compress = br.read_bits(1)
                    bits = (4 if coef_res else 3) - compress
                    sign_mask = 1 << (bits - 1)
                    fac_base = 8.0 if coef_res else 4.0
                    iqfac = (fac_base - 0.5) / (np.pi / 2)
                    iqfac_m = (fac_base + 0.5) / (np.pi / 2)
                    tmp = np.zeros(f.order, np.float32)
                    for i in range(f.order):
                        v = br.read_bits(bits)
                        c = float(v - (1 << bits)) if v & sign_mask else float(v)
                        tmp[i] = np.sin(c / (iqfac if c >= 0 else iqfac_m))
                    # Levinson-style expansion to LPC coefficients.
                    coef = np.zeros(21, np.float32)
                    b = np.zeros(21, np.float32)
                    for m in range(1, f.order + 1):
                        for i in range(1, m):
                            b[i] = coef[i - 1] + tmp[m - 1] * coef[m - i - 1]
                        coef[: m - 1] = b[1:m]
                        coef[m - 1] = tmp[m - 1]
                    f.coef = coef
                wf.append(f)
            filters.append(wf)
        self.tns = filters

    def synth_tns(self, rate_idx: int) -> None:
        if self.tns is None:
            return
        bands = self.get_bands()
        tmb = (TNS_MAX_LONG_BANDS[rate_idx] if self.info.long_win
               else TNS_MAX_SHORT_BANDS[rate_idx])
        tmb = min(tmb, self.info.max_sfb)
        for w in range(self.info.num_windows):
            bottom = len(bands) - 1
            for f in self.tns[w]:
                top = bottom
                bottom = max(0, top - f.length)
                order = f.order
                if order == 0:
                    continue
                start = w * 128 + bands[min(bottom, tmb)]
                end = w * 128 + bands[min(top, tmb)]
                lpc = f.coef
                c = self.coeffs
                if not f.direction:
                    for m, i in enumerate(range(start, end)):
                        for j in range(min(order, m)):
                            c[i] -= c[i - j - 1] * lpc[j]
                else:
                    for m, i in enumerate(range(end - 1, start - 1, -1)):
                        for j in range(min(order, m)):
                            c[i] -= c[i + j + 1] * lpc[j]

    # -- spectrum (ics/mod.rs:365-616) -------------------------------------

    def decode_spectrum(self, br: BitReaderLtr, lcg: Lcg) -> None:
        self.coeffs[:] = 0
        bands = self.get_bands()
        pow43 = pow43_table()
        for g in range(self.info.window_groups):
            cur_w = self.info.get_group_start(g)
            next_w = self.info.get_group_start(g + 1)
            for sfb in range(self.info.max_sfb):
                start, end = bands[sfb], bands[sfb + 1]
                cb_idx = int(self.sfb_cb[g, sfb])
                scale = float(self.scales[g, sfb])
                for w in range(cur_w, next_w):
                    o = w * 128
                    if cb_idx in (ZERO_HCB, RESERVED_HCB, INTENSITY_HCB, INTENSITY_HCB2):
                        continue
                    if cb_idx == NOISE_HCB:
                        self._decode_noise(lcg, scale, o + start, o + end)
                    elif cb_idx <= 4:
                        self._decode_quads(br, cb_idx, scale, o + start, o + end, pow43)
                    else:
                        self._decode_pairs(br, cb_idx, scale, o + start, o + end, pow43)

    def _decode_noise(self, lcg: Lcg, scale: float, start: int, end: int) -> None:
        vals = np.array([float(np.int16(lcg.next() >> 16)) for _ in range(end - start)],
                        dtype=np.float32)
        # Energy accumulates in f64 (exact for int16^2 sums, so independent
        # of summation order — keeps the native stage bit-identical).
        energy = float((vals.astype(np.float64) ** 2).sum())
        if energy > 0:
            vals *= np.float32(scale / np.sqrt(energy))
        self.coeffs[start:end] = vals

    def _decode_quads(self, br, cb_idx, scale, start, end, pow43) -> None:
        cb = spectrum_codebook(cb_idx)
        signed = cb_idx in (1, 2)
        c = self.coeffs
        # Same dequant formula as the pair books (sign * pow43[|q|] * scale,
        # one f32 multiply) so the vectorized native stage is bit-identical.
        for i in range(start, end, 4):
            code = cb.decode_ltr(br)
            q = aac_quad(code)
            if signed:
                for j, v in enumerate(q):
                    v -= 1
                    c[i + j] = np.sign(v) * pow43[abs(v)] * scale
            else:
                for j, v in enumerate(q):
                    if v:
                        sign = -1.0 if br.read_bits(1) else 1.0
                        c[i + j] = sign * pow43[v] * scale

    def _decode_pairs(self, br, cb_idx, scale, start, end, pow43) -> None:
        cb = spectrum_codebook(cb_idx)
        signed = cb_idx in (5, 6)
        escape = cb_idx == 11
        c = self.coeffs
        for i in range(start, end, 2):
            code = cb.decode_ltr(br)
            x, y = _pair_value(cb_idx, code)
            if signed:
                c[i] = np.sign(x) * pow43[abs(x)] * scale
                c[i + 1] = np.sign(y) * pow43[abs(y)] * scale
            else:
                sx = (-1.0 if br.read_bits(1) else 1.0) if x else 1.0
                sy = (-1.0 if br.read_bits(1) else 1.0) if y else 1.0
                if escape and x == 16:
                    x = self._read_escape(br)
                if escape and y == 16:
                    y = self._read_escape(br)
                c[i] = sx * pow43[x] * scale
                c[i + 1] = sy * pow43[y] * scale

    @staticmethod
    def _read_escape(br) -> int:
        n = br.read_unary_ones()
        if n >= 9:
            raise DecodeError("invalid spectral escape")
        return (1 << (n + 4)) + br.read_bits(n + 4)

    # -- full ICS decode (ics/mod.rs decode) -------------------------------

    def decode(self, br: BitReaderLtr, lcg: Lcg, common_window: bool) -> None:
        self.global_gain = br.read_bits(8)
        if not common_window:
            self.info.decode(br)
            if self.info.max_sfb + 1 > len(self.get_bands()):
                raise DecodeError("max_sfb too large")
        self.decode_section_data(br)
        self.decode_scale_factors(br)
        self.decode_pulse(br)
        self.decode_tns(br)
        if br.read_bits(1):
            raise Unsupported("gain control data")
        self.decode_spectrum(br, lcg)

    def synth_channel(self, dsp: "Dsp", rate_idx: int, out: np.ndarray) -> None:
        self.synth_pulse()
        self.synth_tns(rate_idx)
        dsp.synth(self.coeffs, self.delay, self.info.window_sequence,
                  self.info.window_shape, self.info.prev_window_shape, out)


# ---------------------------------------------------------------------------
# Filterbank (dsp.rs)
# ---------------------------------------------------------------------------

_P0 = 512 - 64
_P1 = 512 + 64


class Dsp:
    def __init__(self):
        self.kbd_long = kbd_window(1024, 4.0)
        self.kbd_short = kbd_window(128, 6.0)
        self.sine_long = sine_window(1024)
        self.sine_short = sine_window(128)

    def synth(self, coeffs, delay, seq, shape, prev_shape, dst) -> None:
        long_win = self.kbd_long if shape else self.sine_long
        short_win = self.kbd_short if shape else self.sine_short
        prev_long = self.kbd_long if prev_shape else self.sine_long
        prev_short = self.kbd_short if prev_shape else self.sine_short

        if seq != EIGHT_SHORT:
            if have_fast_imdct():
                pcm = imdct_dct4(coeffs) * np.float32(1.0 / 2048.0)
            else:
                pcm = imdct_matrix_scaled(1024) @ coeffs  # [2048]
        else:
            if have_fast_imdct():
                pcm = (imdct_dct4(coeffs.reshape(8, 128))
                       * np.float32(1.0 / 256.0)).reshape(2048)
            else:
                pcm = np.zeros(2048, np.float32)
                M = imdct_matrix_scaled(128)
                for w in range(8):
                    pcm[w * 256 : w * 256 + 256] = (
                        M @ coeffs[w * 128 : (w + 1) * 128])
            short = np.zeros(1152, np.float32)
            for w in range(8):
                src = pcm[w * 256 : (w + 1) * 256]
                left_w = prev_short if w == 0 else short_win
                if w == 0:
                    short[:128] = src[:128] * left_w
                    short[128:256] = src[128:256] * short_win[::-1]
                else:
                    short[w * 128 : w * 128 + 128] += src[:128] * short_win
                    short[w * 128 + 128 : w * 128 + 256] += src[128:] * short_win[::-1]
            pcm_short = short

        if seq in (ONLY_LONG, LONG_START):
            dst[:] = delay + pcm[:1024] * prev_long
        elif seq == EIGHT_SHORT:
            dst[:_P0] = delay[:_P0]
            dst[_P0:] = delay[_P0:] + pcm_short[:1024 - _P0]
        else:  # LONG_STOP
            dst[:_P0] = delay[:_P0]
            dst[_P0:_P1] = delay[_P0:_P1] + pcm[_P0:_P1] * prev_short[: _P1 - _P0]
            dst[_P1:] = delay[_P1:] + pcm[_P1:1024]

        if seq in (ONLY_LONG, LONG_STOP):
            delay[:] = pcm[1024:] * long_win[::-1]
        elif seq == EIGHT_SHORT:
            delay[:_P1] = pcm_short[_P1 : 2 * _P1]
            delay[_P1:] = 0
        else:  # LONG_START
            delay[:_P0] = pcm[1024 : 1024 + _P0]
            delay[_P0:_P1] = pcm[1024 + _P0 : 1024 + _P1] * short_win[::-1][: _P1 - _P0]
            delay[_P1:] = 0

    def synth_batch(self, coeffs, delay, seq, shape, prev_shape, dst) -> None:
        """Vectorized multi-channel twin of ``synth`` for channels sharing
        (seq, shape, prev_shape): coeffs/delay/dst are [C, 1024] and every
        op runs once for the group (one DCT-IV call instead of C).
        Same math, last-axis slicing."""
        if not have_fast_imdct():
            for c in range(coeffs.shape[0]):
                self.synth(coeffs[c], delay[c], seq, shape, prev_shape, dst[c])
            return
        long_win = self.kbd_long if shape else self.sine_long
        short_win = self.kbd_short if shape else self.sine_short
        prev_long = self.kbd_long if prev_shape else self.sine_long
        prev_short = self.kbd_short if prev_shape else self.sine_short
        C = coeffs.shape[0]

        if seq != EIGHT_SHORT:
            pcm = imdct_dct4(coeffs) * np.float32(1.0 / 2048.0)  # [C, 2048]
        else:
            pcm = (imdct_dct4(coeffs.reshape(C, 8, 128))
                   * np.float32(1.0 / 256.0))  # [C, 8, 256]
            short = np.zeros((C, 1152), np.float32)
            for w in range(8):
                src = pcm[:, w]
                if w == 0:
                    short[:, :128] = src[:, :128] * prev_short
                    short[:, 128:256] = src[:, 128:] * short_win[::-1]
                else:
                    short[:, w * 128 : w * 128 + 128] += src[:, :128] * short_win
                    short[:, w * 128 + 128 : w * 128 + 256] += (
                        src[:, 128:] * short_win[::-1])
            pcm_short = short

        if seq in (ONLY_LONG, LONG_START):
            dst[:] = delay + pcm[:, :1024] * prev_long
        elif seq == EIGHT_SHORT:
            dst[:, :_P0] = delay[:, :_P0]
            dst[:, _P0:] = delay[:, _P0:] + pcm_short[:, : 1024 - _P0]
        else:  # LONG_STOP
            dst[:, :_P0] = delay[:, :_P0]
            dst[:, _P0:_P1] = (delay[:, _P0:_P1]
                               + pcm[:, _P0:_P1] * prev_short[: _P1 - _P0])
            dst[:, _P1:] = delay[:, _P1:] + pcm[:, _P1:1024]

        if seq in (ONLY_LONG, LONG_STOP):
            delay[:] = pcm[:, 1024:] * long_win[::-1]
        elif seq == EIGHT_SHORT:
            delay[:, :_P1] = pcm_short[:, _P1 : 2 * _P1]
            delay[:, _P1:] = 0
        else:  # LONG_START
            delay[:, :_P0] = pcm[:, 1024 : 1024 + _P0]
            delay[:, _P0:_P1] = (pcm[:, 1024 + _P0 : 1024 + _P1]
                                 * short_win[::-1][: _P1 - _P0])
            delay[:, _P1:] = 0


# ---------------------------------------------------------------------------
# Channel elements + decoder
# ---------------------------------------------------------------------------


class ChannelPair:
    def __init__(self, is_pair: bool, channel: int, bands_long, bands_short):
        self.is_pair = is_pair
        self.channel = channel
        self.ics0 = Ics(bands_long, bands_short)
        self.ics1 = Ics(bands_long, bands_short)
        self.lcg = Lcg()
        self.ms_used = np.zeros((MAX_WINDOWS, MAX_SFBS), bool)

    def reset(self):
        self.ics0.reset()
        self.ics1.reset()

    def decode_sce(self, br: BitReaderLtr) -> None:
        self.ics0.decode(br, self.lcg, False)

    def decode_cpe(self, br: BitReaderLtr) -> None:
        common_window = bool(br.read_bits(1))
        ms_mask = 0
        if common_window:
            self.ics0.info.decode(br)
            if self.ics0.info.max_sfb + 1 > len(self.ics0.get_bands()):
                raise DecodeError("max_sfb too large")
            ms_mask = br.read_bits(2)
            info = self.ics0.info
            if ms_mask in (0, 2):
                self.ms_used[:] = ms_mask == 2
            elif ms_mask == 1:
                self.ms_used[:] = False
                for g in range(info.window_groups):
                    for sfb in range(info.max_sfb):
                        self.ms_used[g, sfb] = bool(br.read_bits(1))
            else:
                raise DecodeError("invalid ms mask")
            self.ics1.info.copy_from_common(self.ics0.info)
        self.ics0.decode(br, self.lcg, common_window)
        self.ics1.decode(br, self.lcg, common_window)

        if common_window:
            info = self.ics0.info
            bands = self.ics0.get_bands()
            g = 0
            for w in range(info.num_windows):
                if w > 0 and not info.scale_factor_grouping[w - 1]:
                    g += 1
                for sfb in range(info.max_sfb):
                    start = w * 128 + bands[sfb]
                    end = w * 128 + bands[sfb + 1]
                    cb1 = self.ics1.sfb_cb[g, sfb]
                    if cb1 in (INTENSITY_HCB, INTENSITY_HCB2):
                        invert = ms_mask == 1 and self.ms_used[g, sfb]
                        direction = 1.0 if cb1 == INTENSITY_HCB else -1.0
                        factor = -1.0 if invert else 1.0
                        scale = direction * factor * self.ics1.scales[g, sfb]
                        self.ics1.coeffs[start:end] = scale * self.ics0.coeffs[start:end]
                    elif (self.ics0.sfb_cb[g, sfb] == NOISE_HCB
                          or cb1 == NOISE_HCB):
                        pass
                    elif self.ms_used[g, sfb]:
                        mid = self.ics0.coeffs[start:end].copy()
                        side = self.ics1.coeffs[start:end].copy()
                        self.ics0.coeffs[start:end] = mid + side
                        self.ics1.coeffs[start:end] = mid - side


class AacDecoder(AudioDecoder):
    """AAC-LC audio decoder (codec-aac aac/mod.rs:42).

    ``params.extra_data`` carries the AudioSpecificConfig (from MP4 esds or
    synthesized by the ADTS reader).
    """

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if not params.extra_data:
            raise DecodeError("AAC requires AudioSpecificConfig extra data")
        self.asc = AudioSpecificConfig.read(params.extra_data)
        if self.asc.object_type != AOT_AAC_LC:
            raise Unsupported("only AAC-LC is supported")
        self.rate_idx, self.bands_long, self.bands_short = subband_info(
            self.asc.sample_rate
        )
        self.spec = AudioSpec(
            self.asc.sample_rate,
            self.asc.channels or Channels.from_count(self.asc.n_channels),
        )
        self.dsp = Dsp()
        self.pairs: List[ChannelPair] = []
        # Per-packet native fast-path state: the canonical per-channel OLA
        # delay lives here (shared with the Python path via ics.delay view
        # rebinding), the window-shape chain lives in the native context.
        self._native = None  # lazy AacStream (False = unavailable/disabled)
        self._delay = np.zeros((self.spec.num_channels, 1024), np.float32)
        # Warm the native engine at construction: the module import,
        # dlopen, and table setup land here instead of inside the first
        # (timed) decode call.
        try:
            from .. import native as _native
            _native.available()
        except Exception:
            pass
        self._last_shape = np.zeros(self.spec.num_channels, np.int32)
        self._seed_shapes = None  # set when switching native -> Python

    @staticmethod
    def supported_codecs() -> List[str]:
        return [CODEC_ID_AAC]

    def reset(self) -> None:
        for p in self.pairs:
            p.reset()
        if self._native:
            self._native.reset()
        self._delay[:] = 0
        self._last_shape[:] = 0
        self._seed_shapes = None

    def _set_pair(self, pair_no: int, channel: int, is_pair: bool) -> ChannelPair:
        if len(self.pairs) <= pair_no:
            self.pairs.append(
                ChannelPair(is_pair, channel, self.bands_long, self.bands_short)
            )
        p = self.pairs[pair_no]
        if p.channel != channel or p.is_pair != is_pair:
            raise DecodeError("channel element layout changed")
        need = channel + (2 if is_pair else 1)
        if need > self.spec.num_channels:
            raise DecodeError("too many channel elements")
        return p

    def decode_coeffs(self, data: bytes):
        """Entropy + prep stage: raw_data_block -> per-channel
        (coeffs [1024] f32 after pulse/TNS, window_sequence, window_shape,
        prev_window_shape) — the device-batchable IMDCT boundary."""
        cur_pair = self._parse_elements(BitReaderLtr(data))
        out = []
        for p in self.pairs[:cur_pair]:
            for ics in ([p.ics0, p.ics1] if p.is_pair else [p.ics0]):
                ics.synth_pulse()
                ics.synth_tns(self.rate_idx)
                out.append((ics.coeffs.copy(), ics.info.window_sequence,
                            ics.info.window_shape, ics.info.prev_window_shape))
        return out

    def _parse_elements(self, br: BitReaderLtr) -> int:
        cur_pair = 0
        cur_ch = 0
        while br.bits_left() > 3:
            eid = br.read_bits(3)
            if eid == 7:  # END
                break
            if eid in (0, 3):  # SCE / LFE
                br.read_bits(4)
                p = self._set_pair(cur_pair, cur_ch, False)
                p.decode_sce(br)
                cur_pair += 1
                cur_ch += 1
            elif eid == 1:  # CPE
                br.read_bits(4)
                p = self._set_pair(cur_pair, cur_ch, True)
                p.decode_cpe(br)
                cur_pair += 1
                cur_ch += 2
            elif eid == 4:  # DSE
                br.read_bits(4)
                align = br.read_bits(1)
                count = br.read_bits(8)
                if count == 255:
                    count += br.read_bits(8)
                if align:
                    br.realign()
                br.ignore_bits(count * 8)
            elif eid == 6:  # FIL
                count = br.read_bits(4)
                if count == 15:
                    count += br.read_bits(8) - 1
                if count > 0:
                    br.read_bits(4)  # extension type (SBR payloads skipped)
                    br.ignore_bits(4)
                    br.ignore_bits((count - 1) * 8)
            elif eid in (2, 5):  # CCE / PCE
                raise Unsupported("AAC CCE/PCE element")
        return cur_pair

    def _decode_native(self, data: bytes):
        """Native per-packet fast path (sh_aac_stream_decode: persistent
        ChannelPair state in C++, PNS-LCG chained like the reference).
        Returns the frame PCM or None; on any native failure the decoder
        permanently falls back to the Python oracle mid-stream (the OLA
        delay is shared, the window-shape chain is seeded once)."""
        if self._native is None:
            import os

            if os.environ.get("SYMPHONIA_TPU_AAC_STREAM") == "off":
                self._native = False
            else:
                self._native = _native_mod.aac_stream_open(
                    self.rate_idx, self.bands_long, self.bands_short,
                    self.spec.num_channels) or False
        if not self._native:
            return None
        n_ch = self.spec.num_channels
        if self._native.has_pcm:
            # Full-C++ path: entropy + dequant + IMDCT + window/OLA in one
            # call (sh_aac_stream_decode_pcm). The OLA delay stays in the
            # Python-owned self._delay (updated in place), so the fallback
            # below remains state-continuous. PCM parity vs the oracle is
            # ~1 ulp of the frame's peak (C++ DCT-IV in double vs
            # pocketfft f32) — see TestAacNativePcmPath.
            got = _native_mod.aac_stream_decode_pcm(
                self._native, bytes(data), self._delay)
            if got is not None:
                pcm, shapes = got
                self._last_shape[:] = shapes
                return pcm
            self._native = False
            self._seed_shapes = self._last_shape.copy()
            return None
        ext = _native_mod.aac_stream_decode(self._native, bytes(data))
        if ext is None or int(ext["nch"][0]) != n_ch:
            # Switch to the Python path for good: seed its window-shape
            # chain from the last native frame (the PNS LCG state cannot
            # transfer; noise-substitution bands may differ after a
            # mid-stream switch, like any decoder restart).
            self._native = False
            self._seed_shapes = self._last_shape.copy()
            return None
        coeffs = _native_mod.aac_dequant_host(ext, self.bands_long)[0]
        out = np.empty((n_ch, 1024), np.float32)
        # Group channels sharing window params -> one vectorized synth
        # (common_window streams hit a single group).
        keys = [(int(ext["seq"][0, ch]), bool(ext["shape"][0, ch]),
                 bool(ext["prev_shape"][0, ch])) for ch in range(n_ch)]
        done = [False] * n_ch
        for ch in range(n_ch):
            if done[ch]:
                continue
            grp = [c for c in range(n_ch) if keys[c] == keys[ch]]
            for c in grp:
                done[c] = True
            seq, shape, prev_shape = keys[ch]
            if grp == list(range(grp[0], grp[0] + len(grp))):
                cs = np.ascontiguousarray(coeffs[grp[0] : grp[0] + len(grp)])
                self.dsp.synth_batch(cs, self._delay[grp[0] : grp[0] + len(grp)],
                                     seq, shape, prev_shape,
                                     out[grp[0] : grp[0] + len(grp)])
            else:
                for c in grp:
                    self.dsp.synth(np.ascontiguousarray(coeffs[c]),
                                   self._delay[c], seq, shape, prev_shape,
                                   out[c])
            for c in grp:
                self._last_shape[c] = int(ext["shape"][0, c])
        return out

    def decode(self, packet) -> AudioBuffer:
        out = self._decode_native(packet.data)
        if out is None:
            cur_pair = self._parse_elements(BitReaderLtr(packet.data))
            out = np.zeros((self.spec.num_channels, 1024), np.float32)
            for p in self.pairs[:cur_pair]:
                for ics, ch in ([(p.ics0, p.channel), (p.ics1, p.channel + 1)]
                                if p.is_pair else [(p.ics0, p.channel)]):
                    # Share the canonical OLA delay; seed the shape chain
                    # once after a native -> Python switch.
                    ics.delay = self._delay[ch]
                    if self._seed_shapes is not None:
                        ics.info.prev_window_shape = bool(self._seed_shapes[ch])
                    ics.synth_channel(self.dsp, self.rate_idx, out[ch])
                    self._last_shape[ch] = int(ics.info.window_shape)
            self._seed_shapes = None
        buf = AudioBuffer.from_array(out, self.spec)
        buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf
