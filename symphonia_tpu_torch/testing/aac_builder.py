"""Minimal AAC-LC encoder for decoder tests.

Emits conformant raw_data_blocks (SCE/CPE) with per-band minimum-bits
codebook selection (ZERO_HCB for silent bands, quad books for |q|<=2, pair
books up to escapes — how real encoders section a spectrum), any window
sequence with sine windows, uniform scalefactors, optional TNS headers.
Wrapped in ADTS by ``build_adts``. Independent of the decoder implementation
(uses only the spec code tables). Pass ``book_select="cb11"`` to force the
old escape-book-everywhere coding (pessimal decode stressor).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_T = dict(np.load(Path(__file__).resolve().parent.parent
                  / "data" / "aac_tables.npz"))


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, val: int, n: int) -> None:
        assert 0 <= val < (1 << n) or n == 0, (val, n)
        for i in range(n - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * ((-len(self.bits)) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


def write_esc_value(bw: BitWriter, v: int) -> None:
    """Escape coding for |q| >= 16 in codebook 11."""
    assert 16 <= v < 8192
    n = v.bit_length() - 1  # v in [2^n, 2^(n+1))
    pre = n - 4
    bw.write((1 << pre) - 1, pre) if pre else None
    bw.write(0, 1)
    bw.write(v - (1 << n), n)


def write_cb11_pair(bw: BitWriter, x: int, y: int) -> None:
    ax, ay = abs(x), abs(y)
    cx, cy = min(ax, 16), min(ay, 16)
    idx = cx * 17 + cy
    bw.write(int(_T["spec_codes_11"][idx]), int(_T["spec_lens_11"][idx]))
    if ax:
        bw.write(1 if x < 0 else 0, 1)
    if ay:
        bw.write(1 if y < 0 else 0, 1)
    if ax >= 16:
        write_esc_value(bw, ax)
    if ay >= 16:
        write_esc_value(bw, ay)


def write_scf_delta(bw: BitWriter, delta: int) -> None:
    idx = delta + 60
    bw.write(int(_T["scf_codes"][idx]), int(_T["scf_lens"][idx]))


# --- Per-band codebook selection (minimum-bits, like a real encoder) -------

ZERO_HCB = 0


def _pick_book(seg: np.ndarray) -> int:
    """Smallest codebook class that can represent the band (14496-3 table
    4.151 ranges); within a class the variant with fewer total bits wins."""
    m = int(np.abs(seg).max()) if len(seg) else 0
    if m == 0:
        return ZERO_HCB
    if m <= 1:
        cands = (1, 2)
    elif m <= 2:
        cands = (3, 4)
    elif m <= 4:
        cands = (5, 6)
    elif m <= 7:
        cands = (7, 8)
    elif m <= 12:
        cands = (9, 10)
    else:
        return 11
    return min(cands, key=lambda cb: _band_bits(cb, seg))


def _codeword(cb: int, vals) -> tuple:
    """(table_index, n_sign_bits_vals) for one quad/pair of a book."""
    if cb in (1, 2):
        q = [int(v) + 1 for v in vals]
        return q[0] * 27 + q[1] * 9 + q[2] * 3 + q[3], ()
    if cb in (3, 4):
        a = [abs(int(v)) for v in vals]
        return a[0] * 27 + a[1] * 9 + a[2] * 3 + a[3], tuple(
            int(v) for v in vals if v)
    if cb in (5, 6):
        return (int(vals[0]) + 4) * 9 + (int(vals[1]) + 4), ()
    dim = {7: 8, 8: 8, 9: 13, 10: 13}[cb]
    a = [abs(int(v)) for v in vals]
    return a[0] * dim + a[1], tuple(int(v) for v in vals if v)


def _band_bits(cb: int, seg: np.ndarray) -> int:
    lens = _T[f"spec_lens_{cb}"]
    step = 4 if cb <= 4 else 2
    total = 0
    for i in range(0, len(seg), step):
        idx, signs = _codeword(cb, seg[i : i + step])
        total += int(lens[idx]) + len(signs)
    return total


def write_band(bw: BitWriter, cb: int, seg: np.ndarray) -> None:
    """Emit one scalefactor band's codewords for the chosen book."""
    if cb == ZERO_HCB:
        return
    if cb == 11:
        for i in range(0, len(seg), 2):
            write_cb11_pair(bw, int(seg[i]), int(seg[i + 1]))
        return
    codes, lens = _T[f"spec_codes_{cb}"], _T[f"spec_lens_{cb}"]
    step = 4 if cb <= 4 else 2
    for i in range(0, len(seg), step):
        idx, signs = _codeword(cb, seg[i : i + step])
        bw.write(int(codes[idx]), int(lens[idx]))
        for s in signs:  # sign bits MSB-first in coefficient order
            bw.write(1 if s < 0 else 0, 1)


def swb_tables(rate: int):
    table = [
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
    for thresh, ln, sn in table:
        if rate >= thresh:
            return _T[ln].tolist(), _T[sn].tolist()


def encode_ics(
    bw: BitWriter,
    quant: np.ndarray,  # [1024] int quantized spectrum (window-interleaved for short)
    seq: int,
    max_sfb: int,
    global_gain: int,
    rate: int,
    common_window: bool = False,
    book_select: str = "auto",
    special_books: Optional[dict] = None,
    pulse: Optional[tuple] = None,
    tns: Optional[list] = None,
    shape: int = 0,
) -> None:
    """Encode one individual_channel_stream.

    ``special_books``: {sfb: cb} forcing NOISE_HCB (13) / INTENSITY (14/15)
    on given bands (long windows; the band's quant values are ignored).

    ``pulse``: (start_sfb, [(offset5, amplitude4), ...]) — pulse_data
    (long windows only, 1-4 pulses).

    ``tns``: per-window list of filter lists; each filter is a dict
    {"length": int, "order": int, "direction": 0/1, "compress": 0/1,
    "coefs": [raw bit values]} plus a per-window "coef_res" key on the
    first filter (default 0). Raw coef values are written with
    (4 if coef_res else 3) - compress bits each, matching
    Ics.decode_tns (codecs/aac.py, ics/tns.rs analog).
    """
    long_bands, short_bands = swb_tables(rate)
    bw.write(global_gain, 8)
    if not common_window:
        encode_ics_info(bw, seq, max_sfb, shape)
    long_win = seq != 2
    bands = long_bands if long_win else short_bands
    n_groups = 1 if long_win else 8  # no grouping: 8 groups of 1 window

    # Per-(group, sfb) codebook selection.
    def band_seg(g, sfb):
        start, end = bands[sfb], bands[sfb + 1]
        w = g if not long_win else 0
        return quant[w * 128 + start : w * 128 + end]

    if book_select == "cb11":
        books = [[11] * max_sfb for _ in range(n_groups)]
    else:
        books = [[_pick_book(band_seg(g, sfb)) for sfb in range(max_sfb)]
                 for g in range(n_groups)]
    if special_books:
        for sfb, cb in special_books.items():
            for g in range(n_groups):
                books[g][sfb] = cb

    # Section data: merge adjacent equal-book sfbs into runs.
    sect_bits = 5 if long_win else 3
    esc = (1 << sect_bits) - 1
    for g in range(n_groups):
        sfb = 0
        while sfb < max_sfb:
            cb = books[g][sfb]
            run = 1
            while sfb + run < max_sfb and books[g][sfb + run] == cb:
                run += 1
            bw.write(cb, 4)
            rem = run
            while rem >= esc:
                bw.write(esc, sect_bits)
                rem -= esc
            bw.write(rem, sect_bits)
            sfb += run
    # Scalefactors (coded bands only): normal bands keep global_gain
    # (delta 0); the first noise band carries the 9-bit PCM delta (0 ->
    # raw 256), later noise and intensity bands use the scf book (delta 0).
    noise_first = True
    for g in range(n_groups):
        for sfb in range(max_sfb):
            cb = books[g][sfb]
            if cb == ZERO_HCB:
                continue
            if cb == 13 and noise_first:  # NOISE_HCB PCM
                bw.write(256, 9)
                noise_first = False
            else:
                write_scf_delta(bw, 0)
    if pulse is not None:
        bw.write(1, 1)
        start_sfb, pulses = pulse
        bw.write(len(pulses) - 1, 2)
        bw.write(start_sfb, 6)
        for off, amp in pulses:
            bw.write(off, 5)
            bw.write(amp, 4)
    else:
        bw.write(0, 1)  # no pulse
    if tns is not None:
        bw.write(1, 1)
        for wf in tns:
            bw.write(len(wf), 2 if long_win else 1)
            if wf:
                coef_res = wf[0].get("coef_res", 0)
                bw.write(coef_res, 1)
            for f in wf:
                bw.write(f["length"], 6 if long_win else 4)
                bw.write(f["order"], 5 if long_win else 3)
                if f["order"]:
                    bw.write(f.get("direction", 0), 1)
                    compress = f.get("compress", 0)
                    bw.write(compress, 1)
                    nbits = (4 if wf[0].get("coef_res", 0) else 3) - compress
                    for c in f["coefs"]:
                        bw.write(c & ((1 << nbits) - 1), nbits)
    else:
        bw.write(0, 1)  # no tns
    bw.write(0, 1)  # no gain control
    # Spectrum: per group, per sfb, per window-in-group (1 window each);
    # noise/intensity bands carry no codewords.
    for g in range(n_groups):
        for sfb in range(max_sfb):
            if books[g][sfb] in (13, 14, 15):
                continue
            write_band(bw, books[g][sfb], band_seg(g, sfb))


def encode_ics_info(bw: BitWriter, seq: int, max_sfb: int,
                    shape: int = 0) -> None:
    bw.write(0, 1)  # reserved
    bw.write(seq, 2)
    bw.write(shape, 1)  # window shape: 0 sine / 1 KBD
    if seq == 2:
        bw.write(max_sfb, 4)
        bw.write(0, 7)  # no grouping: 8 groups
    else:
        bw.write(max_sfb, 6)
        bw.write(0, 1)  # no predictor/ltp


def build_raw_block(
    channel_quants: List[np.ndarray],
    seqs: Sequence[int],
    max_sfb: int,
    global_gain: int,
    rate: int,
    use_cpe: Optional[bool] = None,
    book_select: str = "auto",
    common_window: bool = False,
    ms_mask: int = 0,
    ms_used: Optional[Sequence[int]] = None,
    special_books0: Optional[dict] = None,
    special_books1: Optional[dict] = None,
    pulse0: Optional[tuple] = None,
    tns0: Optional[list] = None,
    pulse1: Optional[tuple] = None,
    tns1: Optional[list] = None,
    shape: int = 0,
) -> bytes:
    bw = BitWriter()
    n_ch = len(channel_quants)
    if use_cpe is None:
        use_cpe = n_ch == 2
    if use_cpe:
        bw.write(1, 3)  # CPE
        bw.write(0, 4)  # tag
        bw.write(1 if common_window else 0, 1)
        if common_window:
            encode_ics_info(bw, seqs[0], max_sfb, shape)
            bw.write(ms_mask, 2)
            if ms_mask == 1:
                for sfb in range(max_sfb):  # one group (long windows)
                    bw.write(1 if (ms_used and sfb in ms_used) else 0, 1)
        encode_ics(bw, channel_quants[0], seqs[0], max_sfb, global_gain, rate,
                   common_window=common_window, book_select=book_select,
                   special_books=special_books0, pulse=pulse0, tns=tns0,
                   shape=shape)
        encode_ics(bw, channel_quants[1], seqs[1], max_sfb, global_gain, rate,
                   common_window=common_window, book_select=book_select,
                   special_books=special_books1, pulse=pulse1, tns=tns1,
                   shape=shape)
    else:
        for q, s in zip(channel_quants, seqs):
            bw.write(0, 3)  # SCE
            bw.write(0, 4)
            encode_ics(bw, q, s, max_sfb, global_gain, rate,
                       book_select=book_select, special_books=special_books0,
                       pulse=pulse0, tns=tns0, shape=shape)
    bw.write(7, 3)  # END
    return bw.to_bytes()


def build_raw_block_elements(
    layout: Sequence[str],
    channel_quants: List[np.ndarray],
    seqs: Sequence[int],
    max_sfb: int,
    global_gain: int,
    rate: int,
) -> bytes:
    """Multi-element raw_data_block for surround layouts: `layout` is a
    sequence of "sce"/"cpe"/"lfe" element kinds consuming channel_quants
    (and seqs) in order — e.g. ("sce", "cpe", "cpe", "lfe") is the 5.1
    channel-configuration-6 element order (aac/mod.rs:126-223)."""
    bw = BitWriter()
    ch = 0
    tags = {"sce": 0, "cpe": 0, "lfe": 0}
    for kind in layout:
        if kind == "cpe":
            bw.write(1, 3)
            bw.write(tags["cpe"], 4)
            bw.write(0, 1)  # not common_window
            encode_ics(bw, channel_quants[ch], seqs[ch], max_sfb,
                       global_gain, rate)
            encode_ics(bw, channel_quants[ch + 1], seqs[ch + 1], max_sfb,
                       global_gain, rate)
            ch += 2
        else:
            bw.write(0 if kind == "sce" else 3, 3)
            bw.write(tags[kind], 4)
            encode_ics(bw, channel_quants[ch], seqs[ch], max_sfb,
                       global_gain, rate)
            ch += 1
        tags[kind] += 1
    assert ch == len(channel_quants)
    bw.write(7, 3)  # END
    return bw.to_bytes()


_SR_IDX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
           24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}


def build_adts(frames: List[bytes], rate: int, n_ch: int) -> bytes:
    out = bytearray()
    for payload in frames:
        flen = len(payload) + 7
        hdr = bytearray(7)
        hdr[0] = 0xFF
        hdr[1] = 0xF1  # MPEG-4, layer 0, no CRC
        hdr[2] = (1 << 6) | (_SR_IDX[rate] << 2) | ((n_ch >> 2) & 1)
        hdr[3] = ((n_ch & 3) << 6) | ((flen >> 11) & 0x3)
        hdr[4] = (flen >> 3) & 0xFF
        hdr[5] = ((flen & 0x7) << 5) | 0x1F
        hdr[6] = 0xFC
        out += hdr + payload
    return bytes(out)


def reference_synthesis(
    quants: List[np.ndarray], seqs: List[int], scale: float, rate: int,
    max_sfb: int,
) -> np.ndarray:
    """Independent float64 reference: dequantize + IMDCT + sine windows +
    the AAC overlap-add chain, for a sequence of mono frames."""
    long_bands, short_bands = swb_tables(rate)

    def imdct(x, n_in):
        n_out = 2 * n_in
        i = np.arange(n_out)[:, None]
        j = np.arange(n_in)[None, :]
        m = np.cos(np.pi / (2 * n_out) * (2 * i + 1 + n_in) * (2 * j + 1)) / n_out
        return m @ x

    def sine(n):
        return np.sin((np.arange(n) + 0.5) * np.pi / (2 * n))

    wl = sine(1024)
    ws = sine(128)
    delay = np.zeros(1024)
    outs = []
    P0, P1 = 448, 576
    for quant, seq in zip(quants, seqs):
        spec = np.sign(quant) * np.abs(quant.astype(np.float64)) ** (4 / 3) * scale
        # Zero out bands beyond max_sfb.
        bands = long_bands if seq != 2 else short_bands
        if seq != 2:
            spec[bands[max_sfb] :] = 0
        else:
            s2 = spec.reshape(8, 128)
            s2[:, bands[max_sfb] :] = 0
            spec = s2.reshape(-1)
        if seq != 2:
            pcm = imdct(spec, 1024)
        else:
            short = np.zeros(1152)
            for w in range(8):
                y = imdct(spec[w * 128 : (w + 1) * 128], 128)
                short[w * 128 : w * 128 + 128] += y[:128] * ws
                short[w * 128 + 128 : w * 128 + 256] += y[128:] * ws[::-1]
            pcm_short = short
        dst = np.zeros(1024)
        if seq in (0, 1):
            dst = delay + pcm[:1024] * wl
        elif seq == 2:
            dst[:P0] = delay[:P0]
            dst[P0:] = delay[P0:] + pcm_short[: 1024 - P0]
        else:
            dst[:P0] = delay[:P0]
            dst[P0:P1] = delay[P0:P1] + pcm[P0:P1] * ws
            dst[P1:] = delay[P1:] + pcm[P1:1024]
        new_delay = np.zeros(1024)
        if seq in (0, 3):
            new_delay = pcm[1024:] * wl[::-1]
        elif seq == 2:
            new_delay[:P1] = pcm_short[P1 : 2 * P1]
        else:
            new_delay[:P0] = pcm[1024 : 1024 + P0]
            new_delay[P0:P1] = pcm[1024 + P0 : 1024 + P1] * ws[::-1]
        delay = new_delay
        outs.append(dst)
    return np.concatenate(outs)


def random_quant_spectrum(rng, max_sfb: int, rate: int, seq: int = 0) -> np.ndarray:
    """Sparse random quantized spectrum incl. escape-range values."""
    long_bands, short_bands = swb_tables(rate)
    def draw(n):
        # Audio-like quantized magnitudes: Laplacian-ish, mostly small with
        # occasional escape-range (|v| >= 16) outliers — real AAC spectra
        # are dominated by small values, unlike a uniform draw.
        v = np.rint(rng.laplace(0.0, 4.0, size=n)).astype(np.int64)
        return np.clip(v, -60, 60)

    q = np.zeros(1024, dtype=np.int64)
    if seq != 2:
        limit = long_bands[max_sfb]
        n = int(min(rng.integers(limit // 3, max(limit // 3 + 1, limit)), limit))
        idx = rng.choice(limit, size=n, replace=False)
        q[idx] = draw(n)
    else:
        limit = short_bands[max_sfb]
        for w in range(8):
            n = int(min(rng.integers(2, max(3, limit)), limit))
            idx = rng.choice(limit, size=n, replace=False)
            q[w * 128 + idx] = draw(n)
    return q
