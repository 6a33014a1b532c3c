"""MPEG-1/2 Layer I and II frame builders for decoder tests.

``build_l1_frame``, ``build_l2_frame`` and ``_rand_l2_frame`` of
``tests/test_layer12.py``, copied: crafted frames with known allocations,
scalefactors and quantized samples.
"""

import numpy as np

from ..codecs.mpa_common import parse_header
from .mp3_builder import BitWriter


def build_l1_frame(raws, allocs, sf_indices, n_ch=1):
    """Layer 1 mono/stereo frame. raws[ch][sb][s], allocs[ch][sb] in bits
    (0 or 2..15), sf_indices[ch][sb]."""
    bw = BitWriter()
    for sb in range(32):
        for ch in range(n_ch):
            bits = allocs[ch][sb]
            bw.write(bits - 1 if bits else 0, 4)
    for sb in range(32):
        for ch in range(n_ch):
            if allocs[ch][sb]:
                bw.write(sf_indices[ch][sb], 6)
    for s in range(12):
        for sb in range(32):
            for ch in range(n_ch):
                bits = allocs[ch][sb]
                if bits:
                    bw.write(raws[ch][sb][s], bits)
    body = bw.pad_to_bytes()
    # Header: MPEG1 layer 1, 448kbps@44100 -> frame size 4*(12*448000/44100)=484
    hdr = bytes([0xFF, 0xFF, (13 << 4) | (0 << 2), 0xC0 if n_ch == 1 else 0x00])
    h = parse_header(int.from_bytes(hdr, "big"))
    assert h.layer == 1
    frame = hdr + body
    assert len(frame) <= h.frame_size, (len(frame), h.frame_size)
    return frame + bytes(h.frame_size - len(frame)), h



def build_l2_frame(alloc_vals, sf0, samples_raw, grouping_cw=None, n_ch=1,
                   mpeg2=False, sb_row=None):
    """Layer 2 frame: MPEG1 384kbps/44100 (sb_info row 1, sblimit 30),
    MPEG2 160kbps/22050 (sb_info row 4, the 13818-3 LSF table), or
    sb_row=0: MPEG1 128kbps (table 3-B.2a, sblimit 27 — the 56-80 kbps
    per-channel class).

    alloc_vals[sb] (mono) or alloc_vals[ch][sb]: allocation index;
    scalefactors all scfsi=2 (one index per subband); samples_raw keyed
    (sb, gr) (mono) or (ch, sb, gr) -> list of 3 raws or a grouped
    codeword.
    """
    from ..codecs.mpa_layer12 import QUANT_CLASS, SB_INFO, SB_QUANT_INFO

    if sb_row is None:
        sb_row = 4 if mpeg2 else 1
    sblimit, rows = SB_INFO[sb_row]
    if n_ch == 1:
        alloc_vals = [alloc_vals]
        sf0 = [sf0]
        samples_raw = {(0, sb, gr): v for (sb, gr), v in samples_raw.items()}
    bw = BitWriter()
    for sb in range(sblimit):
        nbal = SB_QUANT_INFO[rows[sb]][0]
        for ch in range(n_ch):
            bw.write(alloc_vals[ch][sb], nbal)
    for sb in range(sblimit):
        for ch in range(n_ch):
            if alloc_vals[ch][sb]:
                bw.write(2, 2)  # scfsi = 2: one scalefactor for all
    for sb in range(sblimit):
        for ch in range(n_ch):
            if alloc_vals[ch][sb]:
                bw.write(sf0[ch][sb], 6)
    for gr in range(12):
        for sb in range(sblimit):
            for ch in range(n_ch):
                ci = alloc_vals[ch][sb]
                if not ci:
                    continue
                c, d, grouping, bits, nlevels = QUANT_CLASS[
                    SB_QUANT_INFO[rows[sb]][1][ci]]
                if grouping:
                    bw.write(samples_raw[(ch, sb, gr)], bits)
                else:
                    for r in samples_raw[(ch, sb, gr)]:
                        bw.write(r, bits)
    body = bw.pad_to_bytes()
    mode = 0xC0 if n_ch == 1 else 0x00
    if mpeg2:
        hdr = bytes([0xFF, 0xF5, (14 << 4) | 0, mode])
    elif sb_row == 0:
        # 128 kbps (index 8): 64 kbps/ch stereo or 128 kbps mono — both
        # land in _find_sb_info's 48k<per_ch<=80k (stereo) / >80k @44.1k
        # ... so use 64 kbps mono (index 4) for mono callers.
        bidx = 8 if n_ch == 2 else 4
        hdr = bytes([0xFF, 0xFD, (bidx << 4) | 0, mode])
    elif sb_row in (2, 3):
        # <=48 kbps/ch classes (tables 3-B.2c/d): 48 kbps mono (index 2)
        # or 96 kbps stereo (index 6); sb_row 3 is the 32 kHz variant.
        bidx = 6 if n_ch == 2 else 2
        rate_bits = 2 if sb_row == 3 else 0
        hdr = bytes([0xFF, 0xFD, (bidx << 4) | (rate_bits << 2), mode])
    else:
        hdr = bytes([0xFF, 0xFD, (14 << 4) | 0, mode])
    h = parse_header(int.from_bytes(hdr, "big"))
    from ..codecs.mpa_layer12 import _find_sb_info
    assert _find_sb_info(h)[0] == sblimit, "header does not select sb_row"
    assert h.layer == 2 and h.duration == 1152
    assert h.n_channels == n_ch
    frame = hdr + body
    assert len(frame) <= h.frame_size, (len(frame), h.frame_size)
    return frame + bytes(h.frame_size - len(frame)), h


def _rand_l2_frame(seed, n_ch=1, mpeg2=False, sb_row=None):
    from ..codecs.mpa_layer12 import (QUANT_CLASS, SB_INFO,
                                      SB_QUANT_INFO)

    rng = np.random.default_rng(seed)
    if sb_row is None:
        sb_row = 4 if mpeg2 else 1
    sblimit, rows = SB_INFO[sb_row]
    alloc_vals = [[0] * sblimit for _ in range(n_ch)]
    sf0 = [[0] * sblimit for _ in range(n_ch)]
    samples_raw = {}
    # Stereo doubles the payload: restrict coded subbands so the frame
    # fits the fixed frame size. The low-bitrate rows (0: 64 kbps/ch,
    # 2/3: <=48 kbps/ch) carry 2-5x smaller frames — code only a few
    # bands (spread across the full range so high-band nbal fields are
    # exercised) with small quant classes.
    small = sb_row in (0, 2, 3)
    if small:
        coded = set(int(s) for s in
                    rng.choice(sblimit, size=min(4, sblimit), replace=False))
    else:
        coded = set(range(sblimit if n_ch == 1 else 12))
    for sb in range(sblimit):
        nbal, classes = SB_QUANT_INFO[rows[sb]]
        for ch in range(n_ch):
            if sb not in coded or nbal == 0:
                continue
            hi = min(4, 1 << nbal) if small else (1 << nbal)
            alloc_vals[ch][sb] = int(rng.integers(0, hi))
            sf0[ch][sb] = int(rng.integers(0, 60))
            if not alloc_vals[ch][sb]:
                continue
            _, _, grouping, bits, nlevels = QUANT_CLASS[
                classes[alloc_vals[ch][sb]]]
            for gr in range(12):
                if grouping:
                    samples_raw[(ch, sb, gr)] = int(
                        rng.integers(0, nlevels ** 3))
                else:
                    samples_raw[(ch, sb, gr)] = [
                        int(rng.integers(0, nlevels + 1)) for _ in range(3)]
    if n_ch == 1:
        alloc_vals, sf0 = alloc_vals[0], sf0[0]
        samples_raw = {(sb, gr): v
                       for (ch, sb, gr), v in samples_raw.items()}
    return build_l2_frame(alloc_vals, sf0, samples_raw, n_ch=n_ch,
                          mpeg2=mpeg2, sb_row=sb_row)


