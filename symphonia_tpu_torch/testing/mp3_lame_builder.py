"""MPEG-1 Layer III streams laid out as a CBR LAME encoder lays them out,
for the decode tests and the benchmark's FMA-shaped configuration.

A test encoder, not a psychoacoustic one. It takes the integers of every
granule and channel as they were drawn (:class:`Granules`: quantised
spectra in bitstream order, block types, gains, scalefactors, scfsi, the
mid/side flag of each frame) and writes them with the Layer III syntax a
256 kbps joint-stereo LAME stream uses:

- block switching: LONG_START, SHORT and LONG_STOP granules (no mixed
  blocks, which LAME never writes), with subblock gains;
- scalefactors of every ``scalefac_compress``, ``scalefac_scale``,
  ``preflag``, and ``scfsi`` in second granules;
- big values in LAME's three regions (``region0_count`` and
  ``region1_count`` from its ``subdv_table``), each region with the table
  of fewest bits among the 30 (linbits tables 16-31 for values above 15),
  then a count1 region of quads in whichever quad table is cheaper;
- the bit reservoir: each frame's main data starts as early as the
  previous frame's end and ``main_data_begin``'s 511 bytes allow; a frame
  whose main data would not fit by its own end is written silent (its
  spectra zero, its scalefactors kept), and :func:`build_stream` returns
  the granules as written;
- CBR frame padding by LAME's slot lag, a leading ID3v2.4 tag of text
  frames, and a LAME ``Info`` frame with the encoder delay and padding.

Independent of the decoder: it reads only the code tables
(``codecs.mpa_layer3.tables``), as ``mp3_builder`` does.
:func:`draw` makes seeded granules of the kind the benchmark's generator
draws, with each feature of the syntax switchable for the tests.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np

from .mp3_builder import BitWriter

SAMPLE_RATE = 44100
BITRATE_KBPS = 256
BITRATE_IDX = 13           # 256 kbps, MPEG-1 Layer III
SPF = 1152                 # samples a frame
ENC_DELAY = 576            # LAME's encoder delay
DECODER_DELAY = 529        # the decoder delay the Info tag's trim assumes
SIDE_INFO = 32             # stereo side info bytes
RESERVOIR = 511            # the largest main_data_begin

LONG, START, SHORT, STOP = 0, 1, 2, 3

SFB_LONG = (0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
            162, 196, 238, 288, 342, 418, 576)
SFB_SHORT = (0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192)
SLEN = ((0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
        (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3))
# LAME's (region0_count, region1_count) by the number of long bands that
# the big values reach (quantize_pvt.c subdv_table).
SUBDV = ((0, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 1), (1, 1), (1, 1),
         (1, 2), (2, 2), (2, 3), (2, 3), (3, 4), (3, 4), (3, 4), (4, 5),
         (4, 5), (4, 6), (5, 6), (5, 6), (5, 7), (6, 7), (6, 7))
# scfsi's four groups of long bands.
SCFSI_BANDS = ((0, 6), (6, 11), (11, 16), (16, 21))
TABLES = tuple(t for t in range(32) if t not in (4, 14))
GENRES = ("Electronic", "Experimental", "Rock", "Hip-Hop", "Folk",
          "Instrumental", "Pop", "International")


@dataclass
class Granules:
    """The integers of a stereo stream, G = 2 F granules of F frames.

    ``scalefac`` holds a long granule's 21 band scalefactors in [:21] and
    a short granule's 36 as ``[3 * sfb + window]``; a second granule's
    band group with ``scfsi`` set repeats the first granule's."""

    quant: np.ndarray              # int [G, 2, 576], bitstream order
    block_type: np.ndarray         # [G, 2]
    global_gain: np.ndarray        # [G, 2]
    scalefac_compress: np.ndarray  # [G, 2]
    scalefac_scale: np.ndarray     # [G, 2]
    preflag: np.ndarray            # [G, 2]
    subblock_gain: np.ndarray      # [G, 2, 3]
    scalefac: np.ndarray           # [G, 2, 36]
    scfsi: np.ndarray              # [F, 2, 4]
    ms: np.ndarray                 # [F]


def short_order() -> np.ndarray:
    """[576]: the (window * 192 + frequency) of each bitstream position of
    a short granule (band by band, each band's three windows in turn)."""
    out = np.zeros(576, np.int64)
    for s in range(13):
        a, b = SFB_SHORT[s], SFB_SHORT[s + 1]
        for w in range(3):
            for k in range(b - a):
                out[3 * a + w * (b - a) + k] = w * 192 + a + k
    return out


# ---------------------------------------------------------------------------
# Code tables
# ---------------------------------------------------------------------------

_TAB: Dict[str, np.ndarray] = {}


def code_tables() -> Dict[str, np.ndarray]:
    """The pair tables padded to [32, 256] (index 16 |x| + |y| with both
    clamped to 15) as ``codes``/``bits``, ``linbits`` [32], ``limit``
    [32] (the largest value each table codes), and the quad tables
    [2, 16] as ``qcodes``/``qbits``."""
    if _TAB:
        return _TAB
    from ..codecs.mpa_layer3 import tables

    t = tables()
    codes = np.zeros((32, 256), np.int64)
    bits = np.zeros((32, 256), np.int64)
    limit = np.zeros(32, np.int64)
    lin = t["linbits"].astype(np.int64)
    for sel in TABLES[1:]:
        n = 16 if 16 <= sel <= 23 else (24 if sel >= 24 else sel)
        c, b = t[f"codes_{n}"], t[f"bits_{n}"]
        wrap = int(round(np.sqrt(len(c))))
        for x in range(wrap):
            for y in range(wrap):
                codes[sel, 16 * x + y] = int(c[x * wrap + y])
                bits[sel, 16 * x + y] = int(b[x * wrap + y])
        limit[sel] = wrap - 1 + ((1 << int(lin[sel])) - 1 if lin[sel] else 0)
    _TAB.update(
        codes=codes, bits=bits, linbits=lin, limit=limit,
        qcodes=np.stack([t["quads_codes_a"], t["quads_codes_b"]]).astype(
            np.int64),
        qbits=np.stack([t["quads_bits_a"], t["quads_bits_b"]]).astype(
            np.int64))
    return _TAB


# ---------------------------------------------------------------------------
# One granule and channel
# ---------------------------------------------------------------------------

def partition(q: np.ndarray):
    """(big values end, count1 end) of q [576]: the zero pairs at the top
    dropped, then the quads of values within +-1 below them (LAME)."""
    i = 576
    while i > 0 and q[i - 1] == 0 and q[i - 2] == 0:
        i -= 2
    c1 = i
    while i > 3 and np.abs(q[i - 4 : i]).max() <= 1:
        i -= 4
    return i, c1


def region_counts(block_type: int, bv_end: int):
    """(region0_count, region1_count, region1 start, region2 start)."""
    if block_type != LONG:
        return 0, 0, 36, 576
    n = 1
    while SFB_LONG[n] < bv_end:
        n += 1
    r0, r1 = SUBDV[n]
    return r0, r1, SFB_LONG[r0 + 1], SFB_LONG[r0 + r1 + 2]


def pair_bits(sel: int, x: np.ndarray, y: np.ndarray) -> int:
    """Bits of the pairs (x, y) in table ``sel``, signs and linbits in."""
    if sel == 0:
        return 0
    t = code_tables()
    ax, ay = np.abs(x), np.abs(y)
    n = t["bits"][sel][16 * np.minimum(ax, 15) + np.minimum(ay, 15)].sum()
    n += int((ax > 0).sum() + (ay > 0).sum())
    if t["linbits"][sel]:
        n += int(t["linbits"][sel]) * int((ax >= 15).sum() + (ay >= 15).sum())
    return int(n)


def best_table(v: np.ndarray) -> int:
    """The table of fewest bits for the region's values (the lowest
    number among equals); table 0 for a region of zeros."""
    m = int(np.abs(v).max()) if len(v) else 0
    if m == 0:
        return 0
    t = code_tables()
    x, y = v[0::2], v[1::2]
    best, sel_best = None, 0
    for sel in TABLES[1:]:
        if t["limit"][sel] < m:
            continue
        n = pair_bits(sel, x, y)
        if best is None or n < best:
            best, sel_best = n, sel
    return sel_best


def quad_index(v: np.ndarray) -> np.ndarray:
    a = np.abs(v).reshape(-1, 4)
    return 8 * a[:, 0] + 4 * a[:, 1] + 2 * a[:, 2] + a[:, 3]


def best_quad_table(v: np.ndarray) -> int:
    t = code_tables()
    idx = quad_index(v)
    return int(t["qbits"][1][idx].sum() < t["qbits"][0][idx].sum())


def scalefactor_fields(g: Granules, gr: int, ch: int):
    """The part 2 fields (value, length) in stream order."""
    s1, s2 = SLEN[int(g.scalefac_compress[gr, ch])]
    sf = g.scalefac[gr, ch]
    out = []
    if g.block_type[gr, ch] == SHORT:
        for sfb in range(12):
            for w in range(3):
                out.append((int(sf[3 * sfb + w]), s1 if sfb < 6 else s2))
        return out
    for k, (a, b) in enumerate(SCFSI_BANDS):
        if gr == 1 and g.scfsi[0, ch, k]:
            continue
        for sfb in range(a, b):
            out.append((int(sf[sfb]), s1 if k < 2 else s2))
    return out


def encode_granule(bw: BitWriter, g: Granules, gr: int, ch: int,
                   frame_scfsi: np.ndarray) -> dict:
    """Write one granule and channel's main data (``g`` holds one
    frame: gr 0 or 1); return its side info fields."""
    start = len(bw)
    bt = int(g.block_type[gr, ch])
    for v, n in scalefactor_fields(replace(g, scfsi=frame_scfsi[None]),
                                   gr, ch):
        if v >= (1 << n):
            raise ValueError("a scalefactor exceeds its slen")
        bw.write(v, n)
    q = np.asarray(g.quant[gr, ch], np.int64)
    bv_end, c1_end = partition(q)
    r0, r1, a1, a2 = region_counts(bt, bv_end)
    bounds = (0, min(a1, bv_end), min(a2, bv_end), bv_end)
    sels = []
    t = code_tables()
    for r in range(3 if bt == LONG else 2):
        seg = q[bounds[r] : bounds[r + 1]]
        sel = best_table(seg)
        sels.append(sel)
        if sel == 0:
            continue
        lin = int(t["linbits"][sel])
        for x, y in zip(seg[0::2], seg[1::2]):
            ax, ay = abs(int(x)), abs(int(y))
            i = 16 * min(ax, 15) + min(ay, 15)
            bw.write(int(t["codes"][sel][i]), int(t["bits"][sel][i]))
            if lin and ax >= 15:
                bw.write(ax - 15, lin)
            if x:
                bw.write(int(x < 0), 1)
            if lin and ay >= 15:
                bw.write(ay - 15, lin)
            if y:
                bw.write(int(y < 0), 1)
    c1 = q[bv_end:c1_end]
    qt = best_quad_table(c1) if len(c1) else 0
    for quad in c1.reshape(-1, 4):
        i = int(quad_index(quad)[0])
        bw.write(int(t["qcodes"][qt][i]), int(t["qbits"][qt][i]))
        for v in quad:
            if v:
                bw.write(int(v < 0), 1)
    return dict(part2_3=len(bw) - start, big_values=bv_end // 2,
                global_gain=int(g.global_gain[gr, ch]),
                scalefac_compress=int(g.scalefac_compress[gr, ch]),
                block_type=bt, tables=sels, region0=r0, region1=r1,
                subblock_gain=[int(s) for s in g.subblock_gain[gr, ch]],
                preflag=int(g.preflag[gr, ch]),
                scalefac_scale=int(g.scalefac_scale[gr, ch]),
                count1table=qt)


def side_info(main_data_begin: int, scfsi: np.ndarray, fields) -> bytes:
    """32 bytes of stereo side info; ``fields`` [2][2] from
    :func:`encode_granule`."""
    si = BitWriter()
    si.write(main_data_begin, 9)
    si.write(0, 3)
    for ch in range(2):
        for k in range(4):
            si.write(int(scfsi[ch, k]), 1)
    for gr in range(2):
        for ch in range(2):
            f = fields[gr][ch]
            si.write(f["part2_3"], 12)
            si.write(f["big_values"], 9)
            si.write(f["global_gain"], 8)
            si.write(f["scalefac_compress"], 4)
            if f["block_type"] != LONG:
                si.write(1, 1)
                si.write(f["block_type"], 2)
                si.write(0, 1)                      # mixed_block_flag
                for sel in f["tables"]:
                    si.write(sel, 5)
                for s in f["subblock_gain"]:
                    si.write(s, 3)
            else:
                si.write(0, 1)
                for sel in f["tables"]:
                    si.write(sel, 5)
                si.write(f["region0"], 4)
                si.write(f["region1"], 3)
            si.write(f["preflag"], 1)
            si.write(f["scalefac_scale"], 1)
            si.write(f["count1table"], 1)
    out = si.pad_to_bytes()
    assert len(out) == SIDE_INFO
    return out


# ---------------------------------------------------------------------------
# Frames, tags and the stream
# ---------------------------------------------------------------------------

def frame_base() -> tuple:
    """(bytes of an unpadded frame, the remainder LAME's slot lag
    carries)."""
    return divmod(144 * BITRATE_KBPS * 1000, SAMPLE_RATE)


def paddings(n: int) -> np.ndarray:
    """Padding bit of frames 0..n-1 by LAME's slot lag (frac_SpF): the
    number of padded frames up to frame j is ceil((j + 1) r / rate)."""
    _, r = frame_base()
    j = np.arange(n + 1, dtype=np.int64)
    c = -((-j * r) // SAMPLE_RATE)
    return (c[1:] - c[:-1]).astype(np.int64)


def header(pad: int, ms: bool) -> bytes:
    """MPEG-1 Layer III, no CRC, 256 kbps, 44.1 kHz, joint stereo (mode
    extension: mid/side or neither), original."""
    return bytes([0xFF, 0xFB, (BITRATE_IDX << 4) | (pad << 1),
                  (1 << 6) | ((2 if ms else 0) << 4) | (1 << 2)])


def n_frames(n_samples: int) -> int:
    """Audio frames of a stream of ``n_samples``: LAME's delay, the
    samples and one granule of flush, in whole frames."""
    return -(-(ENC_DELAY + n_samples + 576) // SPF)


def enc_padding(n_samples: int) -> int:
    return n_frames(n_samples) * SPF - ENC_DELAY - n_samples


def synchsafe(n: int) -> bytes:
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F,
                  n & 0x7F])


def id3v2_tag(tags: Dict[str, str]) -> bytes:
    """An ID3v2.4 tag of UTF-8 text frames, no padding."""
    body = b""
    for fid, text in tags.items():
        payload = b"\x03" + text.encode("utf-8")
        body += fid.encode("ascii") + synchsafe(len(payload)) + b"\x00\x00"
        body += payload
    return b"ID3\x04\x00\x00" + synchsafe(len(body)) + body


def info_frame(pad: int, n_audio: int, n_bytes: int, padding: int) -> bytes:
    """LAME's CBR ``Info`` frame: side info zero, the frame count, the
    stream's bytes, a linear TOC, the quality, and the LAME tag with the
    encoder delay and padding (its CRCs left zero)."""
    size = frame_base()[0] + pad
    toc = bytes(i * 256 // 100 for i in range(100))
    lame = (b"LAME3.100" + bytes([0x01, 195]) + b"\x00" * 4 + b"\x00" * 4
            + bytes([0, 255]) + ((ENC_DELAY << 12) | padding).to_bytes(3, "big")
            + b"\x00" * 4 + n_bytes.to_bytes(4, "big") + b"\x00" * 4)
    body = (header(pad, False) + b"\x00" * SIDE_INFO + b"Info"
            + (0x0F).to_bytes(4, "big") + n_audio.to_bytes(4, "big")
            + n_bytes.to_bytes(4, "big") + toc + (57).to_bytes(4, "big")
            + lame)
    return body + b"\x00" * (size - len(body))


def default_tags(n: int) -> Dict[str, str]:
    return {"TIT2": f"Track {n:06d}", "TPE1": f"Artist {n % 997:03d}",
            "TALB": f"Album {n % 211:03d}", "TCON": GENRES[n % len(GENRES)]}


@dataclass
class Built:
    """A stream as :func:`build_stream` wrote it: its bytes, its granules
    (the silent frames' spectra zero), the frames written silent, and
    each frame's main_data_begin and side info fields [2][2]."""

    data: bytes
    granules: Granules
    silent: np.ndarray
    main_data_begin: np.ndarray
    fields: list


def _frame(g: Granules, f: int) -> Granules:
    sl = slice(2 * f, 2 * f + 2)
    return replace(g, **{k: getattr(g, k)[sl] for k in (
        "quant", "block_type", "global_gain", "scalefac_compress",
        "scalefac_scale", "preflag", "subblock_gain", "scalefac")})


def build_stream(g: Granules, n_samples: int,
                 tags: Optional[Dict[str, str]] = None, *, info: bool = True,
                 reservoir: bool = True) -> Built:
    """The stream of granules ``g``, which must hold
    ``n_frames(n_samples)`` frames: an ID3v2.4 tag (``tags``; none for
    ``{}``), the LAME Info frame (unless ``info`` is False), the audio
    frames; with ``reservoir`` False every frame's main data starts in
    its own frame."""
    F = len(g.ms)
    if F != n_frames(n_samples) or g.quant.shape[0] != 2 * F:
        raise ValueError("the granules do not match the sample count")
    g = replace(g, quant=np.array(g.quant, copy=True))
    pads = paddings(F + 1)
    base = frame_base()[0]
    caps = base + pads[1:] - 4 - SIDE_INFO
    S = np.concatenate([[0], np.cumsum(caps)])
    stream = bytearray(int(S[-1]))
    sides, silent, mdb, all_fields = [], [], [], []
    end = 0  # the previous frame's main data end, in stream bytes
    for f in range(F):
        p = max(end, int(S[f]) - (RESERVOIR if reservoir else 0))
        for attempt in range(2):
            bw = BitWriter()
            fields = [[None, None], [None, None]]
            frame = _frame(g, f)
            for gr in range(2):
                for ch in range(2):
                    fields[gr][ch] = encode_granule(bw, frame, gr, ch,
                                                    g.scfsi[f])
            data = bw.pad_to_bytes()
            if p + len(data) <= S[f + 1]:
                break
            if attempt:
                raise ValueError("a silent frame does not fit")
            g.quant[2 * f : 2 * f + 2] = 0  # silent: scalefactors kept
            silent.append(f)
        stream[p : p + len(data)] = data
        end = p + len(data)
        mdb.append(int(S[f]) - p)
        all_fields.append(fields)
        sides.append(side_info(int(S[f]) - p, g.scfsi[f], fields))
    audio = b"".join(header(int(pads[f + 1]), bool(g.ms[f])) + sides[f]
                     + bytes(stream[S[f] : S[f + 1]]) for f in range(F))
    n_bytes = base + int(pads[0]) + len(audio)
    tags = default_tags(0) if tags is None else tags
    tag = id3v2_tag(tags) if tags else b""
    head = (info_frame(int(pads[0]), F, n_bytes, enc_padding(n_samples))
            if info else b"")
    return Built(tag + head + audio, g, np.array(silent, np.int64),
                 np.array(mdb, np.int64), all_fields)


# ---------------------------------------------------------------------------
# Seeded draws
# ---------------------------------------------------------------------------

def envelope(bandwidth_hz: float = 19500.0, scale: float = 1.0
             ) -> np.ndarray:
    """[576] Laplacian scale of each long bin: loud low bands (values
    above 15), a falling middle, quiet high bands (the count1 region),
    nothing above ``bandwidth_hz``."""
    k = np.arange(576, dtype=np.float64)
    env = scale * (14.0 * np.exp(-k / 24.0) + 2.2 * np.exp(-k / 150.0) + 0.3)
    env[k >= np.ceil(bandwidth_hz / (SAMPLE_RATE / 2) * 576)] = 0.0
    return env


def laplace(rng, scale: np.ndarray) -> np.ndarray:
    u = rng.random(scale.shape) - 0.5
    return np.rint(-scale * np.sign(u) * np.log1p(-2 * np.abs(u))).astype(
        np.int64)


def block_types(rng, G: int, every: int) -> np.ndarray:
    """LONG granules with a START, SHORT, STOP triple at a seeded place in
    each run of ``every`` granules after the first (none for 0)."""
    bt = np.zeros(G, np.int64)
    if not every:
        return bt
    for a in range(1, G - 2, every):
        room = min(every, G - a) - 3
        if room < 0:
            break
        o = a + int(rng.integers(0, room + 1))
        bt[o : o + 3] = (START, SHORT, STOP)
    return bt


def draw(rng, n_samples: int, *, env: Optional[np.ndarray] = None,
         short_scale: float = 1.0, side_scale: float = 0.5,
         loudness_sigma: float = 0.1, ms_share: float = 0.8,
         transient_every: int = 24, max_value: int = 8206,
         scfsi_share: float = 0.3, preflag_share: float = 0.1,
         subblock_share: float = 0.3, gain=(150, 166)) -> Granules:
    """Seeded granules for a stream of ``n_samples``: each feature can be
    switched off (``ms_share`` 0, ``transient_every`` 0, ``max_value`` 15
    for no linbits, the shares 0)."""
    F = n_frames(n_samples)
    G = 2 * F
    env = envelope() if env is None else env
    ms = rng.random(F) < ms_share
    bt = np.repeat(block_types(rng, G, transient_every)[:, None], 2, 1)
    loud = np.exp(loudness_sigma * rng.standard_normal(F))
    scale = np.repeat(loud, 2)[:, None, None] * np.ones((G, 2, 1))
    scale[:, 1] *= np.where(np.repeat(ms, 2), side_scale, 1.0)[:, None]
    long_q = laplace(rng, scale * env[None, None, :])
    order = short_order()
    env_s = np.tile(env[3 * np.arange(192)] * short_scale, 3)[order]
    short_q = laplace(rng, scale * env_s[None, None, :])
    quant = np.where((bt == SHORT)[..., None], short_q, long_q)
    quant = np.clip(quant, -max_value, max_value)
    both_long = (bt[0::2] == LONG) & (bt[1::2] == LONG)      # [F, 2]
    scfsi = (rng.random((F, 2, 4)) < scfsi_share) & both_long[..., None]
    # A channel with a group shared by scfsi keeps its first granule's
    # scalefac_compress in the second, which repeats the group.
    sfc = rng.integers(0, 16, (F, 2, 2))
    sfc[:, 1] = np.where(scfsi.any(-1), sfc[:, 0], sfc[:, 1])
    sfc = sfc.reshape(G, 2)
    slen = np.array(SLEN)[sfc]                                 # [G, 2, 2]
    band = np.arange(36)
    long_slen = np.where(band < 11, slen[..., :1], slen[..., 1:])
    short_slen = np.where(band < 18, slen[..., :1], slen[..., 1:])
    bits = np.where((bt == SHORT)[..., None], short_slen, long_slen)
    scalefac = np.floor(rng.random((G, 2, 36)) * (1 << bits)).astype(np.int64)
    scalefac[..., 21:] *= (bt == SHORT)[..., None]
    shared = scalefac.reshape(F, 2, 2, 36)
    for k, (a, b) in enumerate(SCFSI_BANDS):
        shared[:, 1, :, a:b] = np.where(scfsi[:, :, k, None],
                                        shared[:, 0, :, a:b],
                                        shared[:, 1, :, a:b])
    preflag = (rng.random((G, 2)) < preflag_share) & (bt != SHORT)
    sbg = np.where(rng.random((G, 2, 3)) < subblock_share,
                   rng.integers(1, 4, (G, 2, 3)), 0) * (bt == SHORT)[..., None]
    gg = rng.integers(gain[0], gain[1] + 1, (G, 2))
    return Granules(
        quant=quant, block_type=bt, global_gain=gg, scalefac_compress=sfc,
        scalefac_scale=rng.integers(0, 2, (G, 2)),
        preflag=preflag.astype(np.int64), subblock_gain=sbg,
        scalefac=shared.reshape(G, 2, 36), scfsi=scfsi.astype(np.int64),
        ms=ms.astype(np.int64))
