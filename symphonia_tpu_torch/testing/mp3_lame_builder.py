"""MPEG-1 Layer III streams laid out as a CBR LAME encoder lays them out,
for the decode tests and the benchmark's FMA- and Common Voice-shaped
configurations.

A test encoder, not a psychoacoustic one. It takes the integers of every
granule and channel as they were drawn (:class:`Granules`: quantised
spectra in bitstream order, block types, gains, scalefactors, scfsi, the
mid/side flag of each frame) and writes them with the Layer III syntax a
CBR LAME stream uses, at any MPEG-1 rate and bitrate, joint stereo or
mono (:class:`Format`; the default is FMA's 256 kbps joint stereo at
44.1 kHz):

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
  frames, and a LAME ``Info`` frame with the encoder delay and padding;
- the rate's scalefactor bands (ISO/IEC 11172-3 table B.8) for LAME's
  region counts and the short-block order; a mono stream's 17-byte side
  info (5 private bits, one channel's scfsi).

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
SPF = 1152                 # samples a frame
ENC_DELAY = 576            # LAME's encoder delay
DECODER_DELAY = 529        # the decoder delay the Info tag's trim assumes
RESERVOIR = 511            # the largest main_data_begin

LONG, START, SHORT, STOP = 0, 1, 2, 3

# MPEG-1 Layer III bitrates (kbps) by index, and sample rates by index.
BITRATES = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
RATES = (44100, 48000, 32000)
# Scalefactor band edges of each MPEG-1 rate (ISO/IEC 11172-3 table B.8):
# long bands over 576 lines, short bands over a window's 192.
SFB = {
    44100: ((0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
             162, 196, 238, 288, 342, 418, 576),
            (0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192)),
    48000: ((0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
             156, 190, 230, 276, 330, 384, 576),
            (0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192)),
    32000: ((0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156,
             194, 240, 296, 364, 448, 550, 576),
            (0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192)),
}
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


@dataclass(frozen=True)
class Format:
    """What a stream's headers state: an MPEG-1 sample rate, joint stereo
    (2 channels) or mono (1), and a CBR bitrate in kbps."""

    sample_rate: int = SAMPLE_RATE
    channels: int = 2
    bitrate_kbps: int = BITRATE_KBPS

    def __post_init__(self):
        if (self.sample_rate not in RATES or self.channels not in (1, 2)
                or self.bitrate_kbps not in BITRATES[1:]):
            raise ValueError(f"not an MPEG-1 Layer III format: {self}")

    @property
    def side_info(self) -> int:
        """Side info bytes: 32 for two channels, 17 for one."""
        return 32 if self.channels == 2 else 17

    @property
    def sfb_long(self) -> tuple:
        return SFB[self.sample_rate][0]

    @property
    def sfb_short(self) -> tuple:
        return SFB[self.sample_rate][1]


JOINT_STEREO_44K = Format()


@dataclass
class Granules:
    """The integers of a stream of C channels (2 or 1), G = 2 F granules
    of F frames.

    ``scalefac`` holds a long granule's 21 band scalefactors in [:21] and
    a short granule's 36 as ``[3 * sfb + window]``; a second granule's
    band group with ``scfsi`` set repeats the first granule's."""

    quant: np.ndarray              # int [G, C, 576], bitstream order
    block_type: np.ndarray         # [G, C]
    global_gain: np.ndarray        # [G, C]
    scalefac_compress: np.ndarray  # [G, C]
    scalefac_scale: np.ndarray     # [G, C]
    preflag: np.ndarray            # [G, C]
    subblock_gain: np.ndarray      # [G, C, 3]
    scalefac: np.ndarray           # [G, C, 36]
    scfsi: np.ndarray              # [F, C, 4]
    ms: np.ndarray                 # [F] (zero in a mono stream)


def short_order(fmt: Format = JOINT_STEREO_44K) -> np.ndarray:
    """[576]: the (window * 192 + frequency) of each bitstream position of
    a short granule (band by band, each band's three windows in turn)."""
    out = np.zeros(576, np.int64)
    sfb = fmt.sfb_short
    for s in range(13):
        a, b = sfb[s], sfb[s + 1]
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


def region_counts(block_type: int, bv_end: int,
                  fmt: Format = JOINT_STEREO_44K):
    """(region0_count, region1_count, region1 start, region2 start)."""
    if block_type != LONG:
        return 0, 0, 36, 576
    sfb = fmt.sfb_long
    n = 1
    while sfb[n] < bv_end:
        n += 1
    r0, r1 = SUBDV[n]
    return r0, r1, sfb[r0 + 1], sfb[r0 + r1 + 2]


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
                   frame_scfsi: np.ndarray,
                   fmt: Format = JOINT_STEREO_44K) -> dict:
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
    r0, r1, a1, a2 = region_counts(bt, bv_end, fmt)
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


def side_info(main_data_begin: int, scfsi: np.ndarray, fields,
              fmt: Format = JOINT_STEREO_44K) -> bytes:
    """The side info: 32 bytes for stereo, 17 for mono (5 private bits,
    one channel's scfsi); ``fields`` [2][C] from :func:`encode_granule`."""
    C = fmt.channels
    si = BitWriter()
    si.write(main_data_begin, 9)
    si.write(0, 3 if C == 2 else 5)
    for ch in range(C):
        for k in range(4):
            si.write(int(scfsi[ch, k]), 1)
    for gr in range(2):
        for ch in range(C):
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
    assert len(out) == fmt.side_info
    return out


# ---------------------------------------------------------------------------
# Frames, tags and the stream
# ---------------------------------------------------------------------------

def frame_base(fmt: Format = JOINT_STEREO_44K) -> tuple:
    """(bytes of an unpadded frame, the remainder LAME's slot lag
    carries)."""
    return divmod(144 * fmt.bitrate_kbps * 1000, fmt.sample_rate)


def paddings(n: int, fmt: Format = JOINT_STEREO_44K) -> np.ndarray:
    """Padding bit of frames 0..n-1 by LAME's slot lag (frac_SpF): the
    number of padded frames up to frame j is ceil((j + 1) r / rate)."""
    _, r = frame_base(fmt)
    j = np.arange(n + 1, dtype=np.int64)
    c = -((-j * r) // fmt.sample_rate)
    return (c[1:] - c[:-1]).astype(np.int64)


def header(pad: int, ms: bool, fmt: Format = JOINT_STEREO_44K) -> bytes:
    """MPEG-1 Layer III, no CRC, the format's bitrate and rate, joint
    stereo (mode extension: mid/side or neither) or mono, original."""
    mode = (1 << 6) | ((2 if ms else 0) << 4) if fmt.channels == 2 else 3 << 6
    return bytes([0xFF, 0xFB,
                  (BITRATES.index(fmt.bitrate_kbps) << 4)
                  | (RATES.index(fmt.sample_rate) << 2) | (pad << 1),
                  mode | (1 << 2)])


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


def info_frame(pad: int, n_audio: int, n_bytes: int, padding: int,
               fmt: Format = JOINT_STEREO_44K) -> bytes:
    """LAME's CBR ``Info`` frame: side info zero, the frame count, the
    stream's bytes, a linear TOC, the quality, and the LAME tag with the
    encoder delay and padding (its CRCs left zero)."""
    size = frame_base(fmt)[0] + pad
    toc = bytes(i * 256 // 100 for i in range(100))
    lame = (b"LAME3.100" + bytes([0x01, 195]) + b"\x00" * 4 + b"\x00" * 4
            + bytes([0, 255]) + ((ENC_DELAY << 12) | padding).to_bytes(3, "big")
            + b"\x00" * 4 + n_bytes.to_bytes(4, "big") + b"\x00" * 4)
    body = (header(pad, False, fmt) + b"\x00" * fmt.side_info + b"Info"
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
    each frame's main_data_begin and side info fields [2][C]."""

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
                 reservoir: bool = True,
                 fmt: Format = JOINT_STEREO_44K) -> Built:
    """The stream of granules ``g``, which must hold
    ``n_frames(n_samples)`` frames of ``fmt.channels`` channels: an
    ID3v2.4 tag (``tags``; none for ``{}``), the LAME Info frame (unless
    ``info`` is False), the audio frames; with ``reservoir`` False every
    frame's main data starts in its own frame."""
    F = len(g.ms)
    C = fmt.channels
    if F != n_frames(n_samples) or g.quant.shape[:2] != (2 * F, C):
        raise ValueError("the granules do not match the sample count")
    g = replace(g, quant=np.array(g.quant, copy=True))
    pads = paddings(F + 1, fmt)
    base = frame_base(fmt)[0]
    caps = base + pads[1:] - 4 - fmt.side_info
    S = np.concatenate([[0], np.cumsum(caps)])
    stream = bytearray(int(S[-1]))
    sides, silent, mdb, all_fields = [], [], [], []
    end = 0  # the previous frame's main data end, in stream bytes
    for f in range(F):
        p = max(end, int(S[f]) - (RESERVOIR if reservoir else 0))
        for attempt in range(2):
            bw = BitWriter()
            fields = [[None] * C, [None] * C]
            frame = _frame(g, f)
            for gr in range(2):
                for ch in range(C):
                    fields[gr][ch] = encode_granule(bw, frame, gr, ch,
                                                    g.scfsi[f], fmt)
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
        sides.append(side_info(int(S[f]) - p, g.scfsi[f], fields, fmt))
    audio = b"".join(header(int(pads[f + 1]), bool(g.ms[f]), fmt) + sides[f]
                     + bytes(stream[S[f] : S[f + 1]]) for f in range(F))
    n_bytes = base + int(pads[0]) + len(audio)
    tags = default_tags(0) if tags is None else tags
    tag = id3v2_tag(tags) if tags else b""
    head = (info_frame(int(pads[0]), F, n_bytes, enc_padding(n_samples), fmt)
            if info else b"")
    return Built(tag + head + audio, g, np.array(silent, np.int64),
                 np.array(mdb, np.int64), all_fields)


# ---------------------------------------------------------------------------
# Seeded draws
# ---------------------------------------------------------------------------

def envelope(bandwidth_hz: float = 19500.0, scale: float = 1.0,
             sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """[576] Laplacian scale of each long bin: loud low bands (values
    above 15), a falling middle, quiet high bands (the count1 region),
    nothing above ``bandwidth_hz``."""
    k = np.arange(576, dtype=np.float64)
    env = scale * (14.0 * np.exp(-k / 24.0) + 2.2 * np.exp(-k / 150.0) + 0.3)
    env[k >= np.ceil(bandwidth_hz / (sample_rate / 2) * 576)] = 0.0
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
         subblock_share: float = 0.3, gain=(150, 166),
         silence=(0, 0), silence_ones: float = 0.02,
         fmt: Format = JOINT_STEREO_44K) -> Granules:
    """Seeded granules for a stream of ``n_samples`` in ``fmt``: each
    feature can be switched off (``ms_share`` 0, ``transient_every`` 0,
    ``max_value`` 15 for no linbits, the shares 0); a mono stream has no
    mid/side and draws as a stereo one's first channel would.
    ``silence`` = (lead, tail) granules of a speech clip's lead-in and
    tail: long blocks of zero lines but ``silence_ones`` of those inside
    the envelope +-1, scalefactors, preflag and scfsi zero; the block
    types are drawn over the granules between them."""
    F = n_frames(n_samples)
    G = 2 * F
    C = fmt.channels
    lead, tail = silence
    env = envelope(sample_rate=fmt.sample_rate) if env is None else env
    ms = (rng.random(F) < ms_share) & (C == 2)
    bt = np.zeros(G, np.int64)
    bt[lead : G - tail] = block_types(rng, G - lead - tail, transient_every)
    bt = np.repeat(bt[:, None], C, 1)
    loud = np.exp(loudness_sigma * rng.standard_normal(F))
    scale = np.repeat(loud, 2)[:, None, None] * np.ones((G, C, 1))
    if C == 2:
        scale[:, 1] *= np.where(np.repeat(ms, 2), side_scale, 1.0)[:, None]
    long_q = laplace(rng, scale * env[None, None, :])
    order = short_order(fmt)
    env_s = np.tile(env[3 * np.arange(192)] * short_scale, 3)[order]
    short_q = laplace(rng, scale * env_s[None, None, :])
    quant = np.where((bt == SHORT)[..., None], short_q, long_q)
    quant = np.clip(quant, -max_value, max_value)
    both_long = (bt[0::2] == LONG) & (bt[1::2] == LONG)      # [F, C]
    scfsi = (rng.random((F, C, 4)) < scfsi_share) & both_long[..., None]
    # A channel with a group shared by scfsi keeps its first granule's
    # scalefac_compress in the second, which repeats the group.
    sfc = rng.integers(0, 16, (F, 2, C))
    sfc[:, 1] = np.where(scfsi.any(-1), sfc[:, 0], sfc[:, 1])
    sfc = sfc.reshape(G, C)
    slen = np.array(SLEN)[sfc]                                 # [G, C, 2]
    band = np.arange(36)
    long_slen = np.where(band < 11, slen[..., :1], slen[..., 1:])
    short_slen = np.where(band < 18, slen[..., :1], slen[..., 1:])
    bits = np.where((bt == SHORT)[..., None], short_slen, long_slen)
    scalefac = np.floor(rng.random((G, C, 36)) * (1 << bits)).astype(np.int64)
    scalefac[..., 21:] *= (bt == SHORT)[..., None]
    shared = scalefac.reshape(F, 2, C, 36)
    for k, (a, b) in enumerate(SCFSI_BANDS):
        shared[:, 1, :, a:b] = np.where(scfsi[:, :, k, None],
                                        shared[:, 0, :, a:b],
                                        shared[:, 1, :, a:b])
    preflag = (rng.random((G, C)) < preflag_share) & (bt != SHORT)
    sbg = np.where(rng.random((G, C, 3)) < subblock_share,
                   rng.integers(1, 4, (G, C, 3)), 0) * (bt == SHORT)[..., None]
    gg = rng.integers(gain[0], gain[1] + 1, (G, C))
    sfs = rng.integers(0, 2, (G, C))
    scalefac = shared.reshape(G, C, 36)
    if lead or tail:
        quiet = (np.arange(G) < lead) | (np.arange(G) >= G - tail)
        ones = np.where(rng.random((G, C, 576)) < silence_ones,
                        rng.choice([-1, 1], (G, C, 576)), 0) * (env > 0)
        quant = np.where(quiet[:, None, None], ones, quant)
        sfc[quiet] = 0
        scalefac[quiet] = 0
        preflag[quiet] = False
        scfsi[quiet.reshape(F, 2).any(1)] = False
    return Granules(
        quant=quant, block_type=bt, global_gain=gg, scalefac_compress=sfc,
        scalefac_scale=sfs,
        preflag=preflag.astype(np.int64), subblock_gain=sbg,
        scalefac=scalefac, scfsi=scfsi.astype(np.int64),
        ms=ms.astype(np.int64))
