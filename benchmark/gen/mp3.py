"""MP3 stream generator: a seeded pool of FMA-shaped clips, MPEG-1 Layer
III at 256 kbps CBR, joint stereo, 44.1 kHz, with a leading ID3v2.4 tag
and a LAME ``Info`` frame.

A vectorised rewrite of the port's LAME-style test encoder
(``symphonia_tpu_torch/testing/mp3_lame_builder.py``: ``build_stream``
and the granule encoder under it), frozen here with the code tables it
reads (``mp3_tables.npz``, the standard's pair and quad tables as that
module pads them). For the same granules it writes the same bytes
(``benchmark/tests/test_bench_mp3.py``). Every granule and channel is
encoded at once on the device: part 2's scalefactor fields, LAME's
big-values regions each with its table of fewest bits, the count1 quads
in the cheaper quad table. Only the bit reservoir's layout runs frame by
frame, on the host, all streams of a chunk together: a frame's main
data starts as early as the previous frame's end and 511 bytes allow,
and a frame whose data would not fit by its own end is written silent.

The draws (``make_pool``): per frame a mid/side flag and a loudness; per
granule a block type (a LONG_START, SHORT, LONG_STOP triple at a seeded
place in each run of ``transient_every`` granules); per granule and
channel Laplacian spectra at the configuration's per-band scales, gains,
scalefactors within ``scalefac_compress``, scfsi in second granules.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .bits import BitBuffer

_T = dict(np.load(Path(__file__).resolve().parent / "mp3_tables.npz"))

SAMPLE_RATE = 44100
BITRATE_IDX = 13
SPF = 1152
ENC_DELAY = 576
SIDE_INFO = 32
RESERVOIR = 511
LONG, START, SHORT, STOP = 0, 1, 2, 3

SFB_LONG = (0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
            162, 196, 238, 288, 342, 418, 576)
SFB_SHORT = (0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192)
SLEN = ((0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
        (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3))
SUBDV = ((0, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 1), (1, 1), (1, 1),
         (1, 2), (2, 2), (2, 3), (2, 3), (3, 4), (3, 4), (3, 4), (4, 5),
         (4, 5), (4, 6), (5, 6), (5, 6), (5, 7), (6, 7), (6, 7))
SCFSI_BANDS = ((0, 6), (6, 11), (11, 16), (16, 21))
BASE_TABLES = (1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 24)
GENRES = ("Electronic", "Experimental", "Rock", "Hip-Hop", "Folk",
          "Instrumental", "Pop", "International")
FIELDS = ("quant", "block_type", "global_gain", "scalefac_compress",
          "scalefac_scale", "preflag", "subblock_gain", "scalefac", "scfsi",
          "ms")


@dataclass
class Stream:
    data: bytes
    granules: dict       # FIELDS -> numpy, as written (silent frames zero)
    n_samples: int       # samples a channel after the gapless trim
    enc_padding: int     # the LAME tag's padding
    silent: int          # frames written silent
    tags: dict           # the ID3v2 text frames
    sample_rate: int
    seconds: float


def short_order() -> np.ndarray:
    """[576]: the (window * 192 + line) of each bitstream position of a
    short granule."""
    out = np.zeros(576, np.int64)
    for s in range(13):
        a, b = SFB_SHORT[s], SFB_SHORT[s + 1]
        for w in range(3):
            out[3 * a + w * (b - a) + np.arange(b - a)] = w * 192 + a + \
                np.arange(b - a)
    return out


# ---------------------------------------------------------------------------
# Frames and tags (the test encoder's, frozen)
# ---------------------------------------------------------------------------

def frame_base() -> tuple:
    return divmod(144 * 256 * 1000, SAMPLE_RATE)


def paddings(n: int) -> np.ndarray:
    _, r = frame_base()
    j = np.arange(n + 1, dtype=np.int64)
    c = -((-j * r) // SAMPLE_RATE)
    return (c[1:] - c[:-1]).astype(np.int64)


def n_frames(n_samples: int) -> int:
    return -(-(ENC_DELAY + n_samples + 576) // SPF)


def enc_padding(n_samples: int) -> int:
    return n_frames(n_samples) * SPF - ENC_DELAY - n_samples


def header(pad: int, ms: bool) -> bytes:
    return bytes([0xFF, 0xFB, (BITRATE_IDX << 4) | (pad << 1),
                  (1 << 6) | ((2 if ms else 0) << 4) | (1 << 2)])


def synchsafe(n: int) -> bytes:
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F,
                  n & 0x7F])


def id3v2_tag(tags: dict) -> bytes:
    body = b""
    for fid, text in tags.items():
        payload = b"\x03" + text.encode("utf-8")
        body += fid.encode("ascii") + synchsafe(len(payload)) + b"\x00\x00"
        body += payload
    return b"ID3\x04\x00\x00" + synchsafe(len(body)) + body


def info_frame(pad: int, n_audio: int, n_bytes: int, padding: int) -> bytes:
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


def default_tags(n: int) -> dict:
    return {"TIT2": f"Track {n:06d}", "TPE1": f"Artist {n % 997:03d}",
            "TALB": f"Album {n % 211:03d}", "TCON": GENRES[n % len(GENRES)]}


# ---------------------------------------------------------------------------
# The granule encoder, every granule and channel at once
# ---------------------------------------------------------------------------

class _Tables:
    def __init__(self, device):
        t = {k: torch.from_numpy(v.astype(np.int64)).to(device)
             for k, v in _T.items()}
        self.codes, self.bits = t["codes"], t["bits"]
        self.linbits, self.limit = t["linbits"], t["limit"]
        self.qcodes, self.qbits = t["qcodes"], t["qbits"]
        self.device = device
        self.sfb_long = torch.tensor(SFB_LONG, device=device)
        self.subdv = torch.tensor(SUBDV, device=device)


def _part2(g: dict, gr: torch.Tensor, dev):
    """Scalefactor fields (value, length) [N, 36] in stream order."""
    slen = torch.tensor(SLEN, device=dev)[g["scalefac_compress"]]  # [N, 2]
    band = torch.arange(36, device=dev)
    short = g["block_type"] == SHORT
    n_long = torch.where(band < 11, slen[:, :1], slen[:, 1:])
    n_long = torch.where(band < 21, n_long, 0)
    group = torch.bucketize(band, torch.tensor([6, 11, 16], device=dev),
                            right=True).clamp(max=3)
    skip = (gr[:, None] == 1) & torch.gather(g["scfsi"], 1,
                                             group[None, :].expand(
                                                 len(gr), 36)).bool()
    n_long = torch.where(skip, 0, n_long)
    n_short = torch.where(band < 18, slen[:, :1], slen[:, 1:])
    n = torch.where(short[:, None], n_short, n_long)
    return g["scalefac"], n


def encode_rows(tb: _Tables, g: dict, gr: torch.Tensor):
    """Fields of N granule-channel rows (``g``: FIELDS of each row, scfsi
    [N, 4] its frame's; ``gr`` [N] 0 or 1). Returns a dict of the part 2,
    pair and quad fields (value, length) in stream order and the side
    info values of each row."""
    dev = tb.device
    q = g["quant"].long()                                    # [N, 576]
    N = q.shape[0]
    bt = g["block_type"]
    a = q.abs()
    # The partition: zero pairs dropped, then quads within +-1.
    pair_nz = (q.view(N, 288, 2) != 0).any(-1)
    pos = torch.arange(1, 289, device=dev)
    i_zero = 2 * torch.where(pair_nz, pos, 0).amax(1)
    big = a > 1
    lb = torch.where(big, torch.arange(576, device=dev), -1).amax(1)
    bv_end = i_zero - 4 * torch.div(i_zero - (lb + 1), 4,
                                    rounding_mode="floor")
    # Regions: LAME's counts for long granules, 36 / 576 otherwise.
    n = torch.searchsorted(tb.sfb_long, bv_end.contiguous()).clamp(min=1)
    r0, r1 = tb.subdv[n, 0], tb.subdv[n, 1]
    long_ = bt == LONG
    a1 = torch.where(long_, tb.sfb_long[r0 + 1], 36)
    a2 = torch.where(long_, tb.sfb_long[(r0 + r1 + 2).clamp(max=22)], 576)
    e0, e1 = torch.minimum(a1, bv_end), torch.minimum(a2, bv_end)
    p2 = 2 * torch.arange(288, device=dev)[None, :]
    region = torch.where(p2 < e0[:, None], 0, torch.where(
        p2 < e1[:, None], 1, torch.where(p2 < bv_end[:, None], 2, -1)))
    live = region >= 0
    key = torch.arange(N, device=dev)[:, None] * 3 + region.clamp(min=0)
    x, y = q[:, 0::2], q[:, 1::2]
    ax, ay = a[:, 0::2], a[:, 1::2]
    idx = 16 * ax.clamp(max=15) + ay.clamp(max=15)
    signs = (ax > 0).long() + (ay > 0).long()
    esc = (ax >= 15).long() + (ay >= 15).long()

    def region_sum(v):
        out = torch.zeros(N * 3, dtype=torch.int64, device=dev)
        out.index_add_(0, key[live], v[live])
        return out

    mx = torch.zeros(N * 3, dtype=torch.int64, device=dev)
    mx.scatter_reduce_(0, key[live], torch.maximum(ax, ay)[live], "amax")
    n_esc = region_sum(esc)
    base = {t: region_sum(tb.bits[t][idx] + signs) for t in BASE_TABLES}
    inf = torch.full_like(mx, 1 << 40)
    cost = []
    for t in range(32):
        if t == 0:
            c = torch.where(mx == 0, 0, inf)
        elif t in (4, 14):
            c = inf
        else:
            c = base[16 if 16 <= t <= 23 else (24 if t >= 24 else t)]
            c = c + n_esc * tb.linbits[t]
            c = torch.where(tb.limit[t] >= mx, c, inf)
        cost.append(c)
    sel = torch.stack(cost, 1).argmin(1).view(N, 3)
    sel = torch.where(long_[:, None] | (torch.arange(3, device=dev) < 2),
                      sel, 0)
    # Pair fields.
    ps = torch.gather(sel, 1, region.clamp(min=0))
    ps = torch.where(live, ps, 0)
    lin = tb.linbits[ps]
    val, ln = tb.codes[ps, idx], tb.bits[ps, idx]
    for v, av in ((x, ax), (y, ay)):
        e = (lin > 0) & (av >= 15)
        val = torch.where(e, (val << lin) | (av - 15), val)
        ln = ln + torch.where(e, lin, 0)
        s = av > 0
        val = torch.where(s, (val << 1) | (v < 0).long(), val)
        ln = ln + s.long()
    ln = torch.where(ps > 0, ln, 0)
    val = torch.where(ps > 0, val, 0)
    # count1 quads from the big values' end.
    c1_end = i_zero
    nq = torch.div(c1_end - bv_end, 4, rounding_mode="floor")
    k = torch.arange(144, device=dev)[None, :]
    qpos = bv_end[:, None] + 4 * k                           # [N, 144]
    qlive = k < nq[:, None]
    gidx = (qpos[..., None] + torch.arange(4, device=dev)).clamp(max=575)
    qv = torch.gather(q, 1, gidx.view(N, -1)).view(N, 144, 4)
    qv = torch.where(qlive[..., None], qv, 0)
    qa = qv.abs()
    qi = 8 * qa[..., 0] + 4 * qa[..., 1] + 2 * qa[..., 2] + qa[..., 3]
    qsign = qa.sum(-1)
    cost_a = torch.where(qlive, tb.qbits[0][qi] + qsign, 0).sum(1)
    cost_b = torch.where(qlive, tb.qbits[1][qi] + qsign, 0).sum(1)
    qt = (cost_b < cost_a).long()
    qval = tb.qcodes[qt[:, None], qi]
    qln = tb.qbits[qt[:, None], qi]
    for j in range(4):
        s = qa[..., j] > 0
        qval = torch.where(s, (qval << 1) | (qv[..., j] < 0).long(), qval)
        qln = qln + s.long()
    qln = torch.where(qlive, qln, 0)
    qval = torch.where(qlive, qval, 0)
    sfv, sfn = _part2(g, gr, dev)
    return {"part2": (sfv.long(), sfn), "pairs": (val, ln),
            "quads": (qval, qln), "big_values": bv_end // 2, "tables": sel,
            "region0": torch.where(long_, r0, 0),
            "region1": torch.where(long_, r1, 0), "count1table": qt}


def silence_rows(enc: dict, silent: torch.Tensor, long_: torch.Tensor):
    """The fields of rows ``silent`` as the encoder writes zero spectra:
    no pairs or quads, tables 0, LAME's counts for no big values."""
    s = silent[:, None]
    enc["pairs"] = tuple(torch.where(s, 0, t) for t in enc["pairs"])
    enc["quads"] = tuple(torch.where(s, 0, t) for t in enc["quads"])
    enc["big_values"] = torch.where(silent, 0, enc["big_values"])
    enc["tables"] = torch.where(s, 0, enc["tables"])
    r0, r1 = SUBDV[1]
    enc["region0"] = torch.where(silent & long_, r0, enc["region0"])
    enc["region1"] = torch.where(silent & long_, r1, enc["region1"])
    enc["count1table"] = torch.where(silent, 0, enc["count1table"])


def _row_bits(enc: dict):
    p2 = enc["part2"][1].sum(1)
    return p2, p2 + enc["pairs"][1].sum(1) + enc["quads"][1].sum(1)


def layout(p23: np.ndarray, p2: np.ndarray, caps: np.ndarray):
    """The bit reservoir, frame by frame, all streams at once: p23 and p2
    [S, F, 4] (bits of each granule-channel, and of its part 2), caps [F]
    each frame's main data bytes. Returns (the start of each frame's main
    data in its stream's main data bytes [S, F], silent [S, F])."""
    S, F = p23.shape[:2]
    need = -(-p23.sum(2) // 8)
    quiet = -(-p2.sum(2) // 8)
    ends = np.cumsum(caps)
    start = np.zeros((S, F), np.int64)
    silent = np.zeros((S, F), bool)
    end = np.zeros(S, np.int64)
    for f in range(F):
        p = np.maximum(end, ends[f] - caps[f] - RESERVOIR)
        over = p + need[:, f] > ends[f]
        silent[:, f] = over
        start[:, f] = p
        end = p + np.where(over, quiet[:, f], need[:, f])
    return start, silent


def side_info_fields(enc: dict, g: dict):
    """(value, length) [frames, 14]: the side info of the rows' frames
    (rows frame-major, then granule, then channel), main_data_begin left
    zero for the caller."""
    dev = g["quant"].device
    p23 = _row_bits(enc)[1]
    bt = g["block_type"]
    short = bt != LONG
    sel = enc["tables"]
    a = ((p23 << 22) | (enc["big_values"] << 13) | (g["global_gain"] << 5)
         | (g["scalefac_compress"] << 1) | short.long())
    b_long = ((sel[:, 0] << 17) | (sel[:, 1] << 12) | (sel[:, 2] << 7)
              | (enc["region0"] << 3) | enc["region1"])
    sbg = g["subblock_gain"]
    b_short = ((bt << 20) | (sel[:, 0] << 14) | (sel[:, 1] << 9)
               | (sbg[:, 0] << 6) | (sbg[:, 1] << 3) | sbg[:, 2])
    b = torch.where(short, b_short, b_long)
    c = ((g["preflag"] << 2) | (g["scalefac_scale"] << 1)
         | enc["count1table"])
    rows = torch.stack([a, b, c], 1).view(-1, 4 * 3)          # [frames, 12]
    rl = torch.tensor([34, 22, 3] * 4, device=dev).expand(len(rows), 12)
    # scfsi: the first granule's rows hold their channel's four bits.
    scfsi = g["scfsi"].view(-1, 4, 4)[:, :2].reshape(-1, 8)
    scfsi = (scfsi << torch.arange(7, -1, -1, device=dev)).sum(1)
    head = torch.stack([torch.zeros_like(scfsi), scfsi], 1)
    hl = torch.tensor([12, 8], device=dev).expand(len(rows), 2)
    return torch.cat([head, rows], 1), torch.cat([hl, rl], 1)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

def encode_streams(g: dict, n_samples: int, tags: list):
    """Streams of equal length from their granules (FIELDS, each with a
    leading stream axis [S, G, 2, ...]; scfsi [S, F, 2, 4], ms [S, F]) ->
    (their bytes, the granules as written, silent frames [S, F])."""
    dev = g["quant"].device
    S, G = g["quant"].shape[:2]
    F = G // 2
    if F != n_frames(n_samples):
        raise ValueError("the granules do not match the sample count")
    rows = {k: g[k].reshape(S * G * 2, *g[k].shape[3:]) for k in FIELDS[:8]}
    # The scfsi of each row's channel, and each row's granule.
    rows["scfsi"] = g["scfsi"][:, :, None].expand(S, F, 2, 2, 4).reshape(
        -1, 4).long()
    gr = (torch.arange(S * G * 2, device=dev) // 2) % 2
    tb = _Tables(dev)
    enc = encode_rows(tb, rows, gr)
    p2, p23 = _row_bits(enc)
    pads = paddings(F + 1)
    base = frame_base()[0]
    caps = base + pads[1:] - 4 - SIDE_INFO
    start, silent = layout(p23.view(S, F, 4).cpu().numpy(),
                           p2.view(S, F, 4).cpu().numpy(), caps)
    if silent.any():
        srow = torch.from_numpy(np.repeat(silent.reshape(-1), 4)).to(dev)
        silence_rows(enc, srow, rows["block_type"] == LONG)
        q = g["quant"].clone()
        q.view(S, F, 4, 576)[torch.from_numpy(silent).to(dev)] = 0
        g = dict(g, quant=q)
        p2, p23 = _row_bits(enc)
    # Main data: each stream's main data bytes back to back.
    S_f = np.concatenate([[0], np.cumsum(caps)])
    total = int(S_f[-1])
    row0 = (torch.from_numpy(start).to(dev).view(S, F, 1) * 8
            + torch.arange(S, device=dev).view(S, 1, 1) * total * 8
            + (torch.cumsum(p23.view(S, F, 4), 2) - p23.view(S, F, 4)))
    row0 = row0.reshape(-1)
    buf = BitBuffer(S * total * 8, dev)
    at = row0
    for part in ("part2", "pairs", "quads"):
        v, n = enc[part]
        buf.put(at[:, None] + torch.cumsum(n, 1) - n, v, n)
        at = at + n.sum(1)
    main = buf.to_bytes().reshape(S, total)
    # Side info, main_data_begin first.
    sv, sl = side_info_fields(enc, rows)
    mdb = torch.from_numpy((S_f[:-1][None, :] - start).reshape(-1)).to(dev)
    sv[:, 0] = (mdb << 3)
    sl[:, 0] = 12
    sbuf = BitBuffer(S * F * SIDE_INFO * 8, dev)
    f0 = torch.arange(S * F, device=dev)[:, None] * SIDE_INFO * 8
    sbuf.put(f0 + torch.cumsum(sl, 1) - sl, sv, sl)
    side = sbuf.to_bytes().reshape(S, F, SIDE_INFO)
    # Each audio frame: its header, its side info, then its share of the
    # main data bytes.
    ms = g["ms"].cpu().numpy().astype(bool)
    sizes = base + pads[1:]
    f_at = (np.cumsum(sizes) - sizes)[:, None]
    payload = np.ones(int(sizes.sum()), bool)
    payload[f_at + np.arange(4 + SIDE_INFO)] = False
    hdr = np.zeros((F, 4), np.uint8)
    hdr[:, 0], hdr[:, 1] = 0xFF, 0xFB
    hdr[:, 2] = (BITRATE_IDX << 4) | (pads[1:] << 1)
    head = info_frame(int(pads[0]), F, base + int(pads[0]) + len(payload),
                      enc_padding(n_samples))
    out = []
    for s in range(S):
        audio = np.zeros(len(payload), np.uint8)
        hdr[:, 3] = (1 << 6) | np.where(ms[s], 2 << 4, 0) | (1 << 2)
        audio[f_at + np.arange(4)] = hdr
        audio[f_at + 4 + np.arange(SIDE_INFO)] = side[s]
        audio[payload] = main[s]
        out.append(id3v2_tag(tags[s]) + head + audio.tobytes())
    return out, g, silent


# ---------------------------------------------------------------------------
# The draws and the pool
# ---------------------------------------------------------------------------

def block_types(rng, G: int, every: int) -> np.ndarray:
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


def envelopes(cfg: dict, device):
    """The Laplacian scale of each line of a long granule and of each
    bitstream position of a short one [576], from the configuration's
    per-band scales; nothing at or above the bandwidth."""
    sp = cfg["spectrum"]
    band = np.searchsorted(SFB_LONG, np.arange(576), side="right") - 1
    env = np.asarray(sp["laplace_scale"], np.float64)[band]
    env[np.arange(576) >= sp["bandwidth_lines"]] = 0.0
    env_s = np.tile(env[3 * np.arange(192)] * sp["short_scale"], 3)
    env_s = env_s[short_order()]
    return (torch.from_numpy(env).to(device),
            torch.from_numpy(env_s).to(device))


def _laplace(gen, scale: torch.Tensor) -> torch.Tensor:
    u = torch.rand(scale.shape, generator=gen, device=scale.device,
                   dtype=torch.float64) - 0.5
    return torch.round(-scale * torch.sign(u) * torch.log1p(-2 * u.abs()))


def draw(cfg: dict, rng, gen, S: int, device) -> dict:
    """Granules of S streams (FIELDS with a leading stream axis)."""
    F = n_frames(int(round(cfg["seconds"] * SAMPLE_RATE)))
    G = 2 * F
    sp = cfg["spectrum"]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)

    bt = torch.from_numpy(np.stack([block_types(rng, G, cfg["transient_every"])
                                    for _ in range(S)])).to(device)
    bt = bt[..., None].expand(S, G, 2).contiguous()
    ms = rand(S, F) < cfg["ms_share"]
    loud = torch.exp(sp["loudness_sigma"] * torch.randn(
        (S, F), generator=gen, device=device, dtype=torch.float64))
    scale = loud.repeat_interleave(2, 1)[..., None].expand(S, G, 2).clone()
    scale[..., 1] *= torch.where(ms.repeat_interleave(2, 1),
                                 sp["side_scale"], 1.0)
    env, env_s = envelopes(cfg, device)
    short = bt == SHORT
    e = torch.where(short[..., None], env_s, env)
    quant = _laplace(gen, scale[..., None] * e).clamp(
        -sp["clip"], sp["clip"]).to(torch.int16)
    both_long = (bt[:, 0::2] == LONG) & (bt[:, 1::2] == LONG)  # [S, F, 2]
    scfsi = (rand(S, F, 2, 4) < cfg["scfsi_share"]) & both_long[..., None]
    sfc = (rand(S, F, 2, 2) * 16).long()
    sfc[:, :, 1] = torch.where(scfsi.any(-1), sfc[:, :, 0], sfc[:, :, 1])
    sfc = sfc.view(S, G, 2)
    slen = torch.tensor(SLEN, device=device)[sfc]            # [S, G, 2, 2]
    band = torch.arange(36, device=device)
    long_n = torch.where(band < 11, slen[..., :1], slen[..., 1:])
    short_n = torch.where(band < 18, slen[..., :1], slen[..., 1:])
    nbits = torch.where(short[..., None], short_n, long_n)
    sf = torch.floor(rand(S, G, 2, 36) * (1 << nbits)).long()
    sf[..., 21:] *= short[..., None]
    sf = sf.view(S, F, 2, 2, 36)
    for k, (a, b) in enumerate(SCFSI_BANDS):
        sf[:, :, 1, :, a:b] = torch.where(scfsi[:, :, :, k, None],
                                          sf[:, :, 0, :, a:b],
                                          sf[:, :, 1, :, a:b])
    preflag = (rand(S, G, 2) < cfg["preflag_share"]) & ~short
    sbg = torch.where(rand(S, G, 2, 3) < cfg["subblock_share"],
                      1 + (rand(S, G, 2, 3) * 3).long(), 0)
    sbg = sbg * short[..., None]
    lo, hi = cfg["global_gain"]
    gg = lo + (rand(S, G, 2) * (hi - lo + 1)).long()
    return {"quant": quant, "block_type": bt, "global_gain": gg,
            "scalefac_compress": sfc,
            "scalefac_scale": (rand(S, G, 2) < 0.5).long(),
            "preflag": preflag.long(), "subblock_gain": sbg,
            "scalefac": sf.view(S, G, 2, 36), "scfsi": scfsi.long(),
            "ms": ms.long()}


STREAMS_PER_CHUNK = 8


def make_pool(cfg: dict, n_streams: int, seed: int, device="cpu") -> list:
    """``n_streams`` clips of ``seconds`` from ``seed``: block types and
    tags from a numpy generator, the rest from a torch generator on
    ``device``, encoded there a chunk of streams at a time."""
    if (cfg["channels"], cfg["sample_rate"], cfg["layer"],
            cfg["bitrate_kbps"]) != (2, SAMPLE_RATE, 3, 256):
        raise ValueError("the MP3 generator writes 256 kbps 44.1 kHz "
                         "stereo Layer III streams")
    device = torch.device(device)
    rng = np.random.default_rng(seed % (1 << 64))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    n = int(round(cfg["seconds"] * SAMPLE_RATE))
    pool = []
    for a in range(0, n_streams, STREAMS_PER_CHUNK):
        S = min(STREAMS_PER_CHUNK, n_streams - a)
        g = draw(cfg, rng, gen, S, device)
        tags = [default_tags(int(t)) for t in rng.integers(0, 10**6, S)]
        datas, g, silent = encode_streams(g, n, tags)
        host = {k: v.cpu().numpy() for k, v in g.items()}
        for s in range(S):
            pool.append(Stream(
                data=datas[s],
                granules={k: host[k][s] for k in FIELDS},
                n_samples=n, enc_padding=enc_padding(n),
                silent=int(silent[s].sum()), tags=tags[s],
                sample_rate=SAMPLE_RATE,
                seconds=n / SAMPLE_RATE))
    return pool
