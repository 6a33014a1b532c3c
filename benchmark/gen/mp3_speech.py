"""MP3 speech stream generator: a seeded pool of Common Voice-shaped clips,
MPEG-1 Layer III at 64 kbps CBR, mono, 48 kHz, with a LAME ``Info`` frame
and no ID3 tag.

A vectorised rewrite of the port's LAME-style test encoder
(``symphonia_tpu_torch/testing/mp3_lame_builder.py``: ``build_stream``
with ``Format(48000, 1, 64)`` and no tags), frozen here. The granule
encoder is the MP3 cell's (``gen/mp3.py`` ``encode_rows``: part 2's
scalefactor fields, LAME's big-values regions each with its table of
fewest bits, the count1 quads in the cheaper quad table) given the 48 kHz
band edges, and so is its reservoir layout; what is mono is written here:
the 17-byte side info (9-bit ``main_data_begin``, 5 private bits, one
channel's ``scfsi``), the headers (mode 3), 192-byte frames (no padding
at 64 kbps and 48 kHz: 171 bytes of main data a frame). For the same
granules it writes the same bytes as the test encoder
(``benchmark/tests/test_bench_mp3_speech.py``).

The draws (``make_pool``): the pool's durations are the quantiles of the
configuration's Beta distribution, in a seeded order; per clip a lead-in
and a tail of low-level granules (zero lines and a few +-1 in count1,
scalefactors zero), which leave their bytes to the reservoir; between
them speech: per frame a loudness, per granule a block type (a
LONG_START, SHORT, LONG_STOP triple at a seeded place in each run of
``onset_every`` speech granules), per granule Laplacian spectra at the
configuration's per-band scales, gains, scalefactors within
``scalefac_compress``, scfsi in second granules.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mp3 as base
from .bits import BitBuffer
from .flac import durations

SAMPLE_RATE = 48000
BITRATE_IDX = 5            # 64 kbps
RATE_IDX = 1               # 48 kHz
SIDE_INFO = 17
ENC_DELAY, LONG, SHORT = base.ENC_DELAY, base.LONG, base.SHORT
FIELDS = base.FIELDS
Stream = base.Stream
n_frames, enc_padding = base.n_frames, base.enc_padding

# ISO/IEC 11172-3 table B.8, 48 kHz.
SFB_LONG = (0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
            156, 190, 230, 276, 330, 384, 576)
SFB_SHORT = (0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192)
MODE = (3 << 6) | (1 << 2)  # mono, original


def short_order() -> np.ndarray:
    """[576]: the (window * 192 + line) of each bitstream position of a
    short granule at 48 kHz."""
    out = np.zeros(576, np.int64)
    for s in range(13):
        a, b = SFB_SHORT[s], SFB_SHORT[s + 1]
        for w in range(3):
            out[3 * a + w * (b - a) + np.arange(b - a)] = w * 192 + a + \
                np.arange(b - a)
    return out


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def frame_base() -> tuple:
    return divmod(144 * 64 * 1000, SAMPLE_RATE)


def paddings(n: int) -> np.ndarray:
    _, r = frame_base()
    j = np.arange(n + 1, dtype=np.int64)
    c = -((-j * r) // SAMPLE_RATE)
    return (c[1:] - c[:-1]).astype(np.int64)


def header(pad: int) -> bytes:
    return bytes([0xFF, 0xFB, (BITRATE_IDX << 4) | (RATE_IDX << 2)
                  | (pad << 1), MODE])


def info_frame(pad: int, n_audio: int, n_bytes: int, padding: int) -> bytes:
    size = frame_base()[0] + pad
    toc = bytes(i * 256 // 100 for i in range(100))
    lame = (b"LAME3.100" + bytes([0x01, 195]) + b"\x00" * 4 + b"\x00" * 4
            + bytes([0, 255]) + ((ENC_DELAY << 12) | padding).to_bytes(3, "big")
            + b"\x00" * 4 + n_bytes.to_bytes(4, "big") + b"\x00" * 4)
    body = (header(pad) + b"\x00" * SIDE_INFO + b"Info"
            + (0x0F).to_bytes(4, "big") + n_audio.to_bytes(4, "big")
            + n_bytes.to_bytes(4, "big") + toc + (57).to_bytes(4, "big")
            + lame)
    return body + b"\x00" * (size - len(body))


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

def tables(device) -> base._Tables:
    """The MP3 cell's code tables with the 48 kHz long band edges, which
    set LAME's region counts."""
    tb = base._Tables(device)
    tb.sfb_long = torch.tensor(SFB_LONG, device=device)
    return tb


def side_info_fields(enc: dict, g: dict):
    """(value, length) [frames, 8]: the mono side info of the rows' frames
    (rows frame-major, then granule), ``main_data_begin`` and the private
    bits left zero for the caller."""
    dev = g["quant"].device
    p23 = base._row_bits(enc)[1]
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
    rows = torch.stack([a, b, c], 1).view(-1, 2 * 3)          # [frames, 6]
    rl = torch.tensor([34, 22, 3] * 2, device=dev).expand(len(rows), 6)
    # scfsi: the first granule's row holds the frame's four bits.
    scfsi = g["scfsi"].view(-1, 2, 4)[:, 0]
    scfsi = (scfsi << torch.arange(3, -1, -1, device=dev)).sum(1)
    head = torch.stack([torch.zeros_like(scfsi), scfsi], 1)
    hl = torch.tensor([14, 4], device=dev).expand(len(rows), 2)
    return torch.cat([head, rows], 1), torch.cat([hl, rl], 1)


def encode_streams(g: dict, n_samples: list):
    """Mono streams from their granules (FIELDS, each with a leading
    stream axis [S, G, 1, ...], G = 2 F for the longest's F frames;
    scfsi [S, F, 1, 4], ms [S, F]); stream s holds ``n_samples[s]``
    samples, its granules past its own frames are ignored. Returns
    (their bytes, the granules as written, silent frames [S, F])."""
    dev = g["quant"].device
    S, G = g["quant"].shape[:2]
    F = G // 2
    fs = np.array([n_frames(n) for n in n_samples], np.int64)
    if fs.max() != F:
        raise ValueError("the granules do not match the sample counts")
    rows = {k: g[k].reshape(S * G, *g[k].shape[3:]) for k in FIELDS[:8]}
    rows["scfsi"] = g["scfsi"][:, :, None].expand(S, F, 2, 1, 4).reshape(
        -1, 4).long()
    gr = torch.arange(S * G, device=dev) % 2
    enc = base.encode_rows(tables(dev), rows, gr)
    # Rows past a stream's frames write nothing.
    live = torch.from_numpy(np.repeat(
        np.arange(F)[None, :] < fs[:, None], 2, 1).reshape(-1)).to(dev)
    for part in ("part2", "pairs", "quads"):
        v, n = enc[part]
        enc[part] = (v, n * live[:, None])
    p2, p23 = base._row_bits(enc)
    pads = paddings(F + 1)
    fbase = frame_base()[0]
    caps = fbase + pads[1:] - 4 - SIDE_INFO
    start, silent = base.layout(p23.view(S, F, 2).cpu().numpy(),
                                p2.view(S, F, 2).cpu().numpy(), caps)
    if silent.any():
        srow = torch.from_numpy(np.repeat(silent.reshape(-1), 2)).to(dev)
        base.silence_rows(enc, srow, rows["block_type"] == LONG)
        q = g["quant"].clone()
        q.view(S, F, 2, 576)[torch.from_numpy(silent).to(dev)] = 0
        g = dict(g, quant=q)
        p2, p23 = base._row_bits(enc)
    # Main data: each stream's main data bytes back to back.
    S_f = np.concatenate([[0], np.cumsum(caps)])
    total = int(S_f[-1])
    row0 = (torch.from_numpy(start).to(dev).view(S, F, 1) * 8
            + torch.arange(S, device=dev).view(S, 1, 1) * total * 8
            + (torch.cumsum(p23.view(S, F, 2), 2) - p23.view(S, F, 2)))
    row0 = row0.reshape(-1)
    buf = BitBuffer(S * total * 8, dev)
    at = row0
    for part in ("part2", "pairs", "quads"):
        v, n = enc[part]
        buf.put(at[:, None] + torch.cumsum(n, 1) - n, v, n)
        at = at + n.sum(1)
    main = buf.to_bytes().reshape(S, total)
    # Side info, main_data_begin (and the 5 private bits) first.
    sv, sl = side_info_fields(enc, rows)
    mdb = torch.from_numpy((S_f[:-1][None, :] - start).reshape(-1)).to(dev)
    sv[:, 0] = mdb << 5
    sbuf = BitBuffer(S * F * SIDE_INFO * 8, dev)
    f0 = torch.arange(S * F, device=dev)[:, None] * SIDE_INFO * 8
    sbuf.put(f0 + torch.cumsum(sl, 1) - sl, sv, sl)
    side = sbuf.to_bytes().reshape(S, F, SIDE_INFO)
    # Each audio frame: its header, its side info, then its share of the
    # main data bytes.
    out = []
    for s in range(S):
        Fs = int(fs[s])
        sizes = fbase + pads[1 : Fs + 1]
        f_at = (np.cumsum(sizes) - sizes)[:, None]
        payload = np.ones(int(sizes.sum()), bool)
        payload[f_at + np.arange(4 + SIDE_INFO)] = False
        hdr = np.zeros((Fs, 4), np.uint8)
        hdr[:] = np.frombuffer(header(0), np.uint8)
        hdr[:, 2] |= (pads[1 : Fs + 1] << 1).astype(np.uint8)
        audio = np.zeros(len(payload), np.uint8)
        audio[f_at + np.arange(4)] = hdr
        audio[f_at + 4 + np.arange(SIDE_INFO)] = side[s, :Fs]
        audio[payload] = main[s, : int(S_f[Fs])]
        head = info_frame(int(pads[0]), Fs, fbase + int(pads[0]) + len(payload),
                          enc_padding(n_samples[s]))
        out.append(head + audio.tobytes())
    return out, g, silent


# ---------------------------------------------------------------------------
# The draws and the pool
# ---------------------------------------------------------------------------

def envelopes(cfg: dict, device):
    """The Laplacian scale of each line of a long granule and of each
    bitstream position of a short one [576], from the configuration's
    per-band scales (48 kHz bands); nothing at or above the bandwidth."""
    sp = cfg["spectrum"]
    band = np.searchsorted(SFB_LONG, np.arange(576), side="right") - 1
    env = np.asarray(sp["laplace_scale"], np.float64)[band]
    env[np.arange(576) >= sp["bandwidth_lines"]] = 0.0
    env_s = np.tile(env[3 * np.arange(192)] * sp["short_scale"], 3)
    env_s = env_s[short_order()]
    return (torch.from_numpy(env).to(device),
            torch.from_numpy(env_s).to(device))


def silences(cfg: dict, rng, G: int) -> tuple:
    """(lead-in, tail) granules of a clip of G granules: seconds uniform
    over the configuration's ranges, both shrunk in proportion where they
    would leave less than ``speech_share_min`` of the clip to speech."""
    sl = cfg["silence_s"]
    lead, tail = rng.uniform(*sl["lead"]), rng.uniform(*sl["tail"])
    room = (1.0 - sl["speech_share_min"]) * G
    gl, gt = (x * SAMPLE_RATE / 576 for x in (lead, tail))
    k = min(1.0, room / (gl + gt))
    return int(round(k * gl)), int(round(k * gt))


def draw(cfg: dict, rng, gen, n_samples: list, device) -> dict:
    """Granules of len(n_samples) mono clips (FIELDS with a leading stream
    axis, each padded to the longest clip's frames)."""
    S = len(n_samples)
    fs = [n_frames(n) for n in n_samples]
    F = max(fs)
    G = 2 * F
    sp = cfg["spectrum"]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)

    speech = np.zeros((S, G), bool)
    bt = np.zeros((S, G), np.int64)
    for s in range(S):
        g_s = 2 * fs[s]
        lead, tail = silences(cfg, rng, g_s)
        speech[s, lead : g_s - tail] = True
        bt[s, lead : g_s - tail] = base.block_types(rng, g_s - tail - lead,
                                                    cfg["onset_every"])
    speech = torch.from_numpy(speech).to(device)[..., None]     # [S, G, 1]
    bt = torch.from_numpy(bt).to(device)[..., None]
    loud = torch.exp(sp["loudness_sigma"] * torch.randn(
        (S, F), generator=gen, device=device, dtype=torch.float64))
    scale = loud.repeat_interleave(2, 1)[..., None]              # [S, G, 1]
    env, env_s = envelopes(cfg, device)
    short = bt == SHORT
    e = torch.where(short[..., None], env_s, env)
    quant = base._laplace(gen, scale[..., None] * e).clamp(
        -sp["clip"], sp["clip"])
    # Silence: zero lines, a few +-1 below the bandwidth.
    ones = torch.where(rand(S, G, 1, 576) < cfg["silence_ones"],
                       torch.where(rand(S, G, 1, 576) < 0.5, -1.0, 1.0), 0.0)
    ones = ones * (torch.arange(576, device=device) < sp["bandwidth_lines"])
    quant = torch.where(speech[..., None], quant, ones).to(torch.int16)
    # scfsi in frames whose granules are both long speech.
    both = ((bt[:, 0::2] == LONG) & (bt[:, 1::2] == LONG)
            & speech[:, 0::2] & speech[:, 1::2])               # [S, F, 1]
    scfsi = (rand(S, F, 1, 4) < cfg["scfsi_share"]) & both[..., None]
    sfc = (rand(S, F, 2, 1) * 16).long()
    sfc[:, :, 1] = torch.where(scfsi.any(-1), sfc[:, :, 0], sfc[:, :, 1])
    sfc = sfc.view(S, G, 1) * speech
    slen = torch.tensor(base.SLEN, device=device)[sfc]        # [S, G, 1, 2]
    band = torch.arange(36, device=device)
    long_n = torch.where(band < 11, slen[..., :1], slen[..., 1:])
    short_n = torch.where(band < 18, slen[..., :1], slen[..., 1:])
    nbits = torch.where(short[..., None], short_n, long_n)
    sf = torch.floor(rand(S, G, 1, 36) * (1 << nbits)).long()
    sf[..., 21:] *= short[..., None]
    sf = sf.view(S, F, 2, 1, 36)
    for k, (a, b) in enumerate(base.SCFSI_BANDS):
        sf[:, :, 1, :, a:b] = torch.where(scfsi[:, :, :, k, None],
                                          sf[:, :, 0, :, a:b],
                                          sf[:, :, 1, :, a:b])
    preflag = (rand(S, G, 1) < cfg["preflag_share"]) & ~short & speech
    sbg = torch.where(rand(S, G, 1, 3) < cfg["subblock_share"],
                      1 + (rand(S, G, 1, 3) * 3).long(), 0)
    sbg = sbg * short[..., None]
    lo, hi = cfg["global_gain"]
    gg = lo + (rand(S, G, 1) * (hi - lo + 1)).long()
    return {"quant": quant, "block_type": bt, "global_gain": gg,
            "scalefac_compress": sfc,
            "scalefac_scale": (rand(S, G, 1) < 0.5).long(),
            "preflag": preflag.long(), "subblock_gain": sbg,
            "scalefac": sf.view(S, G, 1, 36), "scfsi": scfsi.long(),
            "ms": torch.zeros((S, F), dtype=torch.int64, device=device)}


STREAMS_PER_CHUNK = 32


def make_pool(cfg: dict, n_streams: int, seed: int, device="cpu") -> list:
    """``n_streams`` clips from ``seed``: the durations' quantile set in a
    seeded order, silences and block types from a numpy generator, the
    rest from a torch generator on ``device``, encoded there a chunk of
    clips at a time."""
    if (cfg["channels"], cfg["sample_rate"], cfg["layer"],
            cfg["bitrate_kbps"]) != (1, SAMPLE_RATE, 3, 64):
        raise ValueError("the MP3 speech generator writes 64 kbps 48 kHz "
                         "mono Layer III streams")
    device = torch.device(device)
    rng = np.random.default_rng(seed % (1 << 64))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    ns = [int(round(s * SAMPLE_RATE))
          for s in rng.permutation(durations(cfg, n_streams))]
    pool = []
    for a in range(0, n_streams, STREAMS_PER_CHUNK):
        part = ns[a : a + STREAMS_PER_CHUNK]
        g = draw(cfg, rng, gen, part, device)
        datas, g, silent = encode_streams(g, part)
        host = {k: v.cpu().numpy() for k, v in g.items()}
        for s, n in enumerate(part):
            F = n_frames(n)
            pool.append(Stream(
                data=datas[s],
                granules={k: host[k][s][: F if k in ("scfsi", "ms")
                                        else 2 * F] for k in FIELDS},
                n_samples=n, enc_padding=enc_padding(n),
                silent=int(silent[s, :F].sum()), tags={},
                sample_rate=SAMPLE_RATE, seconds=n / SAMPLE_RATE))
    return pool
