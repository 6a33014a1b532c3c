"""Plain reference for the MP3 cell: the generator's integers synthesised
in float64.

A vectorised form of the port's plain Layer III reference
(``symphonia_tpu_torch/testing/mp3_reference.py``), which follows ISO/IEC
11172-3 step by step: requantisation with the scalefactor, subblock-gain
and pretab terms, short-block reordering, mid/side, the aliasing
butterflies, the 36- and 12-point IMDCTs with each block type's window,
overlap-add and frequency inversion, the 32-band polyphase synthesis, and
the LAME tag's gapless trim. Here every granule of a stream is done at
once, and the synthesis's V buffer is read as the 16 slots each output
slot reaches. It starts from the integers, not from the bytes, so a
Huffman, reservoir or scalefactor fault of the program shows as a wrong
sample. The synthesis window D is the standard's table B.3, frozen beside
this file (``mp3_window.npz``). Nothing of the program is imported.

``precision="tf32"`` is the control: the same synthesis in float32 with
the IMDCT's and the matrixing's operands rounded to TF32 (the tensor
cores' format), the shortcut that would tempt a port on this card; it
fails the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

D = np.load(__file__[: -len("mp3.py")] + "mp3_window.npz")["d"]

SFB_LONG = (0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
            162, 196, 238, 288, 342, 418, 576)
SFB_SHORT = (0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192)
PRETAB = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0)
ALIAS_C = (-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037)
SHORT = 2
HEAD = 576 + 529
STREAMS_AT_ONCE = 4


def _tf32(t: torch.Tensor) -> torch.Tensor:
    b = t.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision):
    if precision == "tf32":
        return _tf32(a) @ _tf32(b)
    return a @ b


def _short_positions():
    w = np.zeros(576, np.int64)
    f = np.zeros(576, np.int64)
    s_of = np.zeros(576, np.int64)
    for s in range(13):
        a, b = SFB_SHORT[s], SFB_SHORT[s + 1]
        for win in range(3):
            p = 3 * a + win * (b - a) + np.arange(b - a)
            w[p], f[p], s_of[p] = win, a + np.arange(b - a), s
    return w, f, s_of


class _Consts:
    def __init__(self, dt, dev):
        f64 = dict(dtype=torch.float64)
        self.band = torch.as_tensor(
            np.searchsorted(SFB_LONG, np.arange(576), side="right") - 1,
            device=dev)
        self.pretab = torch.tensor(PRETAB, device=dev, **f64)
        w, f, s = _short_positions()
        self.win = torch.as_tensor(w, device=dev)
        self.sidx = torch.as_tensor(3 * s + w, device=dev)
        self.dest = torch.as_tensor(3 * f + w, device=dev)
        c = torch.tensor(ALIAS_C, **f64)
        self.cs = (1 / torch.sqrt(1 + c * c)).to(dt).to(dev)
        self.ca = (c / torch.sqrt(1 + c * c)).to(dt).to(dev)

        def imdct(n):
            i = torch.arange(n, **f64)[None, :]
            k = torch.arange(n // 2, **f64)[:, None]
            return torch.cos(np.pi / (2 * n) * (2 * i + 1 + n / 2)
                             * (2 * k + 1)).to(dt).to(dev)

        self.m36, self.m12 = imdct(36), imdct(12)
        i = torch.arange(36, **f64)
        sin36 = torch.sin(np.pi / 36 * (i + 0.5))
        win = torch.zeros((4, 36), **f64)
        win[0] = sin36
        win[1, :18], win[1, 18:24] = sin36[:18], 1
        win[1, 24:30] = torch.sin(np.pi / 12 * (i[24:30] - 18 + 0.5))
        win[3, 6:12] = torch.sin(np.pi / 12 * (i[6:12] - 6 + 0.5))
        win[3, 12:18], win[3, 18:] = 1, sin36[18:]
        self.windows = win.to(dt).to(dev)
        self.w12 = torch.sin(np.pi / 12 * (i[:12] + 0.5)).to(dt).to(dev)
        sign = torch.ones((32, 18), **f64)
        sign[1::2, 1::2] = -1
        self.finv = sign.to(dt).to(dev)
        j = torch.arange(64, **f64)[:, None]
        k = torch.arange(32, **f64)[None, :]
        self.N = torch.cos((16 + j) * (2 * k + 1) * np.pi / 64).to(dt).to(dev)
        self.D = torch.as_tensor(D, device=dev).to(dt).view(8, 2, 32)


def _t(x, dev, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), device=dev).to(dtype)


def synthesise(granules: list, consts: _Consts, dt, dev,
               precision: str) -> torch.Tensor:
    """Untrimmed PCM [S, 2, G * 576] of S streams' granules (dicts of the
    generator's fields, all of G granules)."""
    cat = lambda k, dtype=torch.float64: torch.stack(
        [_t(g[k], dev, dtype) for g in granules])
    q = cat("quant")                                          # [S, G, 2, 576]
    S, G = q.shape[:2]
    gg, sfs = cat("global_gain"), cat("scalefac_scale")
    sf, pre = cat("scalefac"), cat("preflag")
    sbg = cat("subblock_gain")
    bt = cat("block_type", torch.int64)
    ms = cat("ms", torch.bool).repeat_interleave(2, 1)        # [S, G]
    short = bt == SHORT
    mult = 0.5 * (1 + sfs)[..., None]
    zeros = torch.zeros((S, G, 2, 1), device=dev, dtype=torch.float64)
    sf_l = torch.cat([sf[..., :21], zeros], -1)
    e_long = 0.25 * (gg[..., None] - 210) - mult * (
        sf_l[..., consts.band] + pre[..., None] * consts.pretab[consts.band])
    sf_s = torch.cat([sf, zeros.expand(S, G, 2, 3)], -1)
    e_short = (0.25 * (gg[..., None] - 210 - 8 * sbg[..., consts.win])
               - mult * sf_s[..., consts.sidx])
    e = torch.where(short[..., None], e_short, e_long)
    x = (torch.sign(q) * q.abs() ** (4.0 / 3.0) * torch.exp2(e)).to(dt)
    del q, e, e_long, e_short
    ro = torch.empty_like(x)
    ro[..., consts.dest] = x
    x = torch.where(short[..., None], ro, x)
    del ro
    r2 = torch.tensor(0.5 ** 0.5, dtype=dt, device=dev)
    m, s = x[:, :, 0], x[:, :, 1]
    lr = torch.stack([(m + s) * r2, (m - s) * r2], 2)
    x = torch.where(ms[..., None, None], lr, x).view(S, G, 2, 32, 18)
    del lr, m, s
    # Lines 17 down to 10 of subbands 0..30 against 0..7 of 1..31.
    lo, hi = x[..., :31, 10:18].flip(-1), x[..., 1:, 0:8]
    y = x.clone()
    y[..., :31, 10:18] = (lo * consts.cs - hi * consts.ca).flip(-1)
    y[..., 1:, 0:8] = hi * consts.cs + lo * consts.ca
    x = torch.where(short[..., None, None], x, y)
    del y
    out = _mm(x, consts.m36, precision) * consts.windows[bt][..., None, :]
    sh = torch.zeros_like(out)
    for w in range(3):
        sh[..., 6 + 6 * w : 18 + 6 * w] += _mm(
            x[..., w::3], consts.m12, precision) * consts.w12
    out = torch.where(short[..., None, None], sh, out)       # [S,G,2,32,36]
    del sh, x
    prev = torch.cat([torch.zeros_like(out[:, :1, ..., 18:]),
                      out[:, :-1, ..., 18:]], 1)
    sub = (out[..., :18] + prev) * consts.finv               # [S,G,2,32,18]
    del out, prev
    sub = sub.permute(0, 2, 1, 4, 3).reshape(S, 2, G * 18, 32)
    T = G * 18
    V = _mm(sub, consts.N.T, precision)                      # [S, 2, T, 64]
    del sub
    Vp = torch.cat([torch.zeros((S, 2, 15, 64), dtype=dt, device=dev), V], 2)
    pcm = torch.zeros((S, 2, T, 32), dtype=dt, device=dev)
    for i in range(8):
        pcm += consts.D[i, 0] * Vp[:, :, 15 - 2 * i : 15 - 2 * i + T, :32]
        pcm += consts.D[i, 1] * Vp[:, :, 14 - 2 * i : 14 - 2 * i + T, 32:]
    return pcm.reshape(S, 2, T * 32)


def expected(pool, idx, device, precision: str = "float64") -> dict:
    """Trimmed PCM [2, n_samples] of the pool streams ``idx``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    dt = torch.float64 if precision == "float64" else torch.float32
    consts = _Consts(dt, dev)
    out = {}
    idx = sorted(set(idx))
    for a in range(0, len(idx), STREAMS_AT_ONCE):
        part = idx[a : a + STREAMS_AT_ONCE]
        pcm = synthesise([pool[i].granules for i in part], consts, dt, dev,
                         precision)
        for i, p in zip(part, pcm):
            s = pool[i]
            out[i] = p[:, HEAD : HEAD + s.n_samples].clone()
        del pcm
    return out


def judge(pool, requests, device) -> dict:
    """The compared numbers over every stream of every request: the worst
    error of a sample, relative to its stream's peak, and the streams
    whose rate, channels or length are wrong."""
    ref = expected(pool, [i for idx, _ in requests for i in idx], device)
    wrong_shape = streams = 0
    worst = 0.0
    for idx, outs in requests:
        for i, out in zip(idx, outs):
            streams += 1
            want = ref[i]
            got = np.asarray(out.samples)
            if (out.sample_rate != pool[i].sample_rate
                    or got.shape != tuple(want.shape)):
                wrong_shape += 1
                continue
            got = torch.from_numpy(got).to(want.device, torch.float64)
            err = float((got - want).abs().max())
            peak = max(float(want.abs().max()), 1e-30)
            worst = max(worst, err / peak)
    return {"streams_wrong_shape": wrong_shape,
            "max_rel_err": worst, "streams_compared": streams}


class Decoded:
    """An output as the program gives one, for the control."""

    def __init__(self, samples, sample_rate):
        self.samples, self.sample_rate, self.md5_ok = samples, sample_rate, None


def control(streams, device="cpu") -> list:
    """The control: each stream synthesised at TF32 in float32."""
    got = expected(streams, range(len(streams)), device, "tf32")
    return [Decoded(got[i].cpu().numpy(), s.sample_rate)
            for i, s in enumerate(streams)]
