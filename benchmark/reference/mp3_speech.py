"""Plain reference for the MP3 speech cell: the generator's integers of
mono 48 kHz clips synthesised in float64.

The MP3 cell's vectorised reference (``reference/mp3.py``), itself a form
of the port's plain Layer III reference
(``symphonia_tpu_torch/testing/mp3_reference.py``, which follows ISO/IEC
11172-3 step by step), with the 48 kHz scalefactor bands (table B.8) in
the requantisation and the short-block reorder, and one channel: no
mid/side. The rest is that file's: the scalefactor, subblock-gain and
pretab terms, the aliasing butterflies, the 36- and 12-point IMDCTs with
each block type's window, overlap-add and frequency inversion, the
32-band polyphase synthesis, and the LAME tag's gapless trim. Each clip is
synthesised on its own (the pool's clips differ in length). It starts
from the integers, not from the bytes, so a Huffman, reservoir,
band-table or trim fault of the program shows as a wrong sample. Nothing
of the program is imported.

``precision="tf32"`` is the control, as in ``reference/mp3.py``: the same
synthesis in float32 with the IMDCT's and the matrixing's operands rounded
to TF32; it fails the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mp3 as base
from .mp3 import HEAD, SHORT, Decoded, _mm

# ISO/IEC 11172-3 table B.8, 48 kHz.
SFB_LONG = (0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
            156, 190, 230, 276, 330, 384, 576)
SFB_SHORT = (0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192)


def _short_positions():
    """(window, line, band) of each bitstream position of a short granule
    at 48 kHz."""
    w = np.zeros(576, np.int64)
    f = np.zeros(576, np.int64)
    s_of = np.zeros(576, np.int64)
    for s in range(13):
        a, b = SFB_SHORT[s], SFB_SHORT[s + 1]
        for win in range(3):
            p = 3 * a + win * (b - a) + np.arange(b - a)
            w[p], f[p], s_of[p] = win, a + np.arange(b - a), s
    return w, f, s_of


class Consts(base._Consts):
    """The MP3 cell's constants with the 48 kHz band tables."""

    def __init__(self, dt, dev):
        super().__init__(dt, dev)
        self.band = torch.as_tensor(
            np.searchsorted(SFB_LONG, np.arange(576), side="right") - 1,
            device=dev)
        w, f, s = _short_positions()
        self.win = torch.as_tensor(w, device=dev)
        self.sidx = torch.as_tensor(3 * s + w, device=dev)
        self.dest = torch.as_tensor(3 * f + w, device=dev)


def synthesise(g: dict, consts, dt, dev, precision: str) -> torch.Tensor:
    """Untrimmed PCM [1, G * 576] of one mono clip's granules (a dict of
    the generator's fields); ``consts`` sets the band tables."""
    t = lambda k, dtype=torch.float64: torch.as_tensor(
        np.asarray(g[k]), device=dev).to(dtype)
    q = t("quant")                                           # [G, 1, 576]
    G = q.shape[0]
    gg, sfs, sf, pre = (t(k) for k in ("global_gain", "scalefac_scale",
                                       "scalefac", "preflag"))
    sbg = t("subblock_gain")
    bt = t("block_type", torch.int64)
    short = bt == SHORT
    mult = 0.5 * (1 + sfs)[..., None]
    zeros = torch.zeros((G, 1, 1), device=dev, dtype=torch.float64)
    sf_l = torch.cat([sf[..., :21], zeros], -1)
    e_long = 0.25 * (gg[..., None] - 210) - mult * (
        sf_l[..., consts.band] + pre[..., None] * consts.pretab[consts.band])
    sf_s = torch.cat([sf, zeros.expand(G, 1, 3)], -1)
    e_short = (0.25 * (gg[..., None] - 210 - 8 * sbg[..., consts.win])
               - mult * sf_s[..., consts.sidx])
    e = torch.where(short[..., None], e_short, e_long)
    x = (torch.sign(q) * q.abs() ** (4.0 / 3.0) * torch.exp2(e)).to(dt)
    ro = torch.empty_like(x)
    ro[..., consts.dest] = x
    x = torch.where(short[..., None], ro, x).view(G, 1, 32, 18)
    # Lines 17 down to 10 of subbands 0..30 against 0..7 of 1..31.
    lo, hi = x[..., :31, 10:18].flip(-1), x[..., 1:, 0:8]
    y = x.clone()
    y[..., :31, 10:18] = (lo * consts.cs - hi * consts.ca).flip(-1)
    y[..., 1:, 0:8] = hi * consts.cs + lo * consts.ca
    x = torch.where(short[..., None, None], x, y)
    out = _mm(x, consts.m36, precision) * consts.windows[bt][..., None, :]
    sh = torch.zeros_like(out)
    for w in range(3):
        sh[..., 6 + 6 * w : 18 + 6 * w] += _mm(
            x[..., w::3], consts.m12, precision) * consts.w12
    out = torch.where(short[..., None, None], sh, out)       # [G,1,32,36]
    prev = torch.cat([torch.zeros_like(out[:1, ..., 18:]),
                      out[:-1, ..., 18:]])
    sub = (out[..., :18] + prev) * consts.finv               # [G,1,32,18]
    T = G * 18
    sub = sub.permute(1, 0, 3, 2).reshape(1, T, 32)
    V = _mm(sub, consts.N.T, precision)                      # [1, T, 64]
    Vp = torch.cat([torch.zeros((1, 15, 64), dtype=dt, device=dev), V], 1)
    pcm = torch.zeros((1, T, 32), dtype=dt, device=dev)
    for i in range(8):
        pcm += consts.D[i, 0] * Vp[:, 15 - 2 * i : 15 - 2 * i + T, :32]
        pcm += consts.D[i, 1] * Vp[:, 14 - 2 * i : 14 - 2 * i + T, 32:]
    return pcm.reshape(1, T * 32)


def expected(pool, idx, device, precision: str = "float64",
             consts_type=Consts) -> dict:
    """Trimmed PCM [1, n_samples] of the pool streams ``idx``
    (``consts_type`` sets the band tables: the 48 kHz ones)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    dt = torch.float64 if precision == "float64" else torch.float32
    consts = consts_type(dt, dev)
    out = {}
    for i in sorted(set(idx)):
        s = pool[i]
        pcm = synthesise(s.granules, consts, dt, dev, precision)
        out[i] = pcm[:, HEAD : HEAD + s.n_samples].clone()
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


def control(streams, device="cpu") -> list:
    """The control: each clip synthesised at TF32 in float32."""
    got = expected(streams, range(len(streams)), device, "tf32")
    return [Decoded(got[i].cpu().numpy(), s.sample_rate)
            for i, s in enumerate(streams)]
