"""Plain reference for the AAC cells: the generator's spectra synthesised
in float64.

A vectorised form of the AAC test encoder's ``reference_synthesis``
(``symphonia_tpu_torch/testing/aac_builder.py``): each ICS's quantised
spectrum dequantised (sign * |q|^(4/3) * 2^((gain - 156) / 4)), the IMDCT
as a matrix product, sine windows, and the overlap of each frame's head
with the previous frame's tail for ONLY_LONG, LONG_START, EIGHT_SHORT and
LONG_STOP. Frames are independent once their tails are known, so all
frames of all streams are done at once. Nothing of the program is
imported or used.

``precision="tf32"`` is the control: the same synthesis in float32 with
the IMDCT's operands rounded to TF32 (the tensor cores' format) -- the
step that would tempt a port -- which fails the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

P0, P1 = 448, 576


def _imdct_matrix(n_in: int, dtype, device) -> torch.Tensor:
    n_out = 2 * n_in
    i = torch.arange(n_out, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(n_in, dtype=torch.float64, device=device)[None, :]
    m = torch.cos(np.pi / (2 * n_out) * (2 * i + 1 + n_in) * (2 * j + 1))
    return (m / n_out).to(dtype)


def _sine(n: int, dtype, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return torch.sin((k + 0.5) * np.pi / (2 * n)).to(dtype)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _product(x, m, precision):
    if precision == "tf32":
        return _tf32(x) @ _tf32(m).T
    return x @ m.T


def synthesise(quant: torch.Tensor, seqs: torch.Tensor, gain: int,
               precision: str = "float64") -> torch.Tensor:
    """PCM [S, C, F * 1024] of S streams' spectra quant [S, F, C, 1024]
    (int) with window sequences seqs [S, F]."""
    dev = quant.device
    dt = torch.float64 if precision == "float64" else torch.float32
    S, F, C, _ = quant.shape
    q = quant.permute(0, 2, 1, 3).reshape(-1, 1024)     # [S*C*F, 1024]
    seq = seqs[:, None, :].expand(S, C, F).reshape(-1)
    scale = 2.0 ** (0.25 * (gain - 156))
    spec = torch.sign(q) * q.abs().to(torch.float64) ** (4.0 / 3.0) * scale
    spec = spec.to(dt)
    wl, ws = _sine(1024, dt, dev), _sine(128, dt, dev)
    short = seq == 2
    pcm = torch.zeros((len(q), 2048), dtype=dt, device=dev)
    lo = torch.nonzero(~short).reshape(-1)
    for a in range(0, len(lo), 16384):
        r = lo[a : a + 16384]
        pcm[r] = _product(spec[r], _imdct_matrix(1024, dt, dev), precision)
    sh = torch.nonzero(short).reshape(-1)
    if len(sh):
        y = _product(spec[sh].view(-1, 128), _imdct_matrix(128, dt, dev),
                     precision).view(len(sh), 8, 256)
        buf = torch.zeros((len(sh), 1152), dtype=dt, device=dev)
        for w in range(8):
            buf[:, w * 128 : w * 128 + 128] += y[:, w, :128] * ws
            buf[:, w * 128 + 128 : w * 128 + 256] += y[:, w, 128:] * ws.flip(0)
        pcm[sh, :1152] = buf
    head = torch.zeros((len(q), 1024), dtype=dt, device=dev)
    tail = torch.zeros((len(q), 1024), dtype=dt, device=dev)
    m = (seq == 0) | (seq == 1)
    head[m] = pcm[m, :1024] * wl
    head[short, P0:] = pcm[short, : 1024 - P0]
    m3 = seq == 3
    head[m3, P0:P1] = pcm[m3, P0:P1] * ws
    head[m3, P1:] = pcm[m3, P1:1024]
    m = (seq == 0) | m3
    tail[m] = pcm[m, 1024:] * wl.flip(0)
    tail[short, :P1] = pcm[short, P1 : 2 * P1]
    m1 = seq == 1
    tail[m1, :P0] = pcm[m1, 1024 : 1024 + P0]
    tail[m1, P0:P1] = pcm[m1, 1024 + P0 : 1024 + P1] * ws.flip(0)
    head = head.view(S * C, F, 1024)
    tail = tail.view(S * C, F, 1024)
    head[:, 1:] += tail[:, :-1]
    return head.reshape(S, C, F * 1024)


def expected(pool, device, precision: str = "float64") -> list:
    """The expected PCM of every pool stream, [C, F * 1024] each."""
    out = []
    for a in range(0, len(pool), 16):
        part = pool[a : a + 16]
        quant = torch.from_numpy(np.stack([s.quant for s in part])).to(device)
        seqs = torch.from_numpy(np.stack([s.seqs for s in part])).to(device)
        out.extend(synthesise(quant, seqs, part[0].gain, precision))
    return out


def judge(pool, requests, device) -> dict:
    """The compared numbers over every stream of every request: the worst
    error of a sample, relative to its stream's peak, and the streams
    whose rate, channels or length are wrong."""
    ref = expected(pool, device)
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
            got = torch.from_numpy(got).to(device, torch.float64)
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
    return [Decoded(p.cpu().numpy(), s.sample_rate)
            for s, p in zip(streams, expected(streams, device, "tf32"))]
