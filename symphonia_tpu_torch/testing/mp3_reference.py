"""Plain MPEG-1 Layer III synthesis in float64, from a stream's integers.

The reference the decode tests hold the port to: it starts from the
integers an encoder wrote (``mp3_lame_builder.Granules``: quantised
spectra in bitstream order, gains, scalefactors, block types, mid/side
flags; one or two channels), not from the bytes, so a Huffman, reservoir,
scalefactor or band-table fault of a decoder shows as a wrong sample. It
follows ISO/IEC 11172-3 2.4.3.4 step by step, in plain ``torch`` float64
on any device:

1. requantisation, sign(is) |is|^(4/3) 2^((global_gain - 210) / 4) with
   the scalefactor term 2^(-(1 + scalefac_scale) / 2 (sf + preflag
   pretab)) of long bands, and with 2^(-2 subblock_gain) and the window's
   scalefactor in short bands (band 21 long and 12 short carry none), the
   bands those of the stream's sample rate (table B.8: 32, 44.1, 48 kHz);
2. short-block reordering, window w's line f of the bitstream's band
   order to position 3 f + w;
3. mid/side in a stereo stream: L = (M + S) / sqrt 2, R = (M - S) /
   sqrt 2 on all 576 lines (intensity stereo is never on in these
   streams); a mono stream has none;
4. the aliasing butterflies at the 31 subband edges of long blocks;
5. the 36-point IMDCT with the window of each long block type, or three
   12-point IMDCTs with the short window laid at 6, 12 and 18;
6. overlap-add with the previous granule's second half, then frequency
   inversion (odd samples of odd subbands negated);
7. the 32-band polyphase synthesis, its 1024-sample V buffer shifted by 64
   a slot, from zeros at the stream's start;
8. the gapless trim of the LAME tag: ``576 + 529`` samples at the head,
   the encoder padding less 529 at the tail.

Departures from the standard: none in the arithmetic. The synthesis
window D is the standard's table B.3, read from the package's data file
(stored there in float32; it has no closed form); nothing of the decoder
is imported. TF32 is switched off for the products.
``precision="tf32"`` is the control: the same steps in float32 with the
IMDCT's and the matrixing's operands rounded to TF32, which the tests'
tolerance must refuse.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# Scalefactor band edges of each MPEG-1 sample rate (ISO/IEC 11172-3
# table B.8): long bands over 576 lines, short bands over a window's 192.
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
PRETAB = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0)
ALIAS_C = (-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037)
SHORT = 2
HEAD = 576 + 529


def synthesis_window() -> np.ndarray:
    """The standard's D [512] (ISO/IEC 11172-3 table B.3)."""
    path = Path(__file__).resolve().parent.parent / "data" / "mp3_tables.npz"
    return np.load(path)["synthesis_d"].astype(np.float64)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    b = t.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision):
    if precision == "tf32":
        return _tf32(a) @ _tf32(b)
    return a @ b


def _short_positions(sample_rate: int = 44100):
    """(window, line, band) of each bitstream position of a short
    granule."""
    sfb = SFB[sample_rate][1]
    w = np.zeros(576, np.int64)
    f = np.zeros(576, np.int64)
    s_of = np.zeros(576, np.int64)
    for s in range(13):
        a, b = sfb[s], sfb[s + 1]
        for win in range(3):
            p = 3 * a + win * (b - a) + np.arange(b - a)
            w[p], f[p], s_of[p] = win, a + np.arange(b - a), s
    return w, f, s_of


def requantise(g, dt, dev, sample_rate: int = 44100) -> torch.Tensor:
    """Step 1: [G, C, 576] in bitstream order."""
    q = torch.as_tensor(np.asarray(g.quant), device=dev).to(torch.float64)
    G, C = q.shape[:2]
    gg = torch.as_tensor(np.asarray(g.global_gain), device=dev).double()
    mult = 0.5 * (1 + torch.as_tensor(np.asarray(g.scalefac_scale),
                                      device=dev).double())
    sf = torch.as_tensor(np.asarray(g.scalefac), device=dev).double()
    pre = torch.as_tensor(np.asarray(g.preflag), device=dev).double()
    sbg = torch.as_tensor(np.asarray(g.subblock_gain), device=dev).double()
    # Long: the band of each line.
    band = np.searchsorted(SFB[sample_rate][0], np.arange(576),
                           side="right") - 1
    sf_l = torch.cat([sf[..., :21], torch.zeros((G, C, 1), device=dev,
                                                dtype=torch.float64)], -1)
    pretab = torch.tensor(PRETAB, device=dev, dtype=torch.float64)
    e_long = (0.25 * (gg[..., None] - 210) - mult[..., None] * (
        sf_l[..., band] + pre[..., None] * pretab[band]))
    # Short: the window and band of each bitstream position.
    w, _, s = _short_positions(sample_rate)
    sf_s = torch.cat([sf[..., :36], torch.zeros((G, C, 3), device=dev,
                                                dtype=torch.float64)], -1)
    e_short = (0.25 * (gg[..., None] - 210 - 8 * sbg[..., w])
               - mult[..., None] * sf_s[..., 3 * s + w])
    short = torch.as_tensor(np.asarray(g.block_type), device=dev) == SHORT
    e = torch.where(short[..., None], e_short, e_long)
    x = torch.sign(q) * q.abs() ** (4.0 / 3.0) * torch.exp2(e)
    return x.to(dt)


def reorder(x: torch.Tensor, short: torch.Tensor,
            sample_rate: int = 44100) -> torch.Tensor:
    """Step 2: short granules' lines to 3 f + w."""
    w, f, _ = _short_positions(sample_rate)
    dest = torch.as_tensor(3 * f + w, device=x.device)
    ro = torch.empty_like(x)
    ro[..., dest] = x
    return torch.where(short[..., None], ro, x)


def mid_side(x: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """Step 3: ms [G] per granule; a mono stream's x as it is."""
    if x.shape[1] == 1:
        return x
    m, s = x[:, 0], x[:, 1]
    r2 = torch.tensor(0.5 ** 0.5, dtype=x.dtype, device=x.device)
    lr = torch.stack([(m + s) * r2, (m - s) * r2], 1)
    return torch.where(ms[:, None, None], lr, x)


def antialias(x: torch.Tensor, short: torch.Tensor) -> torch.Tensor:
    """Step 4 on long granules: x [..., 576]."""
    c = torch.tensor(ALIAS_C, dtype=torch.float64)
    cs = (1 / torch.sqrt(1 + c * c)).to(x.dtype).to(x.device)
    ca = (c / torch.sqrt(1 + c * c)).to(x.dtype).to(x.device)
    y = x.clone()
    for sb in range(1, 32):
        for i in range(8):
            bu, bd = x[..., 18 * sb - 1 - i], x[..., 18 * sb + i]
            y[..., 18 * sb - 1 - i] = bu * cs[i] - bd * ca[i]
            y[..., 18 * sb + i] = bd * cs[i] + bu * ca[i]
    return torch.where(short[..., None], x, y)


def imdct_matrix(n: int, dt, dev) -> torch.Tensor:
    """[n/2, n]: x_i = sum_k X_k cos(pi / (2n) (2i + 1 + n/2) (2k + 1))."""
    i = torch.arange(n, dtype=torch.float64)[None, :]
    k = torch.arange(n // 2, dtype=torch.float64)[:, None]
    return torch.cos(np.pi / (2 * n) * (2 * i + 1 + n / 2) * (2 * k + 1)).to(
        dt).to(dev)


def block_windows(dt, dev) -> torch.Tensor:
    """[4, 36]: the windows of block types 0, 1 and 3 (row 2: zeros)."""
    i = torch.arange(36, dtype=torch.float64)
    sin36 = torch.sin(np.pi / 36 * (i + 0.5))
    out = torch.zeros((4, 36), dtype=torch.float64)
    out[0] = sin36
    out[1, :18] = sin36[:18]
    out[1, 18:24] = 1
    out[1, 24:30] = torch.sin(np.pi / 12 * (i[24:30] - 18 + 0.5))
    out[3, 6:12] = torch.sin(np.pi / 12 * (i[6:12] - 6 + 0.5))
    out[3, 12:18] = 1
    out[3, 18:] = sin36[18:]
    return out.to(dt).to(dev)


def imdct(x: torch.Tensor, bt: torch.Tensor, precision: str) -> torch.Tensor:
    """Step 5: x [..., 576] -> [..., 32, 36] windowed block outputs."""
    dt, dev = x.dtype, x.device
    xs = x.reshape(*x.shape[:-1], 32, 18)
    long_out = _mm(xs, imdct_matrix(36, dt, dev), precision)
    win = block_windows(dt, dev)[bt.long()]                 # [..., 36]
    long_out = long_out * win[..., None, :]
    m12 = imdct_matrix(12, dt, dev)
    i = torch.arange(12, dtype=torch.float64)
    w12 = torch.sin(np.pi / 12 * (i + 0.5)).to(dt).to(dev)
    short_out = torch.zeros_like(long_out)
    for w in range(3):
        y = _mm(xs[..., w::3], m12, precision) * w12
        short_out[..., 6 + 6 * w : 18 + 6 * w] += y
    return torch.where((bt == SHORT)[..., None, None], short_out, long_out)


def overlap(y: torch.Tensor) -> torch.Tensor:
    """Step 6: y [G, C, 32, 36] -> subband samples [C, G * 18, 32]."""
    G, C = y.shape[:2]
    prev = torch.cat([torch.zeros_like(y[:1, ..., 18:]), y[:-1, ..., 18:]])
    out = y[..., :18] + prev                                # [G, C, 32, 18]
    sign = torch.ones((32, 18), dtype=y.dtype, device=y.device)
    sign[1::2, 1::2] = -1
    out = out * sign
    return out.permute(1, 0, 3, 2).reshape(C, G * 18, 32)


def polyphase(S: torch.Tensor, precision: str) -> torch.Tensor:
    """Step 7: S [C, slots, 32] -> PCM [C, slots * 32], the V buffer
    shifted slot by slot."""
    C, T, _ = S.shape
    dt, dev = S.dtype, S.device
    i = torch.arange(64, dtype=torch.float64)[:, None]
    k = torch.arange(32, dtype=torch.float64)[None, :]
    N = torch.cos((16 + i) * (2 * k + 1) * np.pi / 64).to(dt).to(dev)
    D = torch.as_tensor(synthesis_window(), device=dev).to(dt)
    Vall = _mm(S.reshape(-1, 32), N.T, precision).reshape(C, T, 64)
    V = torch.zeros((C, 1024), dtype=dt, device=dev)
    out = torch.empty((C, T, 32), dtype=dt, device=dev)
    idx = torch.tensor([128 * (n // 2) + (96 if n % 2 else 0) + j
                        for n in range(16) for j in range(32)], device=dev)
    for t in range(T):
        V = torch.cat([Vall[:, t], V[:, :960]], 1)
        W = V[:, idx] * D
        out[:, t] = W.reshape(C, 16, 32).sum(1)
    return out.reshape(C, T * 32)


def synthesise(g, n_samples: int, enc_padding: int, device="cpu",
               precision: str = "float64", gapless: bool = True,
               sample_rate: int = 44100) -> torch.Tensor:
    """The trimmed PCM [C, n_samples] of a stream's granules at
    ``sample_rate``'s scalefactor bands; untrimmed, every granule's 576
    samples a channel, for ``gapless`` False (a stream without the LAME
    tag)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = torch.float64 if precision == "float64" else torch.float32
    dev = torch.device(device)
    bt = torch.as_tensor(np.asarray(g.block_type), device=dev)
    short = bt == SHORT
    ms = torch.as_tensor(np.repeat(np.asarray(g.ms), 2), device=dev) != 0
    x = requantise(g, dt, dev, sample_rate)
    x = reorder(x, short, sample_rate)
    x = mid_side(x, ms)
    x = antialias(x, short)
    pcm = polyphase(overlap(imdct(x, bt, precision)), precision)
    if not gapless:
        return pcm
    end = pcm.shape[1] - (enc_padding - 529)
    out = pcm[:, HEAD:end]
    if out.shape[1] != n_samples:
        raise ValueError("the trim does not leave the stream's samples")
    return out
