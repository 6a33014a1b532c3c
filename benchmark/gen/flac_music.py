"""Stereo FLAC music generator: a seeded pool of MUSDB18-HQ-shaped tracks,
44.1 kHz stereo, 16 or 24 bits, encoded as ``flac -5`` encodes them.

The frame layout is the FLAC test encoder's
(``symphonia_tpu_torch/testing/flac_builder.py``: ``encode_frame`` with
two LPC subframes, the side channel one bit wider), written vectorised
and frozen here with the mono generator's parts (``gen/flac.py``), so
that the yardstick does not move with the program. For the same samples,
channel assignment, predictors and partition orders it writes the
builder's bytes (``benchmark/tests/test_bench_flac_music.py``). What it
adds are the choices ``flac -5`` (``-b 4096 -l 8 -r 5 -m``) makes each
frame:

- the four candidate subframes of a frame (left, right, mid
  ``(L + R) >> 1``, side ``L - R`` at bps + 1 bits) each get an order-8
  predictor from the frame's Tukey(0.5)-windowed autocorrelation
  (Levinson-Durbin), quantised at the configuration's precision for the
  stream's depth (libFLAC's 12 for 16-bit blocks of 2,305-4,608
  samples, 15 above 16 bits);
- each candidate's Rice partition order (0..5) and parameters by
  estimated size, partitions of parameters above 14 in the 5-bit
  parameter method (RICE2), as libFLAC writes them above 16 bits;
- the channel assignment (independent, left/side, right/side, mid/side)
  whose two subframes have the least estimated size.

The pool's durations are the configuration's quantile set, the same for
every seed, in a seeded order; a track's depth is fixed by its duration's
rank (``hires_ranks``), so every request carries the same bytes whatever
the seed. Only the content changes with the seed: per track three AR(8)
processes (a common component and one a channel) driven by Laplacian
innovations whose levels move frame by frame (``content``), drawn on the
device by a generator seeded from the seed.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .bits import CRC8, CRC16, BitBuffer, crc_rows
from .flac import (_SIZE_CODES, _legal, _part_sums, _utf8_num, ar_filter,
                   durations, n_samples, streaminfo)

# Channel assignments 0-3 (independent, left/side, right/side, mid/side,
# numbered as the decoder's lane codes): the frame header's code and the
# candidate rows (left, right, mid, side) of its two subframes.
HEADER_CODES = (0b0001, 0b1000, 0b1001, 0b1010)
PAIRS = ((0, 1), (0, 3), (3, 1), (2, 3))
SIDE = 3
FRAMES_PER_CHUNK = 2048


@dataclass
class Stream:
    data: bytes
    pcm: np.ndarray          # int32 [2, samples], the source
    sample_rate: int
    seconds: float
    blocks: np.ndarray       # samples per frame
    bits: int                # bits per sample
    # Per frame: the channel assignment [F], each subframe's quantised
    # predictor [F, 2, order] and shift [F, 2]; the precision.
    frames: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# The pool's shape
# ---------------------------------------------------------------------------

def depths(cfg: dict, n: int) -> np.ndarray:
    """Bits per sample of the pool's n tracks, by their duration's rank
    (0 the shortest): ``hires_bits_per_sample`` at ``hires_ranks``, else
    ``bits_per_sample``."""
    out = np.full(n, cfg["bits_per_sample"], np.int64)
    for r in cfg["hires_ranks"]:
        if r < n:
            out[r] = cfg["hires_bits_per_sample"]
    return out


def precision(cfg: dict, bps: int) -> int:
    return int(cfg["lpc_precision"][str(bps)])


# ---------------------------------------------------------------------------
# The source
# ---------------------------------------------------------------------------

def _fft_filter(e: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Each row of ``e`` [K, n] through its impulse response ``h`` [K, T]
    (float64, causal, the first n samples)."""
    n = e.shape[1]
    m = 1 << math.ceil(math.log2(n + h.shape[1]))
    y = torch.fft.irfft(torch.fft.rfft(e, m) * torch.fft.rfft(h, m), m)
    return y[:, :n]


def music_source(rng, gen, n: int, bps: int, cfg: dict, device):
    """(left, right) int64 [n] on ``device``: a common AR(8) component in
    both channels plus one a channel (the two through one filter, their
    innovations apart), each driven by Laplacian innovations whose level
    is held for a frame. Per track the common component's level over the
    channels' own (``common_db``); per frame a jitter of that level
    (``common_sd_db``), on a share of frames (``wide_share``) a drop of
    it by ``wide_db`` (a wide passage), and a pan of the channels' own
    components (``pan_sd_db``), so that mid/side, left/side, right/side
    and independent subframes each win some frames."""
    c = cfg["content"]
    B = cfg["block_size"]
    F = -(-n // B)
    shape = dict(lpc_order=cfg["lpc_order"], **{
        k: c[k] for k in ("response_taps", "pole_radius", "max_gain")})
    h_common, h_own = (ar_filter(rng, shape)[1] for _ in range(2))
    h = torch.from_numpy(np.stack([h_common, h_own, h_own])).to(device)
    db = rng.uniform(*c["common_db"])
    common = (db + rng.normal(0.0, c["common_sd_db"], F)
              - c["wide_db"] * (rng.random(F) < c["wide_share"]))
    pan = rng.normal(0.0, c["pan_sd_db"], F)
    gains = 10.0 ** (np.stack([common, pan / 2, -pan / 2]) / 20.0)
    scale = c["residual_scale"] * 2.0 ** (bps - 16)
    g = torch.from_numpy(gains * scale).to(device)
    u = torch.rand((3, F * B), generator=gen, dtype=torch.float64,
                   device=device) - 0.5
    e = -torch.sign(u) * torch.log1p(-2.0 * u.abs())
    e = (e.view(3, F, B) * g[:, :, None]).view(3, F * B)[:, :n]
    y = _fft_filter(e, h)
    lim = (1 << (bps - 1)) - 1
    lr = torch.round(y[0] + y[1:]).clamp(-lim - 1, lim).to(torch.int64)
    return lr[0], lr[1]


# ---------------------------------------------------------------------------
# The encoder's choices
# ---------------------------------------------------------------------------

def candidates(x: torch.Tensor) -> torch.Tensor:
    """[F, 2, N] left and right -> [F, 4, N] left, right, mid, side."""
    left, right = x[:, 0], x[:, 1]
    return torch.stack([left, right, (left + right) >> 1, left - right], 1)


def tukey(blocks: torch.Tensor, N: int, alpha: float = 0.5) -> torch.Tensor:
    """[R, N] float64: libFLAC's default apodization, a Tukey(alpha)
    window over each row's ``blocks`` samples, zero past them."""
    i = torch.arange(N, device=blocks.device, dtype=torch.float64)[None, :]
    t = i / (blocks[:, None].to(torch.float64) - 1).clamp(min=1)
    rise = 0.5 * (1 - torch.cos(2 * math.pi * t / alpha))
    fall = 0.5 * (1 - torch.cos(2 * math.pi * (1 - t) / alpha))
    w = torch.where(t < alpha / 2, rise,
                    torch.where(t > 1 - alpha / 2, fall, torch.ones_like(t)))
    return torch.where(i < blocks[:, None], w, 0.0)


def lpc(x: torch.Tensor, blocks: torch.Tensor, order: int, prec: int):
    """Each row of ``x`` [R, N] int64 -> (coefs [R, order] int64, shift
    [R] int64): Levinson-Durbin on the windowed autocorrelation, then the
    coefficients quantised inside ``prec`` signed bits, the shift in
    0..15 (libFLAC's limits)."""
    R, N = x.shape
    xw = x.to(torch.float64) * tukey(blocks, N)
    r = torch.stack([(xw[:, : N - k] * xw[:, k:]).sum(1)
                     for k in range(order + 1)], 1)
    r[:, 0] *= 1.0 + 1e-10  # a lag window's white-noise floor
    a = torch.zeros((R, order), dtype=torch.float64, device=x.device)
    err = r[:, 0].clone()
    live = err > 0
    for i in range(order):
        acc = r[:, i + 1] - (a[:, :i] * r[:, 1 : i + 1].flip(1)).sum(1)
        k = torch.where(live, acc / torch.where(live, err, 1.0), 0.0)
        a[:, :i] = a[:, :i] - k[:, None] * a[:, :i].flip(1)
        a[:, i] = k
        err = err * (1.0 - k * k)
        live = live & (err > 0)
    top = (1 << (prec - 1)) - 1
    cmax = a.abs().amax(1).clamp(min=1e-9)
    shift = torch.floor(torch.log2(top / cmax)).clamp(0, 15)
    q = torch.round(a * torch.exp2(shift)[:, None]).clamp(-top - 1, top)
    return q.to(torch.int64), shift.to(torch.int64)


def residuals(x: torch.Tensor, coefs: torch.Tensor,
              shift: torch.Tensor) -> torch.Tensor:
    """[R, N] int64: x[n] - ((sum_j c_j x[n-1-j]) >> shift) from n =
    order on (the warm-up columns hold x)."""
    R, N = x.shape
    O = coefs.shape[1]
    acc = torch.zeros((R, N), dtype=torch.int64, device=x.device)
    for j in range(O):
        acc[:, O:] += coefs[:, j : j + 1] * x[:, O - 1 - j : N - 1 - j]
    return x - (acc >> shift[:, None])


def rice_params(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The test encoder's parameter rule (the bit length of the truncated
    mean of the zigzagged residuals, less one), at most 30, the 5-bit
    method's largest (``gen/flac.py`` stops at 14, the 4-bit one's)."""
    mean = torch.div(sums, counts.clamp(min=1), rounding_mode="floor")
    mean = mean.clamp(min=1).to(torch.float64)
    return (torch.frexp(mean).exponent.to(torch.int64) - 1).clamp(0, 30)


def _partitions(u, valid, blocks, po):
    """(sums, sizes, parameters, partition of each column, parameter
    bits a partition: 4, or 5 where a parameter passes 14) of each row at
    partition orders ``po`` [R]."""
    i = torch.arange(u.shape[1], device=u.device)[None, :]
    plen = (blocks >> po).clamp(min=1)
    part = torch.clamp(i // plen[:, None], max=31)
    s, n = _part_sums(u, valid, part)
    k = rice_params(s, n)
    pb = torch.where(torch.where(n > 0, k, 0).amax(1) > 14, 5, 4)
    return s, n, k, part, pb


def rice_cost(u, valid, blocks, order: int, max_po: int, force_po=None):
    """(estimated residual bits, partition order) of each row: the legal
    order in 0..max_po with the least estimate, or ``force_po`` [R]
    (clamped as the test encoder clamps it)."""
    R = u.shape[0]
    dev = u.device
    if force_po is not None:
        po = torch.as_tensor(force_po, dtype=torch.int64, device=dev)
        for _ in range(max_po + 1):  # the builder's clamp
            po = torch.where((po > 0) & ~_legal(blocks, po, order), po - 1,
                             po)
        orders = [po]
    else:
        orders = [torch.full((R,), p, dtype=torch.int64, device=dev)
                  for p in range(max_po + 1)]
    best = torch.full((R,), float("inf"), dtype=torch.float64, device=dev)
    best_po = torch.zeros(R, dtype=torch.int64, device=dev)
    for po in orders:
        s, n, k, _, pb = _partitions(u, valid, blocks, po)
        cost = torch.where(n > 0, pb[:, None] + n * (k + 1) + s / (1 << k),
                           0).sum(1)
        ok = _legal(blocks, po, order) | (force_po is not None)
        better = ok & (cost < best)
        best = torch.where(better, cost, best)
        best_po = torch.where(better, po, best_po)
    return best, best_po


def frame_header(frame_number: int, block: int, bps: int, code: int) -> bytes:
    """Sync, block size from the 16-bit trailer, rate from STREAMINFO,
    the channel assignment's code, explicit sample size, then CRC-8."""
    hdr = bytearray([0xFF, 0xF8, 0b0111 << 4,
                     (code << 4) | (_SIZE_CODES[bps] << 1)])
    hdr += _utf8_num(frame_number)
    hdr += (block - 1).to_bytes(2, "big")
    c = 0
    for b in hdr:
        c = int(CRC8[c ^ b])
    return bytes(hdr) + bytes([c])


def encode_frames(x, blocks, assign, coefs, shift, prec: int, bps: int,
                  frame_numbers, max_po: int = 5, force_po=None):
    """Encode F stereo frames, each two LPC subframes of order O, on x's
    device.

    x [F, 2, N] int64: each frame's two subframe signals (the side
    channel's at bps + 1 bits, per ``assign`` [F]), row f holding
    ``blocks[f]`` samples; coefs [F, 2, O], shift [F, 2]. The partition
    orders are the legal ones in 0..max_po with the least estimated
    size, or ``force_po`` [F, 2]. Returns (numpy bytes of the frames back
    to back, their CRC-16s left for :func:`seal`, and the byte length of
    each frame)."""
    F, _, N = x.shape
    O = coefs.shape[2]
    dev = x.device
    R = 2 * F
    xr = x.reshape(R, N)
    br = blocks.repeat_interleave(2)
    side = (torch.as_tensor(PAIRS, device=dev)[assign] == SIDE).reshape(R)
    sbps = bps + side.to(torch.int64)
    res = residuals(xr, coefs.reshape(R, O), shift.reshape(R))
    u = (res << 1) ^ (res >> 63)
    del res
    i = torch.arange(N, device=dev)[None, :]
    valid = (i >= O) & (i < br[:, None])
    u = torch.where(valid, u, 0)
    _, po = rice_cost(u, valid, br, O, max_po,
                      None if force_po is None else
                      torch.as_tensor(force_po).reshape(R))
    _, _, kp, part, pb = _partitions(u, valid, br, po)
    k = torch.gather(kp, 1, part)
    plen = br >> po
    starts = valid & ((i == O) | (i % plen[:, None] == 0))
    q = u >> k
    cost = torch.where(valid, q + 1 + k + pb[:, None] * starts, 0)
    head = 8 + O * sbps + 4 + 5 + O * prec + 2 + 4
    sub_bits = (head + cost.sum(1)).reshape(F, 2)
    headers = [frame_header(int(fn), int(b), bps, HEADER_CODES[int(a)])
               for fn, b, a in zip(frame_numbers, blocks.tolist(),
                                   assign.tolist())]
    hl = np.array([len(h) for h in headers], np.int64)
    body = sub_bits.sum(1).cpu().numpy()
    flen = hl + (body + 7) // 8 + 2
    fstart = np.r_[0, np.cumsum(flen)[:-1]]
    buf = BitBuffer(int(flen.sum()) * 8, dev)
    first = torch.from_numpy((fstart + hl) * 8).to(dev)
    sub0 = torch.stack([first, first + sub_bits[:, 0]], 1).reshape(R)

    # Subframe header: type LPC (order - 1) with no wasted bits, warm-up,
    # precision - 1, shift, coefficients, the residual method (0: 4-bit
    # parameters, 1: 5-bit), partition order.
    col = lambda v: torch.as_tensor(v, dtype=torch.int64,
                                    device=dev).expand(R, 1)
    lens = torch.cat([col(8), sbps[:, None].expand(R, O), col(4), col(5),
                      col(prec).expand(R, O), col(2), col(4)], 1)
    vals = torch.cat([col((0b100000 | (O - 1)) << 1), xr[:, :O],
                      col(prec - 1), shift.reshape(R, 1),
                      coefs.reshape(R, O), (pb - 4)[:, None], po[:, None]],
                     1)
    rel = torch.cumsum(lens, 1) - lens
    buf.put(sub0[:, None] + rel, vals, lens)
    pos = torch.cumsum(cost, 1) - cost + (sub0 + head)[:, None]
    pbs = pb[:, None].expand(R, N)
    buf.put(pos[starts], k[starts], pbs[starts])
    pos += pb[:, None] * starts + q
    buf.put(pos[valid], ((1 << k) | (u & ((1 << k) - 1)))[valid],
            (k + 1)[valid])
    out = buf.to_bytes()
    for f, h in enumerate(headers):
        out[fstart[f] : fstart[f] + hl[f]] = np.frombuffer(h, np.uint8)
    return out, flen


def choose(x4: torch.Tensor, blocks: torch.Tensor, order: int, prec: int,
           max_po: int):
    """For frames x4 [F, 4, N] (left, right, mid, side): each candidate's
    predictor and estimated size, and the assignment whose two subframes
    are the smallest (the first of equals in the header's order).
    Returns (assign [F], coefs [F, 4, O], shift [F, 4])."""
    F, _, N = x4.shape
    R = 4 * F
    xr = x4.reshape(R, N)
    br = blocks.repeat_interleave(4)
    coefs, shift = lpc(xr, br, order, prec)
    res = residuals(xr, coefs, shift)
    u = (res << 1) ^ (res >> 63)
    del res
    i = torch.arange(N, device=x4.device)[None, :]
    valid = (i >= order) & (i < br[:, None])
    bits, _ = rice_cost(torch.where(valid, u, 0), valid, br, order, max_po)
    bits = bits.reshape(F, 4)
    pairs = torch.as_tensor(PAIRS, device=x4.device)
    total = bits[:, pairs[:, 0]] + bits[:, pairs[:, 1]]
    # The side subframe's warm-up is one bit a sample wider.
    total = total + order * (pairs == SIDE).sum(1)
    return (torch.argmin(total, 1), coefs.reshape(F, 4, order),
            shift.reshape(F, 4))


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------

def md5_of(pcm: np.ndarray, bps: int) -> bytes:
    """MD5 of the interleaved little-endian samples at 2 or 3 bytes."""
    inter = np.ascontiguousarray(pcm.T).reshape(-1)
    if bps == 16:
        return hashlib.md5(inter.astype("<i2").tobytes()).digest()
    if bps == 24:
        b = inter.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return hashlib.md5(np.ascontiguousarray(b).tobytes()).digest()
    raise ValueError("the generator writes 16- and 24-bit streams")


def encode_track(left: torch.Tensor, right: torch.Tensor, bps: int,
                 cfg: dict, force_assign: int | None = None):
    """One track's frames -> (frame bytes, blocks, assign, coefs [F, 2, O],
    shift [F, 2]) as numpy, encoded chunk by chunk on the samples'
    device; ``force_assign`` puts every frame in that channel assignment
    in place of the encoder's choice."""
    B, O = cfg["block_size"], cfg["lpc_order"]
    prec = precision(cfg, bps)
    n = left.shape[0]
    F = -(-n // B)
    dev = left.device
    x = torch.zeros((2, F * B), dtype=torch.int64, device=dev)
    x[0, :n], x[1, :n] = left, right
    x = x.view(2, F, B).transpose(0, 1)
    blocks = torch.full((F,), B, dtype=torch.int64, device=dev)
    blocks[-1] = n - (F - 1) * B
    parts, lens, picks = [], [], []
    for a in range(0, F, FRAMES_PER_CHUNK):
        b = min(F, a + FRAMES_PER_CHUNK)
        x4 = candidates(x[a:b])
        assign, coefs4, shift4 = choose(x4, blocks[a:b], O, prec,
                                        cfg["max_partition_order"])
        if force_assign is not None:
            assign = torch.full_like(assign, force_assign)
        pair = torch.as_tensor(PAIRS, device=dev)[assign]
        rows = torch.arange(b - a, device=dev)[:, None]
        xs, cs, ss = x4[rows, pair], coefs4[rows, pair], shift4[rows, pair]
        out, flen = encode_frames(xs, blocks[a:b], assign, cs, ss, prec,
                                  bps, range(a, b),
                                  cfg["max_partition_order"])
        parts.append(out)
        lens.append(flen)
        picks.append((assign.cpu().numpy(), cs.cpu().numpy(),
                      ss.cpu().numpy()))
    allb = seal(np.concatenate(parts), np.concatenate(lens))
    assign, coefs, shift = (np.concatenate(p) for p in zip(*picks))
    return allb, blocks.cpu().numpy(), assign, coefs, shift


def seal(frames: np.ndarray, flen: np.ndarray) -> np.ndarray:
    """Each frame's CRC-16 into its last two bytes (the frames back to
    back, ``flen`` bytes each), all frames at once; ``frames`` returned."""
    fstart = np.r_[0, np.cumsum(flen)[:-1]]
    crc = crc_rows(frames, fstart, flen - 2, CRC16, 16)
    frames[fstart + flen - 2] = crc >> 8
    frames[fstart + flen - 1] = crc & 0xFF
    return frames


def file_bytes(pcm: np.ndarray, frames: np.ndarray, bps: int,
               cfg: dict) -> bytes:
    si = streaminfo(cfg["block_size"], cfg["sample_rate"], 2, bps,
                    pcm.shape[1], md5_of(pcm, bps))
    return b"fLaC" + bytes([0x80, 0, 0, len(si)]) + si + frames.tobytes()


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

def make_pool(cfg: dict, n_tracks: int, seed: int, device="cpu") -> list:
    """``n_tracks`` distinct stereo tracks from ``seed``: the durations'
    quantile set in a seeded order, each track's depth by its duration's
    rank, its source drawn and its frames encoded on ``device``."""
    if cfg["channels"] != 2:
        raise ValueError("the music generator writes stereo streams")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    secs = durations(cfg, n_tracks)
    bits = depths(cfg, n_tracks)
    pool = []
    for t in rng.permutation(n_tracks):
        bps = int(bits[t])
        n = n_samples(cfg, float(secs[t]))
        left, right = music_source(rng, gen, n, bps, cfg, device)
        frames, blocks, assign, coefs, shift = encode_track(left, right,
                                                            bps, cfg)
        pcm = torch.stack([left, right]).to(torch.int32).cpu().numpy()
        del left, right
        pool.append(Stream(
            data=file_bytes(pcm, frames, bps, cfg), pcm=pcm,
            sample_rate=cfg["sample_rate"], seconds=n / cfg["sample_rate"],
            blocks=blocks, bits=bps,
            frames=dict(assign=assign, coefs=coefs, shift=shift,
                        precision=precision(cfg, bps))))
    return pool
