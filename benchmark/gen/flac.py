"""FLAC stream generator: a seeded pool of speech-like mono FLAC streams.

A vectorised rewrite of the FLAC test encoder's LPC path
(``symphonia_tpu_torch/testing/flac_builder.py``: ``encode_frame`` with one
LPC subframe, ``build_streaminfo``, ``md5_of``), frozen here so that the
yardstick does not move with the program. For the same samples, LPC
coefficients, shift, precision and partition order it writes the same
bytes as the original (``benchmark/tests/test_bench_gen_flac.py``). What
it adds is the choice an encoder makes: per stream an AR(order) source and its
quantised predictor, per frame the Rice partition order (``flac -5``
tries 0..5) by estimated size.

The pool's durations are the same set for every seed (quantiles of the
configuration's distribution), in a seeded order; only the content
changes with the seed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .bits import CRC8, CRC16, BitBuffer, crc_rows

_SIZE_CODES = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110}


@dataclass
class Stream:
    data: bytes
    pcm: np.ndarray          # int64 [channels, samples], the source
    sample_rate: int
    seconds: float
    blocks: np.ndarray       # samples per frame
    lpc: dict = field(default_factory=dict)  # coefs, shift, precision


# ---------------------------------------------------------------------------
# Durations and sources
# ---------------------------------------------------------------------------

def durations(cfg: dict, n: int) -> np.ndarray:
    """The pool's n durations in seconds: quantiles (i + 0.5) / n of a
    Beta(a, b) scaled to [min, max], the same set for every seed (the
    inverse of the distribution function on a fine grid)."""
    d = cfg["duration_s"]
    a, b = d["beta"]
    t = (np.arange(1 << 16) + 0.5) / (1 << 16)
    cdf = np.cumsum(t ** (a - 1) * (1 - t) ** (b - 1))
    q = np.interp((np.arange(n) + 0.5) / n, cdf / cdf[-1], t)
    return d["min"] + (d["max"] - d["min"]) * q


def n_samples(cfg: dict, seconds: float) -> int:
    """Samples of a stream; a last frame of 1..order samples is grown to
    order + 1, which an LPC subframe needs."""
    n = int(round(seconds * cfg["sample_rate"]))
    r = n % cfg["block_size"]
    if 0 < r <= cfg["lpc_order"]:
        n += cfg["lpc_order"] + 1 - r
    return n


def ar_filter(rng, cfg: dict):
    """(a, h): an AR(order) polynomial with conjugate pole pairs, their
    radii shrunk until the power gain is at most ``max_gain``, and its
    impulse response over ``response_taps`` samples (the rest is below
    radius ** taps)."""
    order, T = cfg["lpc_order"], cfg["response_taps"]
    r = rng.uniform(*cfg["pole_radius"], size=order // 2)
    th = rng.uniform(0.05, 0.95 * np.pi, size=order // 2)
    while True:
        poles = np.concatenate([r * np.exp(1j * th), r * np.exp(-1j * th)])
        a = np.real(np.poly(poles))
        h = np.zeros(T)
        for n in range(T):
            h[n] = (n == 0) - np.dot(a[1 : n + 1], h[n - 1 :: -1][:order]
                                     if n else [])
        if np.sqrt((h * h).sum()) <= cfg["max_gain"]:
            return a, h
        r = r * 0.97


def ar_source(rng, n: int, cfg: dict):
    """int64 [n] samples of the AR process (Laplacian innovation of scale
    ``residual_scale`` through the filter's impulse response), and the
    predictor's float coefficients."""
    a, h = ar_filter(rng, cfg)
    e = rng.laplace(0.0, cfg["residual_scale"], size=n)
    lim = (1 << (cfg["bits_per_sample"] - 1)) - 1
    x = np.clip(np.rint(np.convolve(e, h)[:n]), -lim - 1, lim)
    return x.astype(np.int64), -a[1:]


def quantise(c: np.ndarray, precision: int):
    """Predictor coefficients -> (int coefs, shift) with each coefficient
    inside ``precision`` signed bits and the shift in 0..15."""
    top = (1 << (precision - 1)) - 1
    cmax = max(float(np.abs(c).max()), 1e-9)
    shift = int(np.clip(np.floor(np.log2(top / cmax)), 0, 15))
    q = np.clip(np.rint(c * (1 << shift)), -top - 1, top).astype(np.int64)
    return q, shift


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

def _utf8_num(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for n_extra in range(1, 7):
        if n < (1 << (6 * n_extra + (6 - n_extra))):
            lead = ((0xFF << (7 - n_extra)) & 0xFF) | (n >> (6 * n_extra))
            return bytes([lead] + [0x80 | ((n >> (6 * i)) & 0x3F)
                                   for i in range(n_extra - 1, -1, -1)])
    raise ValueError("frame number too large")


def frame_header(frame_number: int, block: int, bps: int,
                 channels: int) -> bytes:
    """Sync, block size from the 16-bit trailer, rate from STREAMINFO,
    independent channels, explicit sample size, then CRC-8."""
    hdr = bytearray([0xFF, 0xF8, 0b0111 << 4,
                     ((channels - 1) << 4) | (_SIZE_CODES[bps] << 1)])
    hdr += _utf8_num(frame_number)
    hdr += (block - 1).to_bytes(2, "big")
    c = 0
    for b in hdr:
        c = int(CRC8[c ^ b])
    return bytes(hdr) + bytes([c])


def rice_params(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The test encoder's parameter rule per partition: the bit length of
    the truncated mean of the zigzagged residuals, less one, at most 14."""
    mean = torch.div(sums, counts.clamp(min=1), rounding_mode="floor")
    mean = mean.clamp(min=1).to(torch.float64)
    return (torch.frexp(mean).exponent.to(torch.int64) - 1).clamp(0, 14)


def _legal(blocks, po, O):
    plen = blocks >> po
    return ((plen << po) == blocks) & (plen > O)


def _part_sums(u, valid, part):
    """Sums and sizes of ``u`` [F, N] over each frame's partitions
    ``part`` [F, N] (0..31), as [F, 32]."""
    F = u.shape[0]
    key = (torch.arange(F, device=u.device)[:, None] * 32 + part).reshape(-1)
    s = torch.zeros(F * 32, dtype=torch.int64, device=u.device)
    n = torch.zeros(F * 32, dtype=torch.int64, device=u.device)
    s.index_add_(0, key, u.reshape(-1))
    n.index_add_(0, key, valid.reshape(-1).to(torch.int64))
    return s.reshape(F, 32), n.reshape(F, 32)


def encode_frames(x: torch.Tensor, blocks: torch.Tensor, coefs: torch.Tensor,
                  shift: torch.Tensor, precision: int, bps: int,
                  frame_numbers, max_po: int = 5, force_po=None):
    """Encode F mono frames, each one LPC subframe of order O, on x's
    device.

    x [F, N] int64 samples (row f holds ``blocks[f]`` of them, N a power
    of two), coefs [F, O], shift [F]. The partition order is the legal one
    in 0..max_po with the least estimated size, or ``force_po`` [F]
    (clamped as the test encoder clamps it). Returns (numpy bytes of the
    frames back to back, byte length of each frame, partition orders)."""
    F, N = x.shape
    O = coefs.shape[1]
    dev = x.device
    i = torch.arange(N, device=dev)[None, :]
    # Residuals of samples O.. of each block (the builder's arithmetic).
    acc = torch.zeros((F, N), dtype=torch.int64, device=dev)
    for j in range(O):
        acc[:, O:] += coefs[:, j : j + 1] * x[:, O - 1 - j : N - 1 - j]
    res = x - (acc >> shift[:, None])
    del acc
    u = (res << 1) ^ (res >> 63)
    valid = (i >= O) & (i < blocks[:, None])
    u = torch.where(valid, u, 0)

    if force_po is None:
        best = torch.full((F,), float("inf"), dtype=torch.float64, device=dev)
        po_f = torch.zeros(F, dtype=torch.int64, device=dev)
        for po in range(max_po + 1):
            plen = (blocks >> po).clamp(min=1)
            s, n = _part_sums(u, valid,
                              torch.clamp(i // plen[:, None], max=31))
            k = rice_params(s, n)
            cost = torch.where(n > 0, 4 + n * (k + 1) + s / (1 << k),
                               0).sum(1)
            better = _legal(blocks, po, O) & (cost < best)
            best = torch.where(better, cost, best)
            po_f = torch.where(better, po, po_f)
    else:
        po_f = torch.as_tensor(force_po, dtype=torch.int64, device=dev)
        for _ in range(max_po + 1):  # the builder's clamp
            po_f = torch.where((po_f > 0) & ~_legal(blocks, po_f, O),
                               po_f - 1, po_f)
    plen = blocks >> po_f
    part = i // plen[:, None]
    s, n = _part_sums(u, valid, part.clamp(max=31))
    k = torch.gather(rice_params(s, n), 1, part.clamp(max=31))
    starts = valid & ((i == O) | (i % plen[:, None] == 0))

    # Bits per residual: the parameter (partition starts), the unary part,
    # the stop bit and k low bits.
    q = u >> k
    cost = torch.where(valid, q + 1 + k + 4 * starts, 0)
    head_bits = 8 + O * bps + 4 + 5 + O * precision + 2 + 4
    body_bits = (head_bits + cost.sum(1)).cpu().numpy()
    headers = [frame_header(int(fn), int(b), bps, 1)
               for fn, b in zip(frame_numbers, blocks.tolist())]
    hl = np.array([len(h) for h in headers], np.int64)
    flen = hl + (body_bits + 7) // 8 + 2
    fstart = np.r_[0, np.cumsum(flen)[:-1]]
    buf = BitBuffer(int(flen.sum()) * 8, dev)
    sub0 = torch.from_numpy((fstart + hl) * 8).to(dev)  # subframe starts

    # Subframe header: type LPC (order - 1) with no wasted bits, warm-up,
    # precision - 1, shift, coefficients, residual method 0, po.
    lens = torch.tensor([8] + [bps] * O + [4, 5] + [precision] * O + [2, 4],
                        device=dev)
    rel = torch.cumsum(lens, 0) - lens
    col = lambda v: torch.full((F, 1), v, dtype=torch.int64, device=dev)
    vals = torch.cat([col((0b100000 | (O - 1)) << 1), x[:, :O],
                      col(precision - 1), shift[:, None], coefs, col(0),
                      po_f[:, None]], 1)
    buf.put(sub0[:, None] + rel, vals, lens.expand(F, -1))
    pos = torch.cumsum(cost, 1) - cost + (sub0 + head_bits)[:, None]
    buf.put(pos[starts], k[starts], torch.full_like(k[starts], 4))
    pos += 4 * starts + q
    buf.put(pos[valid], ((1 << k) | (u & ((1 << k) - 1)))[valid],
            (k + 1)[valid])
    out = buf.to_bytes()
    for f, h in enumerate(headers):
        out[fstart[f] : fstart[f] + hl[f]] = np.frombuffer(h, np.uint8)
    crc = crc_rows(out, fstart, flen - 2, CRC16, 16)
    out[fstart + flen - 2] = crc >> 8
    out[fstart + flen - 1] = crc & 0xFF
    return out, flen, po_f.cpu().numpy()


def streaminfo(block: int, sample_rate: int, channels: int, bps: int,
               n: int, md5: bytes) -> bytes:
    packed = (sample_rate << 44) | ((channels - 1) << 41) | ((bps - 1) << 36) | n
    return (block.to_bytes(2, "big") * 2 + bytes(6)
            + packed.to_bytes(8, "big") + md5)


def md5_of(pcm: np.ndarray, bps: int) -> bytes:
    """MD5 of the interleaved little-endian samples (16-bit)."""
    if bps != 16:
        raise ValueError("the generator writes 16-bit streams")
    return hashlib.md5(np.ascontiguousarray(pcm.T).astype("<i2").tobytes()
                       ).digest()


def file_bytes(pcm: np.ndarray, frames: bytes, cfg: dict) -> bytes:
    si = streaminfo(cfg["block_size"], cfg["sample_rate"], pcm.shape[0],
                    cfg["bits_per_sample"], pcm.shape[1],
                    md5_of(pcm, cfg["bits_per_sample"]))
    return b"fLaC" + bytes([0x80, 0, 0, len(si)]) + si + frames


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

FRAMES_PER_CHUNK = 2048


def make_pool(cfg: dict, n_streams: int, seed: int, device="cpu") -> list:
    """``n_streams`` distinct streams from ``seed``: the durations'
    quantile set in a seeded order, each stream its own AR source, the
    frames encoded on ``device``."""
    if cfg["channels"] != 1:
        raise ValueError("the FLAC generator writes mono streams")
    rng = np.random.default_rng(seed)
    secs = rng.permutation(durations(cfg, n_streams))
    B, prec = cfg["block_size"], cfg["lpc_precision"]
    srcs = []
    for s in secs:
        x, c = ar_source(rng, n_samples(cfg, float(s)), cfg)
        srcs.append((x,) + quantise(c, prec))
    # All frames of all streams, stream after stream, in chunks.
    rows = np.array([(si, f, st, min(B, len(x) - st))
                     for si, (x, _, _) in enumerate(srcs)
                     for f, st in enumerate(range(0, len(x), B))], np.int64)
    parts, lens = [], []
    for a in range(0, len(rows), FRAMES_PER_CHUNK):
        r = rows[a : a + FRAMES_PER_CHUNK]
        X = np.zeros((len(r), B), np.int64)
        for j, (si, _, st, b) in enumerate(r):
            X[j, :b] = srcs[si][0][st : st + b]
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out, flen, _ = encode_frames(
            t(X), t(r[:, 3]), t(np.stack([srcs[si][1] for si in r[:, 0]])),
            t(np.array([srcs[si][2] for si in r[:, 0]], np.int64)), prec,
            cfg["bits_per_sample"], r[:, 1], cfg["max_partition_order"])
        parts.append(out)
        lens.append(flen)
    allb = np.concatenate(parts)
    flen = np.concatenate(lens)
    fend = np.cumsum(flen)
    pool = []
    for si, (x, q, sh) in enumerate(srcs):
        idx = np.flatnonzero(rows[:, 0] == si)
        pcm = x[None, :]
        body = allb[fend[idx[0]] - flen[idx[0]] : fend[idx[-1]]].tobytes()
        pool.append(Stream(
            data=file_bytes(pcm, body, cfg), pcm=pcm,
            sample_rate=cfg["sample_rate"],
            seconds=len(x) / cfg["sample_rate"], blocks=rows[idx, 3],
            lpc=dict(coefs=q, shift=sh, precision=prec)))
    return pool
