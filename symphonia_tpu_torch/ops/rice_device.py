"""Device FLAC Rice entropy decode over independent lane cursors.

Port of ``symphonia_tpu/ops/rice_device.py``. Every symbol is a unary
prefix (count-leading-zeros of a 32-bit window) plus ``k`` remainder bits,
zig-zagged to a signed residual; ``B`` lanes decode ``n`` symbols each from
one shared big-endian bitstream.

Layout:
  words  [W]  the packed bitstream as big-endian 32-bit words (int32 or
              uint32 tensor holding the same bits; :func:`pack_bits_u32`)
  cur    [B]  absolute bit cursors
  param  [B]  per-lane Rice parameter k (0..31)
  n      symbols per lane: every lane decodes exactly n (the reference
         masks nothing, whatever its docstring says)

As in the reference, one symbol must fit a 32-bit window (unary quotient
+ 1 + k <= 32), the cursors wrap as uint32, and word reads past the end
clamp to the last word (XLA's gather clamps).

:func:`rice_decode_lanes` launches the hand-written kernel R1
``rice_decode`` (``csrc/rice_device.cu``) for CUDA tensors and runs its
plain twin :func:`rice_decode_lanes_plain` for CPU tensors. The numpy
stream builder and scalar oracle are the reference's (lines 33-37 and
77-120), copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build

_MASK32 = 0xFFFFFFFF


def pack_bits_u32(data: bytes) -> np.ndarray:
    """Bytes -> big-endian u32 words (padded)."""
    pad = (-len(data)) % 4
    a = np.frombuffer(data + b"\x00" * (pad + 8), dtype=">u4")
    return a.astype(np.uint32)


def _operands(words, cur, param):
    if words.dim() != 1 or words.numel() == 0 or words.element_size() != 4:
        raise ValueError("words must be a non-empty [W] tensor of 32-bit "
                         "words")
    if cur.dim() != 1 or param.shape != cur.shape:
        raise ValueError("cur and param must be [B] tensors")
    if words.dtype.is_floating_point:
        raise ValueError("words must be int32 or uint32")
    return words.view(torch.int32), cur.to(torch.int64), param.to(torch.int32)


def rice_decode_lanes_plain(words, cur, param, n: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of R1: the reference's ``lax.scan`` over ``n`` symbols as a
    Python loop, the lanes one int64 tensor masked to 32 bits. torch has no
    count-leading-zeros: for a window w, ``frexp(float64(w))``'s exponent
    is w's bit length (exact below 2**53; 0 for w == 0), so clz = 32 - it.
    Returns (residuals [B, n] int32, cursors after the last symbol [B]
    int64 in [0, 2**32))."""
    words, cur, param = _operands(words, cur, param)
    w64 = words.to(torch.int64) & _MASK32
    last = w64.numel() - 1
    c = cur & _MASK32
    k = param.to(torch.int64) & _MASK32
    rs = (32 - k) & 31

    def window(pos):
        wi = pos >> 5
        off = pos & 31
        hi = w64[wi.clamp(max=last)]
        lo = w64[(wi + 1).clamp(max=last)]
        return torch.where(off == 0, hi,
                           ((hi << off) | (lo >> ((32 - off) & 31)))
                           & _MASK32)

    out = torch.empty((cur.shape[0], n), dtype=torch.int32,
                      device=cur.device)
    for i in range(n):
        _, e = torch.frexp(window(c).to(torch.float64))
        q = 32 - e.to(torch.int64)
        c1 = (c + q + 1) & _MASK32
        r = torch.where(k == 0, 0, window(c1) >> rs)
        c = (c1 + k) & _MASK32
        u = torch.where(k >= 32, 0, (q << k.clamp(max=31)) & _MASK32) | r
        v = (u >> 1) ^ ((-(u & 1)) & _MASK32)
        out[:, i] = (v - ((v >> 31) << 32)).to(torch.int32)
    return out, c


def rice_decode_lanes(words, cur, param, n: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R1 wrapper: decode ``n`` Rice symbols per lane (the port of the
    reference's ``rice_decode_lanes``). Returns (residuals [B, n] int32,
    cursors after the last symbol [B]): the reference's uint32 cursors,
    wrapped, as int64 values."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if _build.device_type(cur) == "cpu":
        return rice_decode_lanes_plain(words, cur, param, n)
    words, cur, param = (t.contiguous()
                         for t in _operands(words, cur, param))
    dev = _build.require_cuda(words, cur, param)
    B = cur.shape[0]
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    cur_end = torch.empty(B, dtype=torch.int64, device=dev)
    if B:
        err = _build.lib().rice_decode_launch(
            words.data_ptr(), words.numel(), cur.data_ptr(), param.data_ptr(),
            out.data_ptr(), cur_end.data_ptr(), B, n, _build.stream_ptr(dev))
        _build.LAUNCHES["rice_decode"] += 1
        _build.check("rice_decode", err)
    return out, cur_end


def rice_decode_oracle(data: bytes, cur: np.ndarray, param: np.ndarray,
                       n: int) -> np.ndarray:
    """Scalar host oracle with identical semantics."""
    out = np.zeros((len(cur), n), np.int64)
    for l in range(len(cur)):
        pos = int(cur[l])
        k = int(param[l])
        for i in range(n):
            q = 0
            while not (data[pos >> 3] >> (7 - (pos & 7))) & 1:
                q += 1
                pos += 1
            pos += 1
            r = 0
            for _ in range(k):
                r = (r << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
                pos += 1
            u = (q << k) | r
            out[l, i] = (u >> 1) ^ -(u & 1)
    return out


def make_test_streams(B: int, n: int, k: int = 4, seed: int = 0):
    """B independent Rice-coded lanes packed into one bitstream
    (vectorized encoder: symbol bit positions by cumsum + packbits)."""
    rng = np.random.default_rng(seed)
    vals = rng.laplace(0.0, 6.0, size=(B, n)).astype(np.int64)
    flat = vals.reshape(-1)
    u = (flat << 1) ^ (flat >> 63)  # zigzag
    q = (u >> k).astype(np.int64)
    r = (u & ((1 << k) - 1)).astype(np.int64)
    lens = q + 1 + k
    starts = np.zeros(len(flat), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    total = int(starts[-1] + lens[-1])
    bits = np.zeros(total + 64, np.uint8)
    bits[starts + q] = 1  # unary terminator
    if k:
        rem_pos = (starts + q + 1)[:, None] + np.arange(k)[None, :]
        rem_bits = (r[:, None] >> np.arange(k - 1, -1, -1)[None, :]) & 1
        bits[rem_pos.reshape(-1)] = rem_bits.reshape(-1).astype(np.uint8)
    data = np.packbits(bits).tobytes()
    cursors = starts.reshape(B, n)[:, 0].copy()
    return data, cursors, vals
