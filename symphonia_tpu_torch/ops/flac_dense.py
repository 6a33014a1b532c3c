"""FLAC dense stage: batched predictor reconstruction, stereo decorrelation,
and STREAMINFO's MD5 of the decoded lanes.

PyTorch port of ``symphonia_tpu/ops/flac_dense.py``. Every subframe kind is
one integer-LPC recurrence per lane (constant/verbatim are order 0, fixed
order k is LPC with binomial coefficients and shift 0):

    x[n] = r[n]                                         n < order
    x[n] = r[n] + ((sum_{j<32} c_j * x[n-1-j]) >> shift)  otherwise

followed by ``x << wasted`` and, for stereo, undoing the channel
decorrelation. Residual rows are ``[L, stride]`` int32 with the warmup
samples in ``[0, order)``; ``stride`` may exceed the decoded length (the
native extraction pads rows by 16 columns).

Each public op is a wrapper: on CPU tensors it runs the plain PyTorch twin
here, on CUDA tensors it launches the hand-written kernel
(``csrc/flac_dense.cu``: F1 ``flac_lpc`` fuses the recurrence and the
wasted-bits shift, behind its helper ``flac_lane_order``, which counts each
lane's taps and sorts the lanes by them; F2 ``flac_decorrelate``; F3
``flac_md5``, one MD5 chain a stream over the lanes F1 and F2 wrote, which
the JAX package computes on the host instead) or raises. The 64-bit
accumulator is native int64 on both (the reference's 32-bit-limb
emulation, ``ops/i64emu.py``, existed only because the TPU has no int64).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .. import trace
from . import _build

MAX_ORDER = 32

# Fixed predictor coefficients, zero-padded (decoder.rs:663).
FIXED_COEFS_PAD = np.zeros((5, MAX_ORDER), dtype=np.int32)
for _k, _c in {1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}.items():
    FIXED_COEFS_PAD[_k, : len(_c)] = _c

# Channel assignment codes for the batch path.
ASSIGN_INDEPENDENT = 0
ASSIGN_LEFT_SIDE = 1
ASSIGN_RIGHT_SIDE = 2
ASSIGN_MID_SIDE = 3


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), explicitly."""
    return (v - (((v + (1 << 31)) >> 32) << 32)).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def lpc_reconstruct_plain(res: torch.Tensor, coefs: torch.Tensor,
                          order: torch.Tensor, shift: torch.Tensor,
                          n_samples: int) -> torch.Tensor:
    """Twin of F1's recurrence: a loop over samples, all lanes at once.

    The product sum is int64 (exact modulo 2^64, as the limb emulation),
    the shifted value truncates to int32, shifts outside [0, 31] predict 0
    (XLA's shift semantics), and the int32 add wraps."""
    L = res.shape[0]
    dev = res.device
    c_rev = coefs.to(torch.int64).flip(1)  # c_rev[31-j] multiplies x[n-1-j]
    sh = shift.to(torch.int64)
    sh_ok = (sh >= 0) & (sh <= 31)
    sh = sh.clamp(0, 31)
    order = order.to(torch.int64)
    r = res[:, :n_samples].to(torch.int64)
    # buf[:, n + 32] = x[n]; the 32 leading zeros are the initial history.
    buf = torch.zeros((L, n_samples + MAX_ORDER), dtype=torch.int64,
                      device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for n in range(n_samples):
        acc = (buf[:, n : n + MAX_ORDER] * c_rev).sum(1)
        pred = torch.where(sh_ok & (order <= n), acc >> sh, zero)
        # Wrapping once after the add equals the reference's truncate-then-
        # wrapping-add (both are the sum modulo 2^32).
        buf[:, n + MAX_ORDER] = _wrap_i32(r[:, n] + pred)
    return buf[:, MAX_ORDER:].to(torch.int32)


def apply_wasted_bits(x: torch.Tensor, wasted: torch.Tensor) -> torch.Tensor:
    """Twin of F1's epilogue: x << wasted per lane (decoder.rs:239-242),
    wrapping in 32 bits; shifts outside [0, 31] give 0 like XLA's."""
    w = wasted.to(torch.int64)[:, None]
    ok = (w >= 0) & (w <= 31)
    y = _wrap_i32(x.to(torch.int64) << w.clamp(0, 31))
    return torch.where(ok, y, torch.zeros((), dtype=torch.int32,
                                          device=x.device))


def decorrelate_plain(x: torch.Tensor, assignment: torch.Tensor
                      ) -> torch.Tensor:
    """Twin of F2 (decoder.rs:32-83) on [F, 2, n] int32; wrapping int32."""
    c0 = x[:, 0, :].to(torch.int64)
    c1 = x[:, 1, :].to(torch.int64)
    a = assignment[:, None]
    ls1 = _wrap_i32(c0 - c1)
    rs0 = _wrap_i32(c0 + c1)
    m2 = _wrap_i32((c0 << 1) | (c1 & 1)).to(torch.int64)
    ms0 = _wrap_i32(m2 + c1) >> 1
    ms1 = _wrap_i32(m2 - c1) >> 1
    x0, x1 = x[:, 0, :], x[:, 1, :]
    out0 = torch.where(a == ASSIGN_RIGHT_SIDE, rs0,
                       torch.where(a == ASSIGN_MID_SIDE, ms0, x0))
    out1 = torch.where(a == ASSIGN_LEFT_SIDE, ls1,
                       torch.where(a == ASSIGN_MID_SIDE, ms1, x1))
    return torch.stack([out0, out1], dim=1)


# F3's table and state (csrc/flac_dense.cu, flac_md5_kernel): a stream's
# table row is (first frame in the chunk, frames in the chunk, samples
# still to hash in the chunk, bytes a sample, flags, 0, 0, 0); its state
# row is (a, b, c, d, message bytes low and high word, 0, 0, then the 16
# words of the block that the bytes past the last whole block begin).
MD5_ROW = 8
MD5_STATE_WORDS = 24
MD5_FIRST = 1  # start from MD5's initial state
MD5_LAST = 2   # pad and finalize: a, b, c, d become the digest
_MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)
# RFC 1321: the constants, rotations and message word of each step.
MD5_K = tuple(int(abs(math.sin(i + 1)) * 2**32) & 0xFFFFFFFF
              for i in range(64))
MD5_S = ((7, 12, 17, 22) * 4 + (5, 9, 14, 20) * 4 + (4, 11, 16, 23) * 4
         + (6, 10, 15, 21) * 4)
MD5_G = tuple(i if i < 16 else (5 * i + 1) % 16 if i < 32
              else (3 * i + 5) % 16 if i < 48 else 7 * i % 16
              for i in range(64))
_M32 = 0xFFFFFFFF


def _md5_compress(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """MD5's compression of states h [S, 4] by blocks m [S, 16] (int64
    holding uint32 values), all streams at once."""
    a, b, c, d = h.unbind(1)
    for i in range(64):
        if i < 16:
            f = d ^ (b & (c ^ d))
        elif i < 32:
            f = c ^ (d & (b ^ c))
        elif i < 48:
            f = b ^ c ^ d
        else:
            f = c ^ (b | (~d & _M32))
        t = (a + f + MD5_K[i] + m[:, MD5_G[i]]) & _M32
        s = MD5_S[i]
        a, d, c = d, c, b
        b = (b + (((t << s) | (t >> (32 - s))) & _M32)) & _M32
    return (h + torch.stack([a, b, c, d], 1)) & _M32


def _le_bytes(v: torch.Tensor, width: int) -> torch.Tensor:
    """Each int32 of ``v`` [n] as ``width`` little-endian bytes -> uint8."""
    v = v.to(torch.int64)
    return torch.stack([(v >> (8 * k)) & 0xFF for k in range(width)],
                       1).reshape(-1).to(torch.uint8)


def md5_lanes_plain(x: torch.Tensor, table: torch.Tensor,
                    blocks: torch.Tensor, state: torch.Tensor) -> None:
    """Twin of F3: each stream's bytes of this chunk in the kernel's
    order (its frames in turn, each cut to the samples left, channels
    interleaved, ``width`` little-endian bytes a sample) after the bytes
    its state holds, padded where the row says last; the whole blocks
    compressed for all streams at once; ``state`` updated in place."""
    F = x.shape[0]
    rows = table.tolist()
    bl = blocks.tolist()
    live, msgs, heads, ends = [], [], [], []
    for k, (f0, nf, left, w, flags, *_) in enumerate(rows):
        if nf <= 0:
            continue
        if flags & MD5_FIRST:
            h, pos = torch.tensor(_MD5_INIT), 0
            parts = []
        else:
            st = state[k].to(torch.int64) & _M32
            h, pos = st[:4], int(st[4]) | int(st[5]) << 32
            parts = [_le_bytes(state[k, 8:], 4)[: pos % 64]]
        for f in range(f0, min(f0 + nf, F)):
            n = min(bl[f], left)
            left -= n
            parts.append(_le_bytes(x[f, :, :n].T.reshape(-1), w))
            pos += n * x.shape[1] * w
        msg = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
        if flags & MD5_LAST:
            pad = (55 - pos) % 64
            tail = bytes([0x80]) + bytes(pad) + (8 * pos).to_bytes(8, "little")
            msg = torch.cat([msg, torch.frombuffer(bytearray(tail),
                                                   dtype=torch.uint8)])
        live.append(k)
        msgs.append(msg)
        heads.append(h)
        ends.append((pos, flags))
    if not live:
        return
    nb = [m.numel() // 64 for m in msgs]
    B = max(nb)
    words = torch.zeros((len(live), max(B, 1), 16), dtype=torch.int64)
    for r, m in enumerate(msgs):
        q = m[: 64 * nb[r]].to(torch.int64).reshape(-1, 4)
        words[r, : nb[r]] = (q[:, 0] | q[:, 1] << 8 | q[:, 2] << 16
                             | q[:, 3] << 24).reshape(-1, 16)
    h = torch.stack(heads)
    nbt = torch.tensor(nb)
    for j in range(B):
        h = torch.where((j < nbt)[:, None], _md5_compress(h, words[:, j]), h)
    for r, k in enumerate(live):
        pos, flags = ends[r]
        out = torch.zeros(MD5_STATE_WORDS, dtype=torch.int64)
        out[:4] = h[r]
        if not flags & MD5_LAST:
            out[4], out[5] = pos & _M32, pos >> 32
            rest = msgs[r][64 * nb[r]:]
            ring = torch.zeros(64, dtype=torch.int64)
            ring[: rest.numel()] = rest.to(torch.int64)
            q = ring.reshape(16, 4)
            out[8:] = q[:, 0] | q[:, 1] << 8 | q[:, 2] << 16 | q[:, 3] << 24
        else:
            out[4:] = state[k, 4:].to(torch.int64) & _M32
        state[k] = _wrap_i32(out)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def active_taps(coefs: torch.Tensor) -> torch.Tensor:
    """int32 [L]: 32 less the trailing zero coefficients of each row of
    ``coefs`` [L, 32]. The recurrence multiplies all 32 coefficients
    whatever ``order`` says, so this, not ``order``, is the number of taps a
    lane needs for a result equal to the full sum, for any input."""
    idx = torch.arange(1, MAX_ORDER + 1, dtype=torch.int32,
                       device=coefs.device)
    return ((coefs != 0).to(torch.int32) * idx).amax(dim=1)


def lane_permutation(taps: torch.Tensor) -> torch.Tensor:
    """int32 [L]: the lanes ordered by tap count, most taps first, so that
    the lanes of a warp need alike tap counts and the longest warps start
    first. No row is moved: F1 reads and writes rows through this index."""
    return torch.argsort(taps, descending=True).to(torch.int32)


def lane_order(coefs: torch.Tensor) -> tuple:
    """(taps, perm) of ``coefs`` [L, 32] int32, both int32 [L]:
    :func:`active_taps` and a :func:`lane_permutation` of it. On CUDA
    tensors F1's helper ``flac_lane_order`` (two small kernels behind one C
    entry point) computes both; its order within one tap count may differ
    from the twin's, and F1's result does not depend on it. On CPU tensors
    the two plain functions do."""
    if _build.device_type(coefs) == "cpu":
        taps = active_taps(coefs)
        return taps, lane_permutation(taps)
    dev = _build.require_cuda(coefs)
    if coefs.dim() != 2 or coefs.shape[1] != MAX_ORDER or (
            coefs.dtype != torch.int32):
        raise ValueError("coefs must be int32 [L, 32]")
    L = coefs.shape[0]
    taps = torch.empty(L, dtype=torch.int32, device=dev)
    perm = torch.empty(L, dtype=torch.int32, device=dev)
    # Per-block counts of each tap count (33 for every 256 lanes).
    scratch = torch.empty((L + 255) // 256 * (MAX_ORDER + 1),
                          dtype=torch.int32, device=dev)
    err = _build.lib().flac_lane_order_launch(
        coefs.data_ptr(), taps.data_ptr(), perm.data_ptr(),
        scratch.data_ptr(), L, _build.stream_ptr(dev))
    _build.LAUNCHES["flac_lane_order"] += 1
    _build.check("flac_lane_order", err)
    return taps, perm


def lane_parts(L: int) -> int:
    """Threads that share a lane's taps in F1 (2 or 4): four where there
    are few lanes, so that each warp scheduler of the card (132 SMs of 4)
    has about two warps to switch between. On the H100 two threads a lane
    won at 16384 lanes and above, four at 8192 and below."""
    return 4 if L <= 12288 else 2


def lpc_reconstruct_batch(res: torch.Tensor, coefs: torch.Tensor,
                          order: torch.Tensor, shift: torch.Tensor,
                          n_samples: int,
                          wasted: torch.Tensor | None = None, *,
                          parts: int | None = None) -> torch.Tensor:
    """Reconstruct ``n_samples`` samples per lane -> int32 [L, n_samples],
    then apply ``wasted`` (None: no shift). res [L, stride >= n_samples]
    with unit column stride; coefs [L, 32]; order/shift/wasted [L].
    ``parts`` (CUDA only) overrides :func:`lane_parts`."""
    if res.dim() != 2 or res.shape[1] < n_samples or res.stride(1) != 1:
        raise ValueError("res must be [L, stride >= n_samples], unit "
                         "column stride")
    if _build.device_type(res) == "cpu":
        x = lpc_reconstruct_plain(res, coefs, order, shift, n_samples)
        return x if wasted is None else apply_wasted_bits(x, wasted)
    L = res.shape[0]
    coefs = coefs.to(torch.int32).contiguous()
    order = order.to(torch.int32).contiguous()
    shift = shift.to(torch.int32).contiguous()
    wasted = (torch.zeros(L, dtype=torch.int32, device=res.device)
              if wasted is None else wasted.to(torch.int32).contiguous())
    if (coefs.shape != (L, MAX_ORDER) or res.dtype != torch.int32
            or any(t.shape != (L,) for t in (order, shift, wasted))):
        raise ValueError("res int32 [L, stride], coefs [L, 32], "
                         "order/shift/wasted [L]")
    dev = _build.require_cuda(coefs, order, shift, wasted)
    if res.device != dev:
        raise ValueError("res and lane parameters on different devices")
    parts = lane_parts(L) if parts is None else parts
    if parts not in (2, 4):
        raise ValueError("parts must be 2 or 4")
    out = torch.empty((L, n_samples), dtype=torch.int32, device=dev)
    taps, perm = lane_order(coefs)
    lib = _build.lib()
    err = lib.flac_lpc_launch(
        res.data_ptr(), res.stride(0), coefs.data_ptr(), order.data_ptr(),
        shift.data_ptr(), wasted.data_ptr(), perm.data_ptr(),
        taps.data_ptr(), out.data_ptr(), L, n_samples, parts,
        _build.stream_ptr(dev))
    _build.LAUNCHES["flac_lpc"] += 1
    _build.check("flac_lpc", err)
    return out


def decorrelate_batch(x: torch.Tensor, assignment: torch.Tensor
                      ) -> torch.Tensor:
    """Undo stereo decorrelation on [F, 2, n] given per-frame codes [F].
    Frames with other codes pass through."""
    if x.dim() != 3 or x.shape[1] != 2 or x.dtype != torch.int32:
        raise ValueError("x must be int32 [F, 2, n]")
    if _build.device_type(x) == "cpu":
        return decorrelate_plain(x, assignment)
    x = x.contiguous()
    assignment = assignment.to(torch.int32).contiguous()
    dev = _build.require_cuda(x, assignment)
    F, _, n = x.shape
    if assignment.shape != (F,):
        raise ValueError("assignment must be [F]")
    out = torch.empty_like(x)
    lib = _build.lib()
    err = lib.flac_decorrelate_launch(x.data_ptr(), assignment.data_ptr(),
                                      out.data_ptr(), F, n,
                                      _build.stream_ptr(dev))
    _build.LAUNCHES["flac_decorrelate"] += 1
    _build.check("flac_decorrelate", err)
    return out


def md5_lanes(x: torch.Tensor, table: torch.Tensor, blocks: torch.Tensor,
              state: torch.Tensor) -> None:
    """F3: advance each stream's MD5 ``state`` [S, 24] int32 over its
    samples in the decoded lanes ``x`` [F, C, n_max] int32, as its row of
    ``table`` [S, 8] int32 says (:data:`MD5_ROW`); ``blocks`` [F] int32
    holds each frame's block size. A row flagged :data:`MD5_LAST` leaves
    the stream's digest in its state's first four words. In place, on
    ``state``'s device."""
    S = state.shape[0] if state.dim() == 2 else -1
    if (x.dim() != 3 or x.dtype != torch.int32
            or table.shape != (S, MD5_ROW) or table.dtype != torch.int32
            or blocks.shape != (x.shape[0],) or blocks.dtype != torch.int32
            or state.shape != (S, MD5_STATE_WORDS)
            or state.dtype != torch.int32):
        raise ValueError("x int32 [F, C, n], table int32 [S, 8], blocks "
                         "int32 [F], state int32 [S, 24]")
    if _build.device_type(x) == "cpu":
        if any(t.device != x.device for t in (table, blocks, state)):
            raise ValueError("F3's tensors on different devices")
        return md5_lanes_plain(x, table, blocks, state)
    dev = _build.require_cuda(x, table, blocks, state)
    F, C, n_max = x.shape
    err = _build.lib().flac_md5_launch(
        x.data_ptr(), table.data_ptr(), blocks.data_ptr(), state.data_ptr(),
        S, F, C, n_max, _build.stream_ptr(dev))
    _build.LAUNCHES["flac_md5"] += 1
    _build.check("flac_md5", err)


class LaneMd5:
    """The STREAMINFO MD5 of several streams of one merged dispatch,
    computed by F3 from each lane chunk's output.

    Stream k's frames lie in runs of the merged order, in stream order:
    ``frames[k][r]`` consecutive frames from ``first[k][r]`` (one run a
    stream where ``first`` and ``frames`` are flat; a run may be empty).
    Its message is the first ``n_hash[k]`` samples of each channel,
    ``width[k]`` bytes a sample; ``blocks`` holds every merged frame's
    block size. Each chunk of frames [i, j), in which each stream's frames
    form one run, sends :meth:`table` up with its lanes, and :meth:`update`
    queues F3 on the chunk's output; the chunk that holds a stream's last
    frame finalizes it, and :meth:`digests` brings the digests back."""

    def __init__(self, first, frames, n_hash, width, blocks, device):
        self.first, self.frames = (
            a[:, None] if a.ndim == 1 else a
            for a in (np.asarray(v, np.int64) for v in (first, frames)))
        self.n_hash = np.asarray(n_hash, np.int64)
        self.width = np.asarray(width, np.int64)
        self.total = self.frames.sum(1)
        if (np.any(self.frames < 0) or np.any(self.total <= 0)
                or np.any(self.n_hash < 0)
                or np.any((self.width < 1) | (self.width > 4))):
            raise ValueError("each stream needs a frame, n_hash >= 0 and "
                             "1 to 4 bytes a sample")
        self.blocks = np.asarray(blocks, np.int32)
        self.cum = np.concatenate([[0], np.cumsum(self.blocks,
                                                  dtype=np.int64)])
        # The stream's frames and samples before each of its runs.
        n = self.cum[self.first + self.frames] - self.cum[self.first]
        self.frames_before = np.cumsum(self.frames, 1) - self.frames
        self.samples_before = np.cumsum(n, 1) - n
        self.state = torch.empty((len(self.first), MD5_STATE_WORDS),
                                 dtype=torch.int32, device=device)
        self.row_bytes = np.zeros(len(self.first), np.int64)

    def table(self, i: int, j: int) -> np.ndarray:
        """int32 [8 S + j - i]: the streams' rows for the chunk of frames
        [i, j), then the chunk's block sizes. Keeps each row's bytes a
        channel in :attr:`row_bytes` for :meth:`update`'s counters."""
        lo = np.clip(self.first, i, j)
        hi = np.clip(self.first + self.frames, i, j)
        live = hi > lo
        if np.any(live.sum(1) > 1):
            raise ValueError("a stream's frames in a chunk must be one run")
        r = live.argmax(1)[:, None]

        def run(a):
            return np.take_along_axis(a, r, 1)[:, 0]

        first, lo, hi = run(self.first), run(lo), run(hi)
        cum, n_hash = self.cum, self.n_hash
        done = run(self.samples_before) - cum[first]
        n = (np.minimum(n_hash, done + cum[hi])
             - np.minimum(n_hash, done + cum[lo]))
        f0 = run(self.frames_before) + lo - first
        rows = np.zeros((len(n_hash), MD5_ROW), np.int32)
        rows[:, 0] = lo - i
        rows[:, 1] = hi - lo
        rows[:, 2] = n
        rows[:, 3] = self.width
        rows[:, 4] = (hi > lo) * (MD5_FIRST * (f0 == 0) + MD5_LAST
                                  * (f0 + hi - lo == self.total))
        self.row_bytes = n * self.width
        return np.concatenate([rows.reshape(-1), self.blocks[i:j]])

    def update(self, x: torch.Tensor, table: torch.Tensor) -> None:
        """Queue F3 on a chunk's output ``x`` [j - i, C, n_max] with that
        chunk's :meth:`table`, on its device. Counted from the table: the
        bytes its rows hash as ``md5_card_bytes``, its largest row's (the
        chain that the launch runs for) as ``md5_chain_bytes``."""
        rows = MD5_ROW * len(self.n_hash)
        md5_lanes(x, table[:rows].view(-1, MD5_ROW), table[rows:],
                  self.state)
        if trace.enabled():
            b = self.row_bytes * x.shape[1]
            trace.count("md5_card_bytes", int(b.sum()))
            trace.count("md5_chain_bytes", int(b.max()))

    def digests(self) -> List[bytes]:
        """Every stream's 16-byte digest, once its last chunk has run."""
        d = trace.to_host(self.state[:, :4]).astype("<i4")
        return [r.tobytes() for r in d]


# ---------------------------------------------------------------------------
# Host-side packing (numpy) and the device pipeline
# ---------------------------------------------------------------------------


def pack_parsed_frames(frames, n_max: int | None = None):
    """Pack a list of ``codecs.flac.ParsedFrame`` into the batch tensors.

    Returns a dict of numpy arrays: res [L, n_max], coefs [L, 32],
    order/shift/wasted [L], block sizes, assignment codes [F] and per-frame
    bps. Lanes are frame-major (lane = f * C + c) with C = max channel
    count in the batch. Same layout as the reference's packer
    (``symphonia_tpu/ops/flac_dense.py``), written here because that module
    runs the JAX programs."""
    from ..codecs.flac import (SF_CONSTANT, SF_FIXED, SF_LPC,
                                           SF_VERBATIM)
    from ..common.flac import (CHANNELS_LEFT_SIDE,
                                           CHANNELS_MID_SIDE,
                                           CHANNELS_RIGHT_SIDE)

    F = len(frames)
    C = max(f.header.n_channels for f in frames)
    if n_max is None:
        n_max = max(f.header.block_size for f in frames)
    L = F * C
    res = np.zeros((L, n_max), dtype=np.int32)
    coefs = np.zeros((L, MAX_ORDER), dtype=np.int32)
    order = np.zeros(L, dtype=np.int32)
    shift = np.zeros(L, dtype=np.int32)
    wasted = np.zeros(L, dtype=np.int32)
    block = np.zeros(F, dtype=np.int32)
    assign = np.zeros(F, dtype=np.int32)
    bps = np.zeros(F, dtype=np.int32)
    amap = {
        CHANNELS_LEFT_SIDE: ASSIGN_LEFT_SIDE,
        CHANNELS_RIGHT_SIDE: ASSIGN_RIGHT_SIDE,
        CHANNELS_MID_SIDE: ASSIGN_MID_SIDE,
    }
    for fi, fr in enumerate(frames):
        bs = fr.header.block_size
        block[fi] = bs
        assign[fi] = amap.get(fr.header.channel_assignment, ASSIGN_INDEPENDENT)
        bps[fi] = fr.bits_per_sample
        for ci, sf in enumerate(fr.subframes):
            ln = fi * C + ci
            wasted[ln] = sf.wasted_bits
            if sf.kind in (SF_CONSTANT, SF_VERBATIM):
                res[ln, :bs] = (sf.constant if sf.kind == SF_CONSTANT
                                else sf.verbatim)
            elif sf.kind in (SF_FIXED, SF_LPC):
                k = sf.order
                order[ln] = k
                if sf.kind == SF_FIXED:
                    coefs[ln] = FIXED_COEFS_PAD[k]
                else:
                    shift[ln] = sf.shift
                    coefs[ln, :k] = sf.coefs
                res[ln, :k] = sf.warmup
                res[ln, k:bs] = sf.residuals
    return {
        "res": res, "coefs": coefs, "order": order, "shift": shift,
        "wasted": wasted, "block": block, "assign": assign, "bps": bps,
        "F": F, "C": C, "n_max": n_max,
    }


def decode_packed(packed, device, md5: LaneMd5 | None = None) -> np.ndarray:
    """Run the dense stage on packed numpy tensors on ``device`` ->
    int32 [F, C, n_max] numpy: every lane array to the device in one
    ``h2d`` span, the launches, then the result back. With ``md5``,
    ``packed["md5_table"]`` (the chunk's :meth:`LaneMd5.table`) goes up
    with the lanes, and F3 is queued on the lanes once they are back, so
    that it runs while the host stitches them. Counted from the packed
    shapes: F1's lanes and lane samples (L x n_max) as ``flac_lanes`` and
    ``flac_lane_samples``, F2's frames and frame samples (F x n_max) as
    ``flac_stereo_frames`` and ``flac_stereo_samples``."""
    n_max = int(packed["n_max"])
    F, C = int(packed["F"]), int(packed["C"])
    if trace.enabled():
        trace.count("flac_lanes", F * C)
        trace.count("flac_lane_samples", F * C * n_max)
        if C == 2:
            trace.count("flac_stereo_frames", F)
            trace.count("flac_stereo_samples", F * n_max)
    keys = ("res", "coefs", "order", "shift", "wasted")
    keys += ("assign",) if C == 2 else ()
    keys += ("md5_table",) if md5 is not None else ()
    t = dict(zip(keys, trace.to_device(torch.device(device),
                                       *(packed[k] for k in keys))))
    with trace.span("enqueue"):
        x = lpc_reconstruct_batch(t["res"], t["coefs"], t["order"],
                                  t["shift"], n_max, wasted=t["wasted"])
        x = x.reshape(F, C, n_max)
        if C == 2:
            x = decorrelate_batch(x, t["assign"])
    out = trace.to_host(x)
    if md5 is not None:
        with trace.span("enqueue"):
            md5.update(x, t["md5_table"])
    return out
