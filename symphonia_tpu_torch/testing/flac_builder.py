"""A minimal FLAC *encoder* used to build bit-exact test fixtures.

Covers every decode path: constant / verbatim / fixed / LPC subframes,
Rice partitions (incl. escapes), stereo decorrelation modes, wasted bits,
and STREAMINFO MD5. Independent implementation (spec-driven) so decoder
tests are a genuine roundtrip, not a mirror of decoder code.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from ..core.checksum import crc8_buf, crc16_buf


class BitWriter:
    def __init__(self):
        self._acc = 0
        self._nbits = 0

    def write(self, val: int, n: int) -> None:
        assert 0 <= val < (1 << n) or n == 0
        self._acc = (self._acc << n) | val
        self._nbits += n

    def write_signed(self, val: int, n: int) -> None:
        self.write(val & ((1 << n) - 1), n)

    def write_unary_zeros(self, q: int) -> None:
        self.write(1, q + 1)

    def align(self) -> None:
        pad = (-self._nbits) % 8
        self.write(0, pad)

    def to_bytes(self) -> bytes:
        self.align()
        return self._acc.to_bytes(self._nbits // 8, "big") if self._nbits else b""


def _utf8_num(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    for n_extra in range(1, 7):
        total_bits = 6 * n_extra + (6 - n_extra)
        if n < (1 << total_bits):
            lead = (0xFF << (7 - n_extra)) & 0xFF
            lead |= n >> (6 * n_extra)
            parts = [lead]
            for i in range(n_extra - 1, -1, -1):
                parts.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(parts)
    raise ValueError("number too large for UTF-8 coding")


def _zigzag(v: np.ndarray) -> np.ndarray:
    return (v << 1) ^ (v >> 63)


def _pick_rice_param(u: np.ndarray) -> int:
    if len(u) == 0:
        return 0
    mean = max(1, int(u.mean()))
    p = max(0, mean.bit_length() - 1)
    return min(p, 14)


def _write_residual(
    bw: BitWriter,
    residual: np.ndarray,
    block_size: int,
    order: int,
    partition_order: int = 0,
    escape_parts: Sequence[int] = (),
) -> None:
    # Clamp to a legal partition order: block_size must split evenly and
    # partition 0 must still fit the warmup (spec: (bs >> po) << po == bs).
    while partition_order > 0 and (
        (block_size >> partition_order) << partition_order != block_size
        or (block_size >> partition_order) <= order
    ):
        partition_order -= 1
    bw.write(0, 2)  # method 0: 4-bit rice params
    bw.write(partition_order, 4)
    n_parts = 1 << partition_order
    part_len = block_size >> partition_order
    u_all = _zigzag(residual.astype(np.int64))
    pos = 0
    for p in range(n_parts):
        n = part_len - (order if p == 0 else 0)
        u = u_all[pos : pos + n]
        if p in escape_parts:
            raw_bits = max(2, int(np.abs(residual[pos : pos + n]).max()).bit_length() + 1) if n else 2
            raw_bits = min(raw_bits, 30)
            bw.write(0b1111, 4)
            bw.write(raw_bits, 5)
            for v in residual[pos : pos + n]:
                bw.write_signed(int(v), raw_bits)
        else:
            param = _pick_rice_param(u)
            bw.write(param, 4)
            for v in u:
                q = int(v) >> param
                bw.write_unary_zeros(q)
                if param:
                    bw.write(int(v) & ((1 << param) - 1), param)
        pos += n


FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def encode_subframe(
    bw: BitWriter,
    samples: np.ndarray,
    bps: int,
    kind: str = "auto",
    order: int = 2,
    lpc_coefs: Optional[Sequence[int]] = None,
    lpc_shift: int = 5,
    lpc_precision: int = 12,
    wasted: int = 0,
    partition_order: int = 0,
    escape_parts: Sequence[int] = (),
) -> None:
    x = samples.astype(np.int64)
    if wasted:
        assert np.all((x & ((1 << wasted) - 1)) == 0)
        x = x >> wasted
    eff_bps = bps - wasted

    def wasted_flag():
        if wasted:
            bw.write(1, 1)
            bw.write_unary_zeros(wasted - 1)
        else:
            bw.write(0, 1)

    n = len(x)
    if kind == "constant":
        bw.write(0, 1)
        bw.write(0b000000, 6)
        wasted_flag()
        bw.write_signed(int(x[0]), eff_bps)
        return
    if kind == "verbatim":
        bw.write(0, 1)
        bw.write(0b000001, 6)
        wasted_flag()
        for v in x:
            bw.write_signed(int(v), eff_bps)
        return
    if kind == "fixed":
        coefs = np.array(FIXED_COEFS[order], dtype=np.int64)
        bw.write(0, 1)
        bw.write(0b001000 | order, 6)
        wasted_flag()
        for v in x[:order]:
            bw.write_signed(int(v), eff_bps)
        res = np.empty(n - order, dtype=np.int64)
        for i in range(order, n):
            pred = sum(int(coefs[j]) * int(x[i - 1 - j]) for j in range(order))
            res[i - order] = int(x[i]) - pred
        _write_residual(bw, res, n, order, partition_order, escape_parts)
        return
    if kind == "lpc":
        coefs = np.array(lpc_coefs, dtype=np.int64)
        order = len(coefs)
        bw.write(0, 1)
        bw.write(0b100000 | (order - 1), 6)
        wasted_flag()
        for v in x[:order]:
            bw.write_signed(int(v), eff_bps)
        bw.write(lpc_precision - 1, 4)
        bw.write_signed(lpc_shift, 5)
        for c in coefs:
            bw.write_signed(int(c), lpc_precision)
        res = np.empty(n - order, dtype=np.int64)
        for i in range(order, n):
            acc = sum(int(coefs[j]) * int(x[i - 1 - j]) for j in range(order))
            res[i - order] = int(x[i]) - (acc >> lpc_shift)
        _write_residual(bw, res, n, order, partition_order, escape_parts)
        return
    raise ValueError(kind)


_SAMPLE_SIZE_CODES = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110, 32: 0b111}


def encode_frame(
    channels: List[np.ndarray],
    frame_number: int,
    bps: int,
    stereo_mode: str = "independent",
    **sf_kwargs,
) -> bytes:
    """Encode one frame. ``channels``: list of [block_size] int arrays."""
    block_size = len(channels[0])
    n_ch = len(channels)

    # Stereo decorrelation (encode side).
    subframe_data: List[tuple] = []  # (samples, extra_bit)
    if stereo_mode == "independent":
        ch_code = n_ch - 1
        subframe_data = [(c, 0) for c in channels]
    else:
        assert n_ch == 2
        l, r = channels[0].astype(np.int64), channels[1].astype(np.int64)
        side = l - r
        if stereo_mode == "left_side":
            ch_code = 0b1000
            subframe_data = [(l, 0), (side, 1)]
        elif stereo_mode == "right_side":
            ch_code = 0b1001
            subframe_data = [(side, 1), (r, 0)]
        elif stereo_mode == "mid_side":
            ch_code = 0b1010
            mid = (l + r) >> 1
            subframe_data = [(mid, 0), (side, 1)]
        else:
            raise ValueError(stereo_mode)

    # Header: sync + fixed blocking; blocksize via 16-bit trailer (0b0111);
    # sample rate from STREAMINFO (0b0000); explicit sample size.
    hdr = bytearray([0xFF, 0xF8])
    hdr.append((0b0111 << 4) | 0b0000)
    hdr.append((ch_code << 4) | (_SAMPLE_SIZE_CODES[bps] << 1))
    hdr += _utf8_num(frame_number)
    hdr += (block_size - 1).to_bytes(2, "big")
    hdr.append(crc8_buf(bytes(hdr)))

    bw = BitWriter()
    for samples, extra in subframe_data:
        encode_subframe(bw, np.asarray(samples), bps + extra, **sf_kwargs)
    body = bw.to_bytes()

    frame = bytes(hdr) + body
    crc = crc16_buf(frame)
    return frame + crc.to_bytes(2, "big")


def build_streaminfo(
    block_size: int, sample_rate: int, n_ch: int, bps: int, n_samples: int, md5: bytes
) -> bytes:
    out = bytearray()
    out += block_size.to_bytes(2, "big")
    out += block_size.to_bytes(2, "big")
    out += (0).to_bytes(3, "big")
    out += (0).to_bytes(3, "big")
    packed = (
        (sample_rate << 44) | ((n_ch - 1) << 41) | ((bps - 1) << 36) | n_samples
    )
    out += packed.to_bytes(8, "big")
    out += md5
    return bytes(out)


def md5_of(channels: List[np.ndarray], bps: int) -> bytes:
    inter = np.stack([c.astype(np.int64) for c in channels]).T.reshape(-1)
    nbytes = (bps + 7) // 8
    if nbytes == 1:
        raw = inter.astype(np.int8).tobytes()
    elif nbytes == 2:
        raw = inter.astype("<i2").tobytes()
    elif nbytes == 3:
        b = np.frombuffer(inter.astype("<i4").tobytes(), dtype=np.uint8).reshape(-1, 4)
        raw = b[:, :3].tobytes()
    else:
        raw = inter.astype("<i4").tobytes()
    return hashlib.md5(raw).digest()


def build_flac_file(
    channels: List[np.ndarray],
    sample_rate: int = 44100,
    bps: int = 16,
    block_size: int = 256,
    stereo_mode: str = "independent",
    extra_metadata_blocks: Sequence[bytes] = (),
    **sf_kwargs,
) -> bytes:
    """Assemble a complete FLAC file from planar int sample arrays."""
    n = len(channels[0])
    md5 = md5_of(channels, bps)
    si = build_streaminfo(block_size, sample_rate, len(channels), bps, n, md5)

    blocks = bytearray()
    is_last = not extra_metadata_blocks
    blocks.append((0x80 if is_last else 0x00) | 0)
    blocks += len(si).to_bytes(3, "big")
    blocks += si
    for i, mb in enumerate(extra_metadata_blocks):
        last = i == len(extra_metadata_blocks) - 1
        blocks.append((0x80 if last else 0x00) | mb[0])
        blocks += len(mb[1:]).to_bytes(3, "big")
        blocks += mb[1:]

    frames = bytearray()
    fnum = 0
    for start in range(0, n, block_size):
        chunk = [c[start : start + block_size] for c in channels]
        frames += encode_frame(chunk, fnum, bps, stereo_mode, **sf_kwargs)
        fnum += 1
    return b"fLaC" + bytes(blocks) + bytes(frames)


def random_walk(n: int, bps: int, seed: int, ch: int = 1) -> List[np.ndarray]:
    """Smooth-ish random signals that keep residuals small.

    A leaky integrator rather than a pure cumsum: a raw random walk's
    excursion grows as sqrt(n) and saturates the sample range, producing
    long constant (zero-residual) stretches with spikes at the clip
    boundaries — unrepresentative content with pathological Rice
    partitions. The leak keeps the signal AC and stationary, like audio."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    lim = (1 << (bps - 1)) - 1
    out = []
    for c in range(ch):
        steps = rng.integers(-200, 201, size=n).astype(np.float64)
        # x[i] = 0.999 * x[i-1] + step[i]  (stationary std ~ step_std * 22)
        x = lfilter([1.0], [1.0, -0.999], steps)
        x = np.clip(x, -lim, lim)
        out.append(x.astype(np.int64))
    return out
