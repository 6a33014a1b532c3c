"""ALAC (Apple Lossless) decoder.

Analog of symphonia-codec-alac (``AlacDecoder``, lib.rs:268): magic-cookie
config (symphonia-common apple/audio/alac.rs), SCE/CPE element loop
(lib.rs:471-604), adaptive Rice residual decoding with zero-run signalling
(lib.rs:112-163, lg3a/read_rice_code lib.rs:606-657), the adaptive FIR
predictor with sign-driven coefficient updates (lib.rs:165-267), mid-side
decorrelation (lib.rs:664), shifted tail bits, and uncompressed frames.
Bit-exact; all arithmetic wraps at 32 bits like the reference.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.audio import AudioBuffer, AudioSpec, Channels
from ..core.codecs import (
    CODEC_ID_ALAC,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
)
from ..core.errors import DecodeError, EndOfStream
from ..core.io.bits import BitReaderLtr
from ..core.packet import Packet
from .. import native as _native_mod


def _wrap32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def _clip_msbs(val: int, num: int) -> int:
    """(val << num) >> num with 32-bit wrapping semantics."""
    return _wrap32(val << num) >> num


@dataclass
class MagicCookie:
    frame_length: int
    compatible_version: int
    bit_depth: int
    pb: int
    mb: int
    kb: int
    num_channels: int
    max_run: int
    max_frame_bytes: int
    avg_bit_rate: int
    sample_rate: int

    @staticmethod
    def read(buf: bytes) -> "MagicCookie":
        # Skip an optional atom wrapper ('frma'/'alac' headers).
        if len(buf) >= 12 and buf[4:8] == b"frma":
            buf = buf[12:]
        if len(buf) >= 12 and buf[4:8] == b"alac":
            buf = buf[12:]
        if len(buf) < 24:
            raise DecodeError("ALAC magic cookie too small")
        (frame_length, version, bit_depth, pb, mb, kb, n_ch, max_run,
         max_frame_bytes, avg_rate, sample_rate) = struct.unpack(
            ">IBBBBBBHIII", buf[:24]
        )
        if version != 0:
            raise DecodeError("unsupported ALAC version")
        if not 1 <= bit_depth <= 32:
            raise DecodeError("invalid ALAC bit depth")
        if not 1 <= n_ch <= 8:
            raise DecodeError("invalid ALAC channel count")
        if frame_length > 4096 * 16:
            raise DecodeError("ALAC frame length too large")
        return MagicCookie(frame_length, version, bit_depth, pb, mb, kb,
                           n_ch, max_run, max_frame_bytes, avg_rate,
                           sample_rate)


def lg3a(val: int) -> int:
    return 31 - _leading_zeros32((val >> 9) + 3)


def _leading_zeros32(v: int) -> int:
    return 32 - v.bit_length() if v else 32


def read_rice_code(br: BitReaderLtr, k: int, bps: int) -> int:
    """ALAC's modified Rice read (lib.rs:612-657)."""
    prefix = 0
    while prefix <= 8:
        if br.read_bits(1) == 0:
            break
        prefix += 1
    else:
        return br.read_bits(bps)
    if prefix > 8:
        return br.read_bits(bps)
    if k > 1:
        value = (prefix << k) - prefix
        suffix = br.read_bits(k - 1)
        if suffix > 0:
            return value + (suffix << 1) + br.read_bits(1) - 1
        return value
    if k == 1:
        return prefix
    return 0


def rice_to_signed(val: int) -> int:
    return (val >> 1) ^ -(val & 1)


class ElementChannel:
    def __init__(self, br: BitReaderLtr, config: MagicCookie, bps: int):
        self.bps = bps
        self.kb = config.kb
        self.mb = config.mb
        self.mode = br.read_bits(4)
        self.shift = br.read_bits(4)
        self.pb_factor = (br.read_bits(3) * config.pb) >> 2
        self.lpc_order = br.read_bits(5)
        self.coeffs = [br.read_bits_signed(16) for _ in range(self.lpc_order)]
        if 0 < self.mode < 15:
            raise DecodeError("invalid ALAC prediction mode")

    def read_residuals(self, br: BitReaderLtr, out: np.ndarray) -> None:
        mb = self.mb
        sign_toggle = 0
        zero_run_end = 0
        n = len(out)
        for i in range(n):
            if i < zero_run_end:
                continue
            k = lg3a(mb)
            val = (read_rice_code(br, min(k, self.kb), self.bps) + sign_toggle) & 0xFFFFFFFF
            out[i] = rice_to_signed(val)
            if val > 0xFFFF:
                mb = 0xFFFF
            else:
                mb = (mb + self.pb_factor * val - ((self.pb_factor * mb) >> 9)) & 0xFFFFFFFF
            sign_toggle = 0
            if mb < 128 and i + 1 < n:
                k = _leading_zeros32(mb) - 24 + ((mb + 16) >> 6)
                zeros = read_rice_code(br, min(k, self.kb), 16)
                if zeros < 0xFFFF:
                    sign_toggle = 1
                mb = 0
                zero_run_end = i + 1 + zeros

    def predict(self, out: np.ndarray) -> None:
        if self.lpc_order == 0 or len(out) == 0:
            return
        clip = 32 - self.bps
        n = len(out)
        o = out  # int64 numpy array holding 32-bit values
        if self.lpc_order == 31 or self.mode == 15:
            for i in range(1, n):
                o[i] = _clip_msbs(int(o[i]) + int(o[i - 1]), clip)
        order = self.lpc_order
        coeffs = self.coeffs  # list, c[0] is for the most-distant lag
        for i in range(1, min(1 + order, n)):
            o[i] = _clip_msbs(int(o[i]) + int(o[i - 1]), clip)
        shift = self.shift
        round_add = (1 << shift) >> 1
        for i in range(1 + order, n):
            res = int(o[i])
            past0 = int(o[i - order - 1])
            # FIR over the window with coefficients reversed
            # (coeffs[..order].rev() zips with out[i-order..i]).
            acc = 0
            base = i - order
            for j in range(order):
                acc = _wrap32(acc + _wrap32(coeffs[order - 1 - j] * _wrap32(int(o[base + j]) - past0)))
            val = _wrap32(acc + round_add) >> shift
            o[i] = _clip_msbs(_wrap32(res + past0 + val), clip)
            if res != 0:
                if res > 0:
                    for j in range(order):
                        s = int(o[base + j])
                        d = past0 - s
                        sign = (d > 0) - (d < 0)
                        coeffs[order - 1 - j] -= sign
                        res -= (1 + j) * ((sign * d) >> shift)
                        if res <= 0:
                            break
                else:
                    for j in range(order):
                        s = int(o[base + j])
                        d = past0 - s
                        sign = (d > 0) - (d < 0)
                        coeffs[order - 1 - j] += sign
                        res -= (1 + j) * ((-sign * d) >> shift)
                        if res >= 0:
                            break


def decorrelate_mid_side(out0: np.ndarray, out1: np.ndarray, weight: int, shift: int) -> None:
    for i in range(len(out0)):
        a = _wrap32(int(out0[i]) + int(out1[i]) - ((_wrap32(int(out1[i]) * weight)) >> shift))
        b = _wrap32(a - int(out1[i]))
        out0[i] = a
        out1[i] = b


# ALAC channel maps (lib.rs map_channels): decode order -> output plane.
_CHANNEL_MAPS = {
    1: [0], 2: [0, 1], 3: [2, 0, 1], 4: [2, 0, 1, 3], 5: [2, 0, 1, 3, 4],
    6: [2, 0, 1, 4, 5, 3], 7: [2, 0, 1, 5, 6, 4, 3], 8: [2, 4, 5, 0, 1, 6, 7, 3],
}


class AlacDecoder(AudioDecoder):
    """ALAC audio decoder (codec-alac lib.rs:268). ``params.extra_data``
    carries the magic cookie."""

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if not params.extra_data:
            raise DecodeError("ALAC requires magic cookie extra data")
        self.config = MagicCookie.read(params.extra_data)
        self.spec = AudioSpec(
            self.config.sample_rate, Channels.from_count(self.config.num_channels)
        )

    @staticmethod
    def supported_codecs() -> List[str]:
        return [CODEC_ID_ALAC]

    def decode(self, packet: Packet) -> AudioBuffer:
        cfg = self.config
        # Native fast path (native/alac_decode.cpp, bit-exact mirror): the
        # adaptive predictor is sample-sequential with data-dependent
        # coefficient updates, so it stays scalar host code; C++ restores
        # reference-parity throughput. Any error status falls back to this
        # Python decoder so malformed-input behavior is identical.
        pcm_native = _native_mod.alac_decode(
            bytes(packet.data), cfg, _CHANNEL_MAPS[cfg.num_channels])
        if pcm_native is not None:
            buf = AudioBuffer.from_array(
                pcm_native, self.spec, bits_per_sample=cfg.bit_depth)
            buf.trim(packet.trim_start, packet.trim_end)
            self._last = buf
            return buf

        br = BitReaderLtr(packet.data)
        chmap = _CHANNEL_MAPS[cfg.num_channels]
        out = np.zeros((cfg.num_channels, cfg.frame_length), dtype=np.int64)
        next_ch = 0
        num_frames = 0
        while True:
            tag = br.read_bits(3)
            if tag == 7:  # END
                break
            if tag in (0, 3):  # SCE / LFE
                num_frames = self._decode_element(
                    br, out[chmap[next_ch]], None
                )
                next_ch += 1
            elif tag == 1:  # CPE
                if next_ch + 2 > cfg.num_channels:
                    break
                num_frames = self._decode_element(
                    br, out[chmap[next_ch]], out[chmap[next_ch + 1]]
                )
                next_ch += 2
            elif tag == 4:  # DSE
                br.read_bits(4)
                align = br.read_bits(1)
                count = br.read_bits(8)
                if count == 255:
                    count += br.read_bits(8)
                if align:
                    br.realign()
                br.ignore_bits(8 * count)
            elif tag == 6:  # FIL
                count = br.read_bits(4)
                if count == 15:
                    count += br.read_bits(8) - 1
                br.ignore_bits(8 * count)
            else:  # CCE / PCE
                raise DecodeError("unsupported ALAC element")
            if next_ch >= cfg.num_channels:
                break
        pcm = out[:, :num_frames].astype(np.int32)
        buf = AudioBuffer.from_array(pcm, self.spec, bits_per_sample=cfg.bit_depth)
        buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf

    def _decode_element(
        self, br: BitReaderLtr, out0: np.ndarray, out1: Optional[np.ndarray]
    ) -> int:
        cfg = self.config
        is_cpe = out1 is not None
        br.read_bits(4)  # element instance tag
        if br.read_bits(12) != 0:
            raise DecodeError("ALAC unused header bits not zero")
        is_partial = bool(br.read_bits(1))
        shift = 8 * br.read_bits(2)
        is_uncompressed = bool(br.read_bits(1))
        if shift >= 24 or shift >= cfg.bit_depth:
            raise DecodeError("invalid ALAC shift")
        num_samples = br.read_bits(32) if is_partial else cfg.frame_length
        if num_samples > cfg.frame_length:
            raise DecodeError("ALAC frame too long")

        if not is_uncompressed:
            bps = cfg.bit_depth - shift + (1 if is_cpe else 0)
            if bps > 32:
                raise DecodeError("ALAC bps exceeds 32")
            ms_shift = br.read_bits(8)
            ms_weight = br.read_bits_signed(8)
            if not is_cpe and (ms_shift or ms_weight):
                raise DecodeError("ALAC mono element with mixing info")
            elem0 = ElementChannel(br, cfg, bps)
            elem1 = ElementChannel(br, cfg, bps) if is_cpe else None
            tail = None
            if shift > 0:
                count = (2 if is_cpe else 1) * num_samples
                tail = [br.read_bits(shift) for _ in range(count)]
            elem0.read_residuals(br, out0[:num_samples])
            elem0.predict(out0[:num_samples])
            if is_cpe:
                elem1.read_residuals(br, out1[:num_samples])
                elem1.predict(out1[:num_samples])
                if ms_weight != 0:
                    if ms_shift > 31:
                        raise DecodeError("ALAC ms_shift too large")
                    decorrelate_mid_side(out0[:num_samples], out1[:num_samples],
                                         ms_weight, ms_shift)
            if shift > 0:
                if is_cpe:
                    t = np.asarray(tail, dtype=np.int64).reshape(-1, 2)
                    out0[:num_samples] = (out0[:num_samples] << shift) | t[:, 0]
                    out1[:num_samples] = (out1[:num_samples] << shift) | t[:, 1]
                else:
                    t = np.asarray(tail, dtype=np.int64)
                    out0[:num_samples] = (out0[:num_samples] << shift) | t
        else:
            if is_cpe:
                for i in range(num_samples):
                    out0[i] = br.read_bits_signed(cfg.bit_depth)
                    out1[i] = br.read_bits_signed(cfg.bit_depth)
            else:
                for i in range(num_samples):
                    out0[i] = br.read_bits_signed(cfg.bit_depth)
        return num_samples
