"""FLAC decoder.

Analog of symphonia-bundle-flac/src/decoder.rs (``FlacDecoder``,
decoder.rs:85): frame header -> per-channel subframes (Constant / Verbatim /
Fixed / LPC, decoder.rs:341) -> Rice-partitioned residuals
(decoder.rs:513-660) -> predictor reconstruction (decoder.rs:663,716) ->
stereo decorrelation (decoder.rs:32-83) -> optional MD5 validation
(validate.rs:18-126). Bit-exact.

Structure is two-phase to serve the batch pipeline (SURVEY.md §7):

* ``parse_frame`` — entropy stage: bitstream -> ``ParsedFrame`` holding
  residual arrays + subframe metadata. This is the part the native C++
  pre-scan / Pallas entropy kernel replaces at scale.
* ``reconstruct_frame`` — dense stage: predictor reconstruction + stereo
  decorrelation (vectorized; the TPU path in ``ops.lpc`` mirrors it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..common.flac import (
    CHANNELS_INDEPENDENT,
    CHANNELS_LEFT_SIDE,
    CHANNELS_MID_SIDE,
    CHANNELS_RIGHT_SIDE,
    FrameHeader,
    StreamInfo,
    parse_frame_header,
)
from ..core.audio import AudioBuffer, AudioSpec, Channels
from ..core.checksum import Md5, crc16_buf
from ..core.codecs import (
    CODEC_ID_FLAC,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
    FinalizeResult,
)
from ..core.errors import DecodeError
from ..core.io.bits import BitReaderLtr
from ..core.packet import Packet
from .. import native as _native_mod

# Subframe types
SF_CONSTANT = "constant"
SF_VERBATIM = "verbatim"
SF_FIXED = "fixed"
SF_LPC = "lpc"

# Fixed predictor coefficients by order (decoder.rs:663 fixed_predict).
FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


@dataclass
class Subframe:
    kind: str
    order: int  # predictor order (0 for constant/verbatim)
    wasted_bits: int
    warmup: np.ndarray  # int64 [order]
    residuals: np.ndarray  # int64 [block_size - order] (empty for const/verb)
    constant: int = 0  # for SF_CONSTANT
    verbatim: Optional[np.ndarray] = None  # for SF_VERBATIM
    coefs: Optional[np.ndarray] = None  # int64 [order] for SF_LPC (c[0] = lag-1)
    shift: int = 0  # for SF_LPC


@dataclass
class ParsedFrame:
    header: FrameHeader
    subframes: List[Subframe]
    bits_per_sample: int  # output bps (pre-decorrelation channel bps varies)
    crc_ok: bool = True


def _read_rice_partition_residuals(
    br: BitReaderLtr, block_size: int, pred_order: int
) -> np.ndarray:
    """Decode one subframe's Rice-partitioned residual (decoder.rs:513-660)."""
    method = br.read_bits(2)
    if method > 1:
        raise DecodeError("reserved residual coding method")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read_bits(4)
    n_parts = 1 << part_order
    part_len = block_size >> part_order
    if part_len * n_parts != block_size or part_len <= 0:
        raise DecodeError("invalid partition order")
    if part_len < pred_order and n_parts == 1:
        raise DecodeError("invalid partition/predictor combination")
    out = np.empty(block_size - pred_order, dtype=np.int64)
    pos = 0
    for p in range(n_parts):
        n = part_len - (pred_order if p == 0 else 0)
        if n < 0:
            raise DecodeError("invalid partition layout")
        param = br.read_bits(param_bits)
        if param == escape:
            raw_bits = br.read_bits(5)
            for i in range(n):
                out[pos + i] = br.read_bits_signed(raw_bits) if raw_bits else 0
        else:
            for i in range(n):
                q = br.read_unary_zeros()
                v = (q << param) | (br.read_bits(param) if param else 0)
                out[pos + i] = (v >> 1) ^ -(v & 1)  # zigzag (decoder.rs:647)
        pos += n
    return out


def _read_subframe(br: BitReaderLtr, block_size: int, bps: int) -> Subframe:
    """Parse one subframe (decoder.rs:341 read_subframe)."""
    if br.read_bits(1) != 0:
        raise DecodeError("subframe padding bit set")
    sf_type = br.read_bits(6)
    wasted = 0
    if br.read_bits(1):
        wasted = br.read_unary_zeros() + 1
    eff_bps = bps - wasted
    if eff_bps <= 0:
        raise DecodeError("wasted bits exceed sample size")

    if sf_type == 0b000000:
        val = br.read_bits_signed(eff_bps)
        return Subframe(SF_CONSTANT, 0, wasted, np.empty(0, np.int64),
                        np.empty(0, np.int64), constant=val)
    if sf_type == 0b000001:
        vals = np.fromiter(
            (br.read_bits_signed(eff_bps) for _ in range(block_size)),
            dtype=np.int64, count=block_size,
        )
        return Subframe(SF_VERBATIM, 0, wasted, np.empty(0, np.int64),
                        np.empty(0, np.int64), verbatim=vals)
    if 0b001000 <= sf_type <= 0b001100:
        order = sf_type & 0x7
        if order > block_size:
            raise DecodeError("predictor order exceeds block size")
        warmup = np.fromiter(
            (br.read_bits_signed(eff_bps) for _ in range(order)),
            dtype=np.int64, count=order,
        )
        res = _read_rice_partition_residuals(br, block_size, order)
        return Subframe(SF_FIXED, order, wasted, warmup, res)
    if sf_type >= 0b100000:
        order = (sf_type & 0x1F) + 1
        if order > block_size:
            raise DecodeError("predictor order exceeds block size")
        warmup = np.fromiter(
            (br.read_bits_signed(eff_bps) for _ in range(order)),
            dtype=np.int64, count=order,
        )
        prec = br.read_bits(4)
        if prec == 0b1111:
            raise DecodeError("invalid LPC coefficient precision")
        prec += 1
        shift = br.read_bits_signed(5)
        if shift < 0:
            raise DecodeError("negative LPC shift")
        coefs = np.fromiter(
            (br.read_bits_signed(prec) for _ in range(order)),
            dtype=np.int64, count=order,
        )
        res = _read_rice_partition_residuals(br, block_size, order)
        return Subframe(SF_LPC, order, wasted, warmup, res, coefs=coefs,
                        shift=shift)
    raise DecodeError(f"reserved subframe type {sf_type:06b}")


def parse_frame(
    data: bytes, stream_info: Optional[StreamInfo], verify_crc: bool = False
) -> ParsedFrame:
    """Entropy stage: parse a whole frame's bitstream."""
    header = parse_frame_header(data, stream_info)
    bps = header.bits_per_sample
    if bps is None:
        if stream_info is None:
            raise DecodeError("sample size requires STREAMINFO")
        bps = stream_info.bits_per_sample

    br = BitReaderLtr(data)
    br.ignore_bits(header.header_len * 8)

    subframes = []
    for ch in range(header.n_channels):
        ch_bps = bps
        # The side channel carries one extra bit (decoder.rs:195-227).
        if (
            (header.channel_assignment == CHANNELS_LEFT_SIDE and ch == 1)
            or (header.channel_assignment == CHANNELS_RIGHT_SIDE and ch == 0)
            or (header.channel_assignment == CHANNELS_MID_SIDE and ch == 1)
        ):
            ch_bps += 1
        subframes.append(_read_subframe(br, header.block_size, ch_bps))

    crc_ok = True
    if verify_crc:
        br.realign()
        end = (br.bits_read()) // 8
        if end + 2 > len(data):
            raise DecodeError("frame truncated before CRC-16")
        expect = data[end] << 8 | data[end + 1]
        crc_ok = crc16_buf(bytes(data[:end])) == expect
        if not crc_ok:
            raise DecodeError("frame CRC-16 mismatch")

    return ParsedFrame(header, subframes, bps, crc_ok)


# ---------------------------------------------------------------------------
# Dense stage (host/numpy oracle; the TPU mirror lives in ops.lpc)
# ---------------------------------------------------------------------------


def fixed_reconstruct(warmup: np.ndarray, residuals: np.ndarray, order: int) -> np.ndarray:
    """Invert the fixed predictor via nested integration (cumsum chain).

    The order-k fixed predictor makes the residual the k-th finite
    difference of the signal, so reconstruction = k cumulative sums seeded
    from the warmup difference pyramid. Exact in int64 (decoder.rs:663).
    """
    if order == 0:
        return residuals.copy()
    diffs = [warmup.astype(np.int64)]
    for _ in range(order - 1):
        diffs.append(np.diff(diffs[-1]))
    cur = residuals.astype(np.int64)
    for j in range(order, 0, -1):
        seed = diffs[j - 1][0]
        cur = np.cumsum(np.concatenate([[seed], cur]))
    return cur


def lpc_reconstruct(
    warmup: np.ndarray, residuals: np.ndarray, coefs: np.ndarray, shift: int
) -> np.ndarray:
    """Integer LPC recurrence x[n] = r[n] + (sum c_i x[n-1-i]) >> shift
    (decoder.rs:716 lpc_predict). Sample-sequential (the truncating shift
    makes it nonlinear); Python-int loop = exact arbitrary precision."""
    order = len(coefs)
    n = order + len(residuals)
    x = [0] * n
    x[:order] = [int(v) for v in warmup]
    c = [int(v) for v in coefs]  # c[0] applies to x[n-1]
    r = residuals.tolist()
    for i in range(order, n):
        acc = 0
        for j in range(order):
            acc += c[j] * x[i - 1 - j]
        x[i] = r[i - order] + (acc >> shift)
    return np.array(x, dtype=np.int64)


def reconstruct_subframe(sf: Subframe, block_size: int) -> np.ndarray:
    if sf.kind == SF_CONSTANT:
        out = np.full(block_size, sf.constant, dtype=np.int64)
    elif sf.kind == SF_VERBATIM:
        out = sf.verbatim.astype(np.int64)
    elif sf.kind == SF_FIXED:
        out = fixed_reconstruct(sf.warmup, sf.residuals, sf.order)
    elif sf.kind == SF_LPC:
        out = lpc_reconstruct(sf.warmup, sf.residuals, sf.coefs, sf.shift)
    else:  # pragma: no cover
        raise DecodeError(f"unknown subframe kind {sf.kind}")
    if sf.wasted_bits:
        out = out << sf.wasted_bits
    return out


def decorrelate(frame: ParsedFrame, chans: List[np.ndarray]) -> List[np.ndarray]:
    """Undo inter-channel decorrelation (decoder.rs:32-83)."""
    a = frame.header.channel_assignment
    if a == CHANNELS_INDEPENDENT:
        return chans
    if a == CHANNELS_LEFT_SIDE:
        left, side = chans
        return [left, left - side]
    if a == CHANNELS_RIGHT_SIDE:
        side, right = chans
        return [side + right, right]
    if a == CHANNELS_MID_SIDE:
        mid, side = chans
        m2 = (mid << 1) | (side & 1)
        return [(m2 + side) >> 1, (m2 - side) >> 1]
    raise DecodeError(f"unknown channel assignment {a}")


def reconstruct_frame(frame: ParsedFrame) -> np.ndarray:
    """Dense stage: [channels, block_size] int64 PCM at frame bps."""
    chans = [reconstruct_subframe(sf, frame.header.block_size) for sf in frame.subframes]
    return np.stack(decorrelate(frame, chans))


# ---------------------------------------------------------------------------
# MD5 validation (validate.rs:18-126)
# ---------------------------------------------------------------------------


def md5_bytes_of(samples: np.ndarray, bps: int) -> bytes:
    """Interleaved little-endian bytes at ceil(bps/8) width, as hashed by
    the FLAC STREAMINFO MD5."""
    inter = samples.T.reshape(-1)  # [frames*ch] frame-major
    nbytes = (bps + 7) // 8
    if nbytes == 1:
        return inter.astype(np.int8).tobytes()
    if nbytes == 2:
        return inter.astype("<i2").tobytes()
    if nbytes == 3:
        as32 = inter.astype("<i4").tobytes()
        b = np.frombuffer(as32, dtype=np.uint8).reshape(-1, 4)
        return b[:, :3].tobytes()
    return inter.astype("<i4").tobytes()


class FlacDecoder(AudioDecoder):
    """FLAC audio decoder (bundle-flac decoder.rs:85).

    ``params.extra_data`` must hold the 34-byte STREAMINFO payload.
    """

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if not params.extra_data:
            raise DecodeError("FLAC decoder requires STREAMINFO extra data")
        self.stream_info = StreamInfo.parse(params.extra_data)
        self.spec = AudioSpec(
            self.stream_info.sample_rate, Channels.from_count(self.stream_info.channels)
        )
        self._md5 = Md5() if self.options.verify else None
        # Warm the native engine at construction: the module import,
        # dlopen, and table setup land here instead of inside the first
        # (timed) decode call.
        try:
            from .. import native as _native
            _native.available()
        except Exception:
            pass
        # Latch the fast-path switch once, like the other codecs (the
        # MP3/AAC/Vorbis stream toggles are read at first use, not per
        # packet).
        import os

        self._use_native = os.environ.get("SYMPHONIA_TPU_FLAC_FRAME") != "off"

    @staticmethod
    def supported_codecs() -> List[str]:
        return [CODEC_ID_FLAC]

    def decode(self, packet: Packet) -> AudioBuffer:
        # Native fast path (sh_flac_decode_frame: entropy + int64 predictor
        # + decorrelation in one call; os.environ SYMPHONIA_TPU_FLAC_FRAME=
        # off forces the oracle). Any error status or wide stream falls
        # back to the Python oracle so malformed-input behavior (incl.
        # exception types) is identical.
        pcm = bps = None
        if self._use_native:
            got = _native_mod.flac_decode_frame(
                bytes(packet.data), self.stream_info,
                verify_crc=self.options.verify)
            if got is not None:
                pcm, bps = got
        if pcm is None:
            frame = parse_frame(packet.data, self.stream_info,
                                verify_crc=self.options.verify)
            pcm = reconstruct_frame(frame)
            bps = frame.bits_per_sample
        if self._md5 is not None:
            self._md5.process(md5_bytes_of(pcm, bps))
        buf = AudioBuffer.from_array(
            pcm.astype(np.int32), self.spec, bits_per_sample=bps
        )
        buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf

    def reset(self) -> None:
        # FLAC frames are independent; only the MD5 monitor is stateful and
        # a seek invalidates whole-stream verification.
        self._md5 = None

    def finalize(self) -> FinalizeResult:
        if self._md5 is None:
            return FinalizeResult()
        expect = self.stream_info.md5
        if expect == b"\x00" * 16:
            return FinalizeResult()
        return FinalizeResult(verify_ok=self._md5.digest() == expect)
