"""Shared FLAC bitstream structures: STREAMINFO and frame headers.

Analog of symphonia-common/src/xiph/audio/flac/mod.rs (StreamInfo parsing)
and symphonia-bundle-flac/src/frame.rs (frame header sync/parse/CRC-8,
UTF-8-style frame numbering, frame.rs:64-318). Used by both the native FLAC
demuxer and the FLAC decoder, and by the OGG FLAC mapper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..core.checksum import crc8_buf
from ..core.errors import DecodeError
from ..core.io.bits import BitReaderLtr


@dataclass
class StreamInfo:
    """STREAMINFO metadata block (xiph/audio/flac/mod.rs:StreamInfo)."""

    block_len_min: int
    block_len_max: int
    frame_byte_len_min: int
    frame_byte_len_max: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    n_samples: int  # 0 = unknown
    md5: bytes

    @staticmethod
    def parse(data: bytes) -> "StreamInfo":
        if len(data) < 34:
            raise DecodeError("STREAMINFO too small")
        br = BitReaderLtr(data)
        block_min = br.read_bits(16)
        block_max = br.read_bits(16)
        frame_min = br.read_bits(24)
        frame_max = br.read_bits(24)
        rate = br.read_bits(20)
        channels = br.read_bits(3) + 1
        bps = br.read_bits(5) + 1
        n_samples = br.read_bits(36)
        md5 = bytes(data[18:34])
        if rate == 0 or rate > 655350:
            raise DecodeError(f"invalid sample rate {rate}")
        return StreamInfo(block_min, block_max, frame_min, frame_max, rate,
                          channels, bps, n_samples, md5)


# Channel assignment (frame.rs ChannelAssignment)
CHANNELS_INDEPENDENT = "independent"
CHANNELS_LEFT_SIDE = "left_side"
CHANNELS_RIGHT_SIDE = "right_side"
CHANNELS_MID_SIDE = "mid_side"

_BLOCK_SIZES = {
    0b0001: 192,
    **{n: 576 << (n - 2) for n in range(0b0010, 0b0110)},
    **{n: 256 << (n - 8) for n in range(0b1000, 0b10000)},
}

_SAMPLE_RATES = {
    0b0001: 88200, 0b0010: 176400, 0b0011: 192000, 0b0100: 8000,
    0b0101: 16000, 0b0110: 22050, 0b0111: 24000, 0b1000: 32000,
    0b1001: 44100, 0b1010: 48000, 0b1011: 96000,
}

_SAMPLE_SIZES = {0b001: 8, 0b010: 12, 0b100: 16, 0b101: 20, 0b110: 24, 0b111: 32}


@dataclass
class FrameHeader:
    """A parsed FLAC frame header (frame.rs:77 read_frame_header)."""

    block_size: int
    sample_rate: Optional[int]  # None = from STREAMINFO
    channel_assignment: str
    n_channels: int
    bits_per_sample: Optional[int]  # None = from STREAMINFO
    blocking_strategy_variable: bool
    # Sample number of first sample (variable) or frame number (fixed).
    seq: int
    header_len: int  # bytes consumed incl. CRC-8


def read_utf8_num(read_byte) -> int:
    """FLAC's extended UTF-8-style number coding, up to 36 bits over 7 bytes
    (frame.rs:318 tests this coding)."""
    b0 = read_byte()
    if b0 & 0x80 == 0:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise DecodeError("invalid UTF-8-coded number")
    val = b0 & (mask - 1)
    for _ in range(n_extra):
        b = read_byte()
        if b & 0xC0 != 0x80:
            raise DecodeError("invalid UTF-8-coded number continuation")
        val = (val << 6) | (b & 0x3F)
    return val


def is_sync_word(b0: int, b1: int) -> bool:
    """14-bit sync 0b11111111111110 + mandatory 0 reserved bit
    (frame.rs:64 sync_frame)."""
    return b0 == 0xFF and (b1 & 0xFC) == 0xF8


def parse_frame_header(
    data: bytes, stream_info: Optional[StreamInfo] = None
) -> FrameHeader:
    """Parse and CRC-validate a frame header at the start of ``data``.

    Raises DecodeError on any invalid/reserved field or CRC-8 mismatch, so
    it doubles as the sync-validation predicate for the demuxer's scan.
    """
    if len(data) < 6:
        raise DecodeError("frame header truncated")
    if not is_sync_word(data[0], data[1]):
        raise DecodeError("bad sync word")
    variable = bool(data[1] & 0x01)
    pos = 2

    byte2 = data[2]
    bs_code = byte2 >> 4
    sr_code = byte2 & 0x0F
    if bs_code == 0 or sr_code == 0b1111:
        raise DecodeError("reserved block size / sample rate code")
    byte3 = data[3]
    ch_code = byte3 >> 4
    ss_code = (byte3 >> 1) & 0x7
    if byte3 & 1:
        raise DecodeError("reserved bit set")
    if ss_code == 0b011:
        raise DecodeError("reserved sample size code")
    if ch_code > 0b1010:
        raise DecodeError("reserved channel assignment")
    pos = 4

    idx = [pos]

    def rb() -> int:
        if idx[0] >= len(data):
            raise DecodeError("frame header truncated")
        v = data[idx[0]]
        idx[0] += 1
        return v

    seq = read_utf8_num(rb)
    pos = idx[0]

    if bs_code == 0b0110:
        if pos + 1 > len(data):
            raise DecodeError("frame header truncated")
        block_size = data[pos] + 1
        pos += 1
    elif bs_code == 0b0111:
        if pos + 2 > len(data):
            raise DecodeError("frame header truncated")
        block_size = (data[pos] << 8 | data[pos + 1]) + 1
        pos += 2
    else:
        block_size = _BLOCK_SIZES[bs_code]

    if sr_code == 0b0000:
        sample_rate = None
    elif sr_code in (0b1100, 0b1101, 0b1110):
        need = 1 if sr_code == 0b1100 else 2
        if pos + need > len(data):
            raise DecodeError("frame header truncated")
        if sr_code == 0b1100:
            sample_rate = data[pos] * 1000
        elif sr_code == 0b1101:
            sample_rate = data[pos] << 8 | data[pos + 1]
        else:
            sample_rate = (data[pos] << 8 | data[pos + 1]) * 10
        pos += need
    else:
        sample_rate = _SAMPLE_RATES[sr_code]

    if pos + 1 > len(data):
        raise DecodeError("frame header truncated")
    if crc8_buf(bytes(data[:pos])) != data[pos]:
        raise DecodeError("frame header CRC-8 mismatch")
    pos += 1

    if ch_code <= 0b0111:
        assignment = CHANNELS_INDEPENDENT
        n_channels = ch_code + 1
    else:
        assignment = {
            0b1000: CHANNELS_LEFT_SIDE,
            0b1001: CHANNELS_RIGHT_SIDE,
            0b1010: CHANNELS_MID_SIDE,
        }[ch_code]
        n_channels = 2

    bits = _SAMPLE_SIZES.get(ss_code)

    # Cross-check against STREAMINFO when available (demuxer sync scan).
    if stream_info is not None:
        if n_channels != stream_info.channels:
            raise DecodeError("channel count mismatch with STREAMINFO")
        if bits is not None and bits != stream_info.bits_per_sample:
            raise DecodeError("sample size mismatch with STREAMINFO")
        if sample_rate is not None and sample_rate != stream_info.sample_rate:
            raise DecodeError("sample rate mismatch with STREAMINFO")
        if stream_info.block_len_max and block_size > stream_info.block_len_max:
            raise DecodeError("block size exceeds STREAMINFO maximum")

    return FrameHeader(
        block_size=block_size,
        sample_rate=sample_rate,
        channel_assignment=assignment,
        n_channels=n_channels,
        bits_per_sample=bits,
        blocking_strategy_variable=variable,
        seq=seq,
        header_len=pos,
    )


def first_sample_of(header: FrameHeader, stream_info: Optional[StreamInfo]) -> int:
    """Timestamp (in samples) of the frame's first sample."""
    if header.blocking_strategy_variable:
        return header.seq
    # Fixed blocking: frame number * (max) block size; all frames but the
    # last share block_len_min == block_len_max.
    if stream_info is not None and stream_info.block_len_max:
        return header.seq * stream_info.block_len_max
    return header.seq * header.block_size
