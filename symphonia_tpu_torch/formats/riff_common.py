"""Shared RIFF-style chunk-walking infrastructure.

Analog of symphonia-format-riff/src/common.rs: a little/big-endian chunk
walker (``ChunksReader``, common.rs:53-190), the parsed ``FormatData``
describing the sample encoding (common.rs:192-334), and block-aligned
``PacketInfo`` packetization (common.rs:330-390) shared by WAV and AIFF.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import codecs as ccodec
from ..core.audio import Channels
from ..core.errors import DecodeError, EndOfStream


@dataclass
class ChunkHeader:
    id: bytes
    size: int


class ChunksReader:
    """Iterates chunks of a RIFF (LE) or IFF (BE) container
    (common.rs:53-190). Chunks are word (2-byte) aligned."""

    def __init__(self, mss, length: Optional[int], big_endian: bool = False):
        self.mss = mss
        self.remaining = length
        self.big_endian = big_endian

    def next_chunk(self) -> Optional[ChunkHeader]:
        if self.remaining is not None and self.remaining < 8:
            return None
        try:
            cid = self.mss.read_bytes(4)
            size = self.mss.read_u32be() if self.big_endian else self.mss.read_u32le()
        except EndOfStream:
            return None
        if self.remaining is not None:
            self.remaining -= 8
        return ChunkHeader(cid, size)

    def skip_chunk(self, header: ChunkHeader) -> None:
        padded = header.size + (header.size & 1)
        self.mss.ignore_bytes(padded)
        if self.remaining is not None:
            self.remaining -= padded

    def consume(self, n: int) -> None:
        if self.remaining is not None:
            self.remaining -= n

    def align(self, header: ChunkHeader) -> None:
        """Skip the pad byte of an odd-sized chunk."""
        if header.size & 1:
            self.mss.ignore_bytes(1)
            self.consume(1)


@dataclass
class FormatData:
    """Decoded sample-format description (common.rs:192-334)."""

    codec: str
    bits_per_sample: Optional[int]
    bits_per_coded_sample: Optional[int]
    channels: Channels
    sample_rate: int
    block_align: int
    frames_per_block: int  # PCM: 1; ADPCM: decoded frames per block


@dataclass
class PacketInfo:
    """Block-aligned packetization (common.rs:330-390).

    A packet holds ``blocks_per_packet`` whole blocks of ``block_size``
    bytes, decoding to ``frames_per_block`` frames each.
    """

    block_size: int
    frames_per_block: int
    blocks_per_packet: int

    @staticmethod
    def for_format(fd: FormatData, target_frames: int = 4096) -> "PacketInfo":
        if fd.frames_per_block <= 0 or fd.block_align <= 0:
            raise DecodeError("invalid block alignment")
        blocks = max(1, target_frames // fd.frames_per_block)
        return PacketInfo(fd.block_align, fd.frames_per_block, blocks)

    @property
    def packet_bytes(self) -> int:
        return self.block_size * self.blocks_per_packet

    @property
    def packet_frames(self) -> int:
        return self.frames_per_block * self.blocks_per_packet


# ---------------------------------------------------------------------------
# WAVEFORMAT tag -> FormatData (wave/chunks.rs:861 analog)
# ---------------------------------------------------------------------------

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_ADPCM_MS = 0x0002
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_ADPCM_IMA = 0x0011
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# KSDATAFORMAT_SUBTYPE GUID tails; the first 4 bytes are the format tag.
_GUID_TAIL = bytes(
    [0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71]
)
# Ambisonic B-format GUID tail ({..-0721-11d3-8644-C8C1CA000000},
# wave/chunks.rs:253-261); the leading tag is PCM (1) or IEEE float (3).
_AMB_GUID_TAIL = bytes(
    [0x21, 0x07, 0xD3, 0x11, 0x86, 0x44, 0xC8, 0xC1, 0xCA, 0x00, 0x00, 0x00]
)
# FuMa B-format component labels by channel count (wave/chunks.rs:740-810).
_AMB_LAYOUTS = {
    1: "W", 2: "WY", 3: "WXY", 4: "WXYZ",
    5: "WXYUV", 6: "WXYZUV", 7: "WXYUVPQ", 8: "WXYZUVPQ", 9: "WXYZRSTUV",
}


def pcm_codec_id(bits: int, is_float: bool, big_endian: bool = False) -> str:
    c = ccodec
    if is_float:
        if bits == 32:
            return c.CODEC_ID_PCM_F32BE if big_endian else c.CODEC_ID_PCM_F32LE
        if bits == 64:
            return c.CODEC_ID_PCM_F64BE if big_endian else c.CODEC_ID_PCM_F64LE
        raise DecodeError(f"invalid float bit width {bits}")
    table = {
        8: c.CODEC_ID_PCM_U8 if not big_endian else c.CODEC_ID_PCM_U8,
        16: c.CODEC_ID_PCM_S16BE if big_endian else c.CODEC_ID_PCM_S16LE,
        24: c.CODEC_ID_PCM_S24BE if big_endian else c.CODEC_ID_PCM_S24LE,
        32: c.CODEC_ID_PCM_S32BE if big_endian else c.CODEC_ID_PCM_S32LE,
    }
    if bits not in table:
        raise DecodeError(f"unsupported PCM bit width {bits}")
    return table[bits]


def parse_waveformat(data: bytes) -> FormatData:
    """Parse a WAVE ``fmt `` chunk payload (wave/chunks.rs)."""
    import struct

    if len(data) < 16:
        raise DecodeError("fmt chunk too small")
    (tag, n_channels, rate, _avg_bps, block_align, bits) = struct.unpack(
        "<HHIIHH", data[:16]
    )
    if n_channels == 0:
        raise DecodeError("zero channels")
    if rate == 0:
        raise DecodeError("zero sample rate")
    channels = Channels.from_count(n_channels)
    coded_bits = bits

    if tag == WAVE_FORMAT_EXTENSIBLE:
        if len(data) < 40:
            raise DecodeError("extensible fmt chunk too small")
        (cb_size, valid_bits, ch_mask) = struct.unpack("<HHI", data[16:24])
        guid = data[24:40]
        is_amb = guid[4:] == _AMB_GUID_TAIL
        if guid[4:] != _GUID_TAIL and not is_amb:
            raise DecodeError("unknown WAVE subformat GUID")
        tag = int.from_bytes(guid[:4], "little")
        if is_amb:
            if tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT):
                raise DecodeError("unsupported ambisonic WAVE subformat")
            layout = _AMB_LAYOUTS.get(n_channels)
            if layout is None:
                raise DecodeError("unsupported ambisonic channel count")
            channels = Channels.custom_labels(tuple(layout))
        elif ch_mask:
            channels = Channels.positioned(ch_mask)
        if valid_bits:
            coded_bits = valid_bits

    if tag == WAVE_FORMAT_PCM:
        # Round the container width up to whole bytes for the codec id.
        container_bits = ((bits + 7) // 8) * 8
        codec = pcm_codec_id(container_bits, is_float=False)
        return FormatData(codec, container_bits, coded_bits, channels, rate,
                          block_align or n_channels * container_bits // 8, 1)
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        codec = pcm_codec_id(bits, is_float=True)
        return FormatData(codec, bits, coded_bits, channels, rate,
                          block_align or n_channels * bits // 8, 1)
    if tag == WAVE_FORMAT_ALAW:
        return FormatData(ccodec.CODEC_ID_PCM_ALAW, 16, 8, channels, rate,
                          block_align or n_channels, 1)
    if tag == WAVE_FORMAT_MULAW:
        return FormatData(ccodec.CODEC_ID_PCM_MULAW, 16, 8, channels, rate,
                          block_align or n_channels, 1)
    if tag == WAVE_FORMAT_ADPCM_MS:
        if block_align == 0:
            raise DecodeError("ADPCM requires block alignment")
        # frames/block (codec_ms.rs): ((ba - 7*ch) * 8) / (4*ch) + 2
        fpb = ((block_align - 7 * n_channels) * 8) // (4 * n_channels) + 2
        return FormatData(ccodec.CODEC_ID_ADPCM_MS, 16, 4, channels, rate,
                          block_align, fpb)
    if tag == WAVE_FORMAT_ADPCM_IMA:
        if block_align == 0:
            raise DecodeError("ADPCM requires block alignment")
        # frames/block (codec_ima_wav.rs): (ba - 4*ch) * 8 / (4*ch) + 1
        fpb = ((block_align - 4 * n_channels) * 8) // (4 * n_channels) + 1
        return FormatData(ccodec.CODEC_ID_ADPCM_IMA_WAV, 16, 4, channels, rate,
                          block_align, fpb)
    raise DecodeError(f"unsupported WAVE format tag 0x{tag:04x}")
