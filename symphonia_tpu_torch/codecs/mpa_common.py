"""MPEG audio (MP1/MP2/MP3) frame headers and constants.

Analog of symphonia-bundle-mp3/src/header.rs (frame header parsing,
header.rs:20-251) and common.rs (FrameHeader/ChannelMode). Shared by the MPA
demuxer and decoders.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.errors import DecodeError

_DATA = None


def tables():
    """Lazy-load the ISO constant tables (see tools/gen_mp3_tables.py)."""
    global _DATA
    if _DATA is None:
        path = Path(__file__).resolve().parent.parent / "data" / "mp3_tables.npz"
        _DATA = dict(np.load(path))
    return _DATA


MPEG1 = 1
MPEG2 = 2
MPEG2P5 = 3

LAYER1 = 1
LAYER2 = 2
LAYER3 = 3

MODE_STEREO = "stereo"
MODE_JOINT = "joint"
MODE_DUAL = "dual"
MODE_MONO = "mono"

_SAMPLE_RATES = {
    MPEG1: [44100, 48000, 32000],
    MPEG2: [22050, 24000, 16000],
    MPEG2P5: [11025, 12000, 8000],
}

# Row index into the 9-row scalefactor-band tables (layer3/common.rs order:
# 44.1, 48, 32, 22.05, 24, 16, 11.025, 12, 8 kHz).
_SFB_ROW = {44100: 0, 48000: 1, 32000: 2, 22050: 3, 24000: 4, 16000: 5,
            11025: 6, 12000: 7, 8000: 8}


@dataclass(frozen=True)
class MpaHeader:
    version: int  # MPEG1/2/2.5
    layer: int  # 1..3
    bitrate: int  # bits/sec
    sample_rate: int
    sample_rate_idx: int  # row into SFB tables
    channel_mode: str
    mode_ext: int  # joint-stereo mode extension bits
    has_crc: bool
    padding: bool
    frame_size: int  # total frame bytes incl. header
    duration: int  # samples per frame

    @property
    def n_channels(self) -> int:
        return 1 if self.channel_mode == MODE_MONO else 2

    @property
    def is_mpeg1(self) -> bool:
        return self.version == MPEG1

    @property
    def is_intensity_stereo(self) -> bool:
        return self.channel_mode == MODE_JOINT and bool(self.mode_ext & 0x1)

    @property
    def is_mid_side(self) -> bool:
        return self.channel_mode == MODE_JOINT and bool(self.mode_ext & 0x2)

    def side_info_len(self) -> int:
        """Layer 3 side info length in bytes (common.rs side_info_len)."""
        if self.version == MPEG1:
            return 17 if self.channel_mode == MODE_MONO else 32
        return 9 if self.channel_mode == MODE_MONO else 17


def samples_per_frame(version: int, layer: int) -> int:
    if layer == LAYER1:
        return 384
    if layer == LAYER2:
        return 1152
    return 1152 if version == MPEG1 else 576


_HDR_CACHE: dict = {}


def parse_header(word: int) -> MpaHeader:
    """Parse a 32-bit big-endian frame header word (header.rs:79+).

    Memoized by the header word: a stream's frames differ only in the
    padding bit, and the demuxer + decoder each parse every frame (the
    parse was ~15% of the fused Layer II per-packet stage). MpaHeader is
    frozen so cached instances are safe to share. Bounded so fuzzed
    streams can't grow the cache without limit."""
    h = _HDR_CACHE.get(word)
    if h is not None:
        return h
    h = _parse_header(word)
    if len(_HDR_CACHE) < 4096:
        _HDR_CACHE[word] = h
    return h


def _parse_header(word: int) -> MpaHeader:
    if (word >> 21) & 0x7FF != 0x7FF:
        raise DecodeError("invalid sync word")
    version_bits = (word >> 19) & 0x3
    version = {0b00: MPEG2P5, 0b10: MPEG2, 0b11: MPEG1}.get(version_bits)
    if version is None:
        raise DecodeError("reserved MPEG version")
    layer_bits = (word >> 17) & 0x3
    layer = {0b01: LAYER3, 0b10: LAYER2, 0b11: LAYER1}.get(layer_bits)
    if layer is None:
        raise DecodeError("reserved layer")
    has_crc = ((word >> 16) & 0x1) == 0
    bitrate_idx = (word >> 12) & 0xF
    if bitrate_idx in (0, 15):
        raise DecodeError("free-format or invalid bitrate")
    rate_idx = (word >> 10) & 0x3
    if rate_idx == 3:
        raise DecodeError("reserved sample rate")
    padding = bool((word >> 9) & 0x1)
    mode_bits = (word >> 6) & 0x3
    mode_ext = (word >> 4) & 0x3
    if word & 0x3 == 0x2:
        raise DecodeError("reserved emphasis")

    t = tables()
    if version == MPEG1:
        br_table = {LAYER1: "bit_rates_mpeg1_l1", LAYER2: "bit_rates_mpeg1_l2",
                    LAYER3: "bit_rates_mpeg1_l3"}[layer]
    else:
        br_table = "bit_rates_mpeg2_l1" if layer == LAYER1 else "bit_rates_mpeg2_l23"
    bitrate = int(t[br_table][bitrate_idx])
    sample_rate = _SAMPLE_RATES[version][rate_idx]
    channel_mode = [MODE_STEREO, MODE_JOINT, MODE_DUAL, MODE_MONO][mode_bits]

    if layer == LAYER1:
        frame_size = (12 * bitrate // sample_rate + (1 if padding else 0)) * 4
    else:
        spf = samples_per_frame(version, layer)
        frame_size = spf // 8 * bitrate // sample_rate + (1 if padding else 0)

    return MpaHeader(
        version=version,
        layer=layer,
        bitrate=bitrate,
        sample_rate=sample_rate,
        sample_rate_idx=_SFB_ROW[sample_rate],
        channel_mode=channel_mode,
        mode_ext=mode_ext,
        has_crc=has_crc,
        padding=padding,
        frame_size=frame_size,
        duration=samples_per_frame(version, layer),
    )


def try_parse_header(data: bytes, offset: int = 0) -> Optional[MpaHeader]:
    if offset + 4 > len(data):
        return None
    word = int.from_bytes(data[offset : offset + 4], "big")
    try:
        return parse_header(word)
    except DecodeError:
        return None
