"""Experimental subtitle codec support (parameter structs + contract).

Parity with the reference's feature-gated `exp-subtitle-codecs` surface
(symphonia-core/src/codecs/subtitle.rs): codec IDs,
`SubtitleCodecParameters`, `SubtitleDecoderOptions`, and the
`SubtitleDecoder` trait only — the reference ships no subtitle decoder
implementations either.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

from .errors import Unsupported

CODEC_ID_NULL_SUBTITLE = "null_subtitle"

# Well-known subtitle codec IDs (subtitle.rs well_known, :148-188).
CODEC_ID_TEXT_UTF8 = "text_utf8"
CODEC_ID_SSA = "ssa"
CODEC_ID_ASS = "ass"
CODEC_ID_SAMI = "sami"
CODEC_ID_SRT = "srt"
CODEC_ID_WEBVTT = "webvtt"
CODEC_ID_DVBSUB = "dvbsub"
CODEC_ID_HDMV_TEXTST = "hdmv_textst"
CODEC_ID_MOV_TEXT = "mov_text"
CODEC_ID_BMP_SUBTITLE = "bmp_subtitle"
CODEC_ID_VOBSUB = "vobsub"
CODEC_ID_HDMV_PGS = "hdmv_pgs"
CODEC_ID_KATE = "kate"


def subtitle_fourcc(cc: bytes) -> str:
    """Custom codec ID from a FourCC (subtitle.rs:37-42)."""
    if len(cc) != 4 or not all(32 <= b < 127 for b in cc):
        raise ValueError("FourCC must be 4 printable ASCII bytes")
    return "fourcc:" + cc.decode("ascii")


@dataclass
class SubtitleCodecParameters:
    """Subtitle track parameters (subtitle.rs:65-90)."""

    codec: str = CODEC_ID_NULL_SUBTITLE
    extra_data: Optional[bytes] = None


@dataclass
class SubtitleDecoderOptions:
    """Options for subtitle decoders (subtitle.rs:94-98)."""


class SubtitleDecoder(ABC):
    """Subtitle decoder contract (subtitle.rs:101-141). No implementations
    ship here, matching the reference."""

    @abstractmethod
    def reset(self) -> None:
        """Reset decoder state (after a discontinuity/seek)."""

    @abstractmethod
    def codec_params(self) -> SubtitleCodecParameters:
        """Parameters the decoder was instantiated with."""

    def decode(self, packet) -> object:
        raise Unsupported("subtitle decoding is experimental: no decoder "
                          "ships with this framework (matches the reference)")
