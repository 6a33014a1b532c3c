"""Experimental video codec support (parameter structs + decoder contract).

Parity with the reference's feature-gated `exp-video-codecs` surface
(symphonia-core/src/codecs/video.rs, 421 LoC): the reference ships ONLY
codec IDs, `VideoCodecParameters`, `VideoDecoderOptions`, and the
`VideoDecoder` trait — no decoder implementations exist anywhere in the
workspace. This module mirrors that contract so containers (MKV, MP4) can
describe video tracks and applications can register third-party decoders;
decoding video is explicitly out of scope, as it is upstream.

Codec IDs follow this codebase's string-id convention. A FourCC-derived
custom ID (video.rs:40-44) is `video_fourcc(b"...")`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional

from .errors import Unsupported

CODEC_ID_NULL_VIDEO = "null_video"

# Well-known video codec IDs (video.rs well_known, :168-260).
CODEC_ID_MJPEG = "mjpeg"
CODEC_ID_BINK_VIDEO = "bink_video"
CODEC_ID_SMACKER_VIDEO = "smacker_video"
CODEC_ID_CINEPAK = "cinepak"
CODEC_ID_INDEO2 = "indeo2"
CODEC_ID_INDEO3 = "indeo3"
CODEC_ID_INDEO4 = "indeo4"
CODEC_ID_INDEO5 = "indeo5"
CODEC_ID_SVQ1 = "svq1"
CODEC_ID_SVQ3 = "svq3"
CODEC_ID_FLV = "flv"
CODEC_ID_RV10 = "rv10"
CODEC_ID_RV20 = "rv20"
CODEC_ID_RV30 = "rv30"
CODEC_ID_RV40 = "rv40"
CODEC_ID_MSMPEG4V1 = "msmpeg4v1"
CODEC_ID_MSMPEG4V2 = "msmpeg4v2"
CODEC_ID_MSMPEG4V3 = "msmpeg4v3"
CODEC_ID_WMV1 = "wmv1"
CODEC_ID_WMV2 = "wmv2"
CODEC_ID_WMV3 = "wmv3"
CODEC_ID_VP3 = "vp3"
CODEC_ID_VP4 = "vp4"
CODEC_ID_VP5 = "vp5"
CODEC_ID_VP6 = "vp6"
CODEC_ID_VP7 = "vp7"
CODEC_ID_VP8 = "vp8"
CODEC_ID_VP9 = "vp9"
CODEC_ID_THEORA = "theora"
CODEC_ID_AV1 = "av1"
CODEC_ID_MPEG1 = "mpeg1video"
CODEC_ID_MPEG2 = "mpeg2video"
CODEC_ID_MPEG4 = "mpeg4video"
CODEC_ID_H261 = "h261"
CODEC_ID_H263 = "h263"
CODEC_ID_H264 = "h264"
CODEC_ID_HEVC = "hevc"
CODEC_ID_VVC = "vvc"
CODEC_ID_VC1 = "vc1"
CODEC_ID_AVS1 = "avs1"
CODEC_ID_AVS2 = "avs2"
CODEC_ID_AVS3 = "avs3"


def video_fourcc(cc: bytes) -> str:
    """Custom codec ID from a FourCC (video.rs:40-44)."""
    if len(cc) != 4 or not all(32 <= b < 127 for b in cc):
        raise ValueError("FourCC must be 4 printable ASCII bytes")
    return "fourcc:" + cc.decode("ascii")


@dataclass
class VideoExtraData:
    """Codec-defined extra/side data blob (video.rs:74-80)."""

    id: str = "null"
    data: bytes = b""


@dataclass
class VideoCodecParameters:
    """Video track parameters (video.rs:83-136)."""

    codec: str = CODEC_ID_NULL_VIDEO
    profile: Optional[int] = None
    level: Optional[int] = None
    width: Optional[int] = None
    height: Optional[int] = None
    extra_data: List[VideoExtraData] = field(default_factory=list)


@dataclass
class VideoDecoderOptions:
    """Options for video decoders (video.rs:140-144)."""


class VideoDecoder(ABC):
    """Video decoder contract (video.rs:147-165).

    No implementations ship here, matching the reference; the registry
    accepts third-party registrations through
    ``CodecRegistry.register_video_decoder``.
    """

    @abstractmethod
    def reset(self) -> None:
        """Reset decoder state (after a discontinuity/seek)."""

    @abstractmethod
    def codec_params(self) -> VideoCodecParameters:
        """Parameters the decoder was instantiated with (possibly updated)."""

    def decode(self, packet) -> object:
        raise Unsupported("video decoding is experimental: no decoder ships "
                          "with this framework (matches the reference)")
