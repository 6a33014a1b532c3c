"""Opus decoder stub.

Parity note: the reference's symphonia-codec-opus crate is an empty stub
(lib.rs is a single line; README marks Opus as not implemented). This
framework matches that support level: OGG/MP4/Matroska *demux* Opus streams
(packet durations from the TOC, OpusHead/OpusTags parsing — see
formats/ogg.py OpusMapper), but no decoder is registered.
"""

from __future__ import annotations

from typing import List

from ..core.codecs import CODEC_ID_OPUS, AudioDecoder
from ..core.errors import Unsupported


class OpusDecoder(AudioDecoder):
    def __init__(self, params, options=None):
        raise Unsupported("Opus decode is not implemented (matches reference)")

    @staticmethod
    def supported_codecs() -> List[str]:
        return []
