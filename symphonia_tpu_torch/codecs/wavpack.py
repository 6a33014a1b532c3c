"""WavPack decoder stub.

Parity note: the reference's symphonia-codec-wavpack crate is an empty stub
(lib.rs is a single line; README marks WavPack "-"). This framework matches
that support level.
"""

from __future__ import annotations

from typing import List

from ..core.codecs import CODEC_ID_WAVPACK, AudioDecoder
from ..core.errors import Unsupported


class WavpackDecoder(AudioDecoder):
    def __init__(self, params, options=None):
        raise Unsupported("WavPack decode is not implemented (matches reference)")

    @staticmethod
    def supported_codecs() -> List[str]:
        return []
