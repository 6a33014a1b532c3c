"""PCM decoder.

Analog of symphonia-codec-pcm/src/lib.rs (``PcmDecoder``, lib.rs:210): 30+
PCM codec ids, LE/BE, 8-64-bit int/float, A-law/mu-law, with
bits_per_coded_sample sub-width handling. Decode is a pure byte->sample
conversion: numpy on the host path, the jax kernel in
``symphonia_tpu.ops.pcm`` on the batch path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.audio import AudioBuffer, AudioSpec, Channels
from ..core.codecs import (
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
)
from ..core.errors import DecodeError
from ..core.packet import Packet
from ..ops.pcm import decode_pcm_np

PCM_CODECS = [
    "pcm_u8", "pcm_s8",
    "pcm_s16le", "pcm_s16be", "pcm_u16le", "pcm_u16be",
    "pcm_s24le", "pcm_s24be", "pcm_u24le", "pcm_u24be",
    "pcm_s32le", "pcm_s32be", "pcm_u32le", "pcm_u32be",
    "pcm_f32le", "pcm_f32be", "pcm_f64le", "pcm_f64be",
    "pcm_alaw", "pcm_mulaw",
]

_FLOAT_CODECS = {"pcm_f32le", "pcm_f32be", "pcm_f64le", "pcm_f64be"}


class PcmDecoder(AudioDecoder):
    """PCM audio decoder (codec-pcm lib.rs:210)."""

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if params.codec not in PCM_CODECS:
            raise DecodeError(f"not a PCM codec: {params.codec}")
        if params.sample_rate is None or params.channels is None:
            raise DecodeError("PCM requires sample rate and channels")
        if params.channels.count < 1:
            raise DecodeError("PCM requires at least one channel")
        self.spec = AudioSpec(params.sample_rate, params.channels)
        self._is_float = params.codec in _FLOAT_CODECS
        # Effective sample width after any coded-width shift.
        if params.codec in ("pcm_alaw", "pcm_mulaw"):
            self._bits = 16
        elif self._is_float:
            self._bits = 64 if "64" in params.codec else 32
        else:
            container = int("".join(c for c in params.codec if c.isdigit())[:2])
            coded = params.bits_per_coded_sample
            self._bits = coded if (coded and coded < container) else container

    @staticmethod
    def supported_codecs() -> List[str]:
        return list(PCM_CODECS)

    def decode(self, packet: Packet) -> AudioBuffer:
        planar = decode_pcm_np(
            packet.data,
            self.params.codec,
            self.spec.num_channels,
            self.params.bits_per_coded_sample,
        )
        buf = AudioBuffer.from_array(planar, self.spec, bits_per_sample=self._bits)
        buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf
