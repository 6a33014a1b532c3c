"""Codec contracts, parameters, well-known codec IDs, and the registry.

Analog of symphonia-core/src/codecs/:

* codec IDs — codecs/audio.rs:301-500 well-known constants.
* ``AudioCodecParameters`` — codecs/audio.rs:78.
* ``AudioDecoder`` contract — codecs/audio.rs:251-298 (decode / reset /
  finalize / last_decoded), plus the batch-native ``decode_batch`` entry
  that the TPU pipeline uses (decode many packets at once).
* ``CodecRegistry`` — codecs/registry.rs:176, tiered id -> factory map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .audio import AudioBuffer, AudioSpec, Channels
from .errors import Unsupported
from .packet import Packet


# ---------------------------------------------------------------------------
# Well-known codec IDs (codecs/audio.rs:301-500). String-valued for clarity.
# ---------------------------------------------------------------------------

CODEC_ID_NULL = "null"

# PCM family
CODEC_ID_PCM_S8 = "pcm_s8"
CODEC_ID_PCM_U8 = "pcm_u8"
CODEC_ID_PCM_S16LE = "pcm_s16le"
CODEC_ID_PCM_S16BE = "pcm_s16be"
CODEC_ID_PCM_U16LE = "pcm_u16le"
CODEC_ID_PCM_U16BE = "pcm_u16be"
CODEC_ID_PCM_S24LE = "pcm_s24le"
CODEC_ID_PCM_S24BE = "pcm_s24be"
CODEC_ID_PCM_U24LE = "pcm_u24le"
CODEC_ID_PCM_U24BE = "pcm_u24be"
CODEC_ID_PCM_S32LE = "pcm_s32le"
CODEC_ID_PCM_S32BE = "pcm_s32be"
CODEC_ID_PCM_U32LE = "pcm_u32le"
CODEC_ID_PCM_U32BE = "pcm_u32be"
CODEC_ID_PCM_F32LE = "pcm_f32le"
CODEC_ID_PCM_F32BE = "pcm_f32be"
CODEC_ID_PCM_F64LE = "pcm_f64le"
CODEC_ID_PCM_F64BE = "pcm_f64be"
CODEC_ID_PCM_ALAW = "pcm_alaw"
CODEC_ID_PCM_MULAW = "pcm_mulaw"

# ADPCM family
CODEC_ID_ADPCM_MS = "adpcm_ms"
CODEC_ID_ADPCM_IMA_WAV = "adpcm_ima_wav"
CODEC_ID_ADPCM_IMA_QT = "adpcm_ima_qt"

# Compressed codecs
CODEC_ID_FLAC = "flac"
CODEC_ID_MP1 = "mp1"
CODEC_ID_MP2 = "mp2"
CODEC_ID_MP3 = "mp3"
CODEC_ID_AAC = "aac"
CODEC_ID_VORBIS = "vorbis"
CODEC_ID_OPUS = "opus"
CODEC_ID_ALAC = "alac"
CODEC_ID_WAVPACK = "wavpack"
# Described-only (no decoder ships, matching the reference: the demuxers
# surface the track parameters and make_audio_decoder raises Unsupported).
CODEC_ID_AC3 = "ac3"
CODEC_ID_EAC3 = "eac3"


class Tier:
    """Registration tiers (common.rs:54)."""

    PREFERRED = 0
    STANDARD = 1
    FALLBACK = 2


@dataclass
class VerificationCheck:
    """Decode self-verification info (codecs/audio.rs:63): kind in
    {'crc8','crc16','crc32','md5'} with the expected value."""

    kind: str
    value: bytes


@dataclass
class AudioCodecParameters:
    """Decoder construction parameters (codecs/audio.rs:78)."""

    codec: str = CODEC_ID_NULL
    sample_rate: Optional[int] = None
    bits_per_sample: Optional[int] = None
    bits_per_coded_sample: Optional[int] = None
    channels: Optional[Channels] = None
    max_frames_per_packet: Optional[int] = None
    frames_per_block: Optional[int] = None
    block_align: Optional[int] = None
    extra_data: Optional[bytes] = None
    verification_check: Optional[VerificationCheck] = None


@dataclass
class AudioDecoderOptions:
    """Runtime decoder options (codecs/audio.rs:210)."""

    verify: bool = False


@dataclass
class FinalizeResult:
    """Result of AudioDecoder.finalize (codecs/audio.rs:198-205)."""

    verify_ok: Optional[bool] = None


class AudioDecoder:
    """Audio decoder contract (codecs/audio.rs:251-298).

    Subclasses implement ``decode`` (one packet -> AudioBuffer). The batched
    TPU path additionally overrides ``decode_batch`` to decode a sequence of
    packets in one fused device dispatch; the default falls back to a
    sequential loop so every codec works in both modes.
    """

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        self.params = params
        self.options = options or AudioDecoderOptions()

    # -- required ----------------------------------------------------------

    def decode(self, packet: Packet) -> AudioBuffer:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear inter-packet state after a seek (codecs/audio.rs:254)."""

    def finalize(self) -> FinalizeResult:
        return FinalizeResult()

    def last_decoded(self) -> Optional[AudioBuffer]:
        return getattr(self, "_last", None)

    def codec_params(self) -> AudioCodecParameters:
        return self.params

    # -- batch-native entry ------------------------------------------------

    def decode_batch(self, packets: Sequence[Packet]) -> List[AudioBuffer]:
        """Decode many packets at once. Default: sequential fallback."""
        return [self.decode(p) for p in packets]


class CodecRegistry:
    """Tiered codec-id -> decoder-factory registry (codecs/registry.rs:176).

    Video and subtitle registration mirror the reference's experimental
    surface (registry.rs:96-160): the registry accepts third-party
    factories, but no video/subtitle decoder ships here — the reference
    workspace contains none either (core/video.py, core/subtitle.py).
    """

    def __init__(self):
        self._audio: Dict[str, List[Tuple[int, Callable]]] = {}
        self._video: Dict[str, List[Tuple[int, Callable]]] = {}
        self._subtitle: Dict[str, List[Tuple[int, Callable]]] = {}

    @staticmethod
    def _register(table, factory, tier) -> None:
        for codec_id in factory.supported_codecs():
            lst = table.setdefault(codec_id, [])
            lst.append((tier, factory))
            lst.sort(key=lambda t: t[0])

    @staticmethod
    def _make(table, kind, params, options):
        candidates = table.get(params.codec)
        if not candidates:
            raise Unsupported(
                f"no {kind} decoder registered for codec '{params.codec}'")
        return candidates[0][1](params, options)

    def register_audio_decoder(self, factory, tier: int = Tier.STANDARD) -> None:
        """Register a decoder class/factory. The factory must expose
        ``supported_codecs() -> list[str]`` and be callable as
        ``factory(params, options)`` (registry.rs:252)."""
        self._register(self._audio, factory, tier)

    def make_audio_decoder(
        self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None
    ) -> AudioDecoder:
        """Instantiate the best decoder for the parameters (registry.rs:330)."""
        return self._make(self._audio, "audio", params,
                          options or AudioDecoderOptions())

    def register_video_decoder(self, factory, tier: int = Tier.STANDARD) -> None:
        """Register an experimental video decoder factory (registry.rs:57)."""
        self._register(self._video, factory, tier)

    def make_video_decoder(self, params, options=None):
        from .video import VideoDecoderOptions

        return self._make(self._video, "video", params,
                          options or VideoDecoderOptions())

    def register_subtitle_decoder(self, factory, tier: int = Tier.STANDARD) -> None:
        """Register an experimental subtitle decoder factory."""
        self._register(self._subtitle, factory, tier)

    def make_subtitle_decoder(self, params, options=None):
        from .subtitle import SubtitleDecoderOptions

        return self._make(self._subtitle, "subtitle", params,
                          options or SubtitleDecoderOptions())

    def supported_codecs(self) -> List[str]:
        return sorted(self._audio)
