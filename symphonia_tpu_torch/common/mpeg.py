"""MPEG-4 audio common structures: AudioSpecificConfig.

Analog of symphonia-common/src/mpeg/audio/mod.rs:17-231: audio object types,
the sampling-frequency table, and the AudioSpecificConfig parser (used by
the MP4 esds box and synthesized from ADTS headers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.audio import Channels, Position
from ..core.errors import DecodeError, Unsupported
from ..core.io.bits import BitReaderLtr

AOT_AAC_MAIN = 1
AOT_AAC_LC = 2
AOT_AAC_SSR = 3
AOT_AAC_LTP = 4
AOT_SBR = 5
AOT_PS = 29

SAMPLE_RATES = [
    96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
    16000, 12000, 11025, 8000, 7350,
]

# Channel-configuration index -> positioned speaker layout, mirroring
# get_mpeg4_audio_channels_by_config_index (mpeg/audio/mod.rs:201-213).
# Index 4 is front C/L/R + rear center (AAC_4P0) and index 7 is the
# 7.1-wide layout (front left/right-of-center, not sides) — both differ
# from the generic n-channel defaults.
_CONFIG_LAYOUTS = {
    1: Position.MONO,
    2: Position.STEREO,
    3: Position.STEREO | Position.FRONT_CENTER,
    4: Position.STEREO | Position.FRONT_CENTER | Position.REAR_CENTER,
    5: Position.STEREO | Position.FRONT_CENTER
    | Position.REAR_LEFT | Position.REAR_RIGHT,
    6: Position.STEREO | Position.FRONT_CENTER | Position.LFE1
    | Position.REAR_LEFT | Position.REAR_RIGHT,
    7: Position.STEREO | Position.FRONT_CENTER | Position.LFE1
    | Position.REAR_LEFT | Position.REAR_RIGHT
    | Position.FRONT_LEFT_CENTER | Position.FRONT_RIGHT_CENTER,
}


def channels_for_config(ch_config: int) -> Optional[Channels]:
    """AAC channel layout for a channel-configuration index (1-7)."""
    mask = _CONFIG_LAYOUTS.get(ch_config)
    return Channels(mask=mask) if mask is not None else None


@dataclass
class AudioSpecificConfig:
    object_type: int
    sample_rate: int
    n_channels: int
    samples: int = 1024
    sbr_present: bool = False
    channels: Optional[Channels] = None  # positioned layout when known

    @staticmethod
    def read(buf: bytes) -> "AudioSpecificConfig":
        br = BitReaderLtr(buf)
        aot = br.read_bits(5)
        if aot == 31:
            aot = 32 + br.read_bits(6)
        sr_idx = br.read_bits(4)
        if sr_idx == 15:
            rate = br.read_bits(24)
        else:
            if sr_idx >= len(SAMPLE_RATES):
                raise DecodeError("invalid ASC sample rate index")
            rate = SAMPLE_RATES[sr_idx]
        ch_config = br.read_bits(4)
        sbr = False
        if aot in (AOT_SBR, AOT_PS):
            # Explicit SBR signaling: extension sample rate then real AOT.
            sbr = True
            ext_idx = br.read_bits(4)
            if ext_idx == 15:
                rate = br.read_bits(24)
            elif ext_idx >= len(SAMPLE_RATES):
                raise DecodeError("invalid ASC extension sample rate index")
            else:
                rate = SAMPLE_RATES[ext_idx]
            aot = br.read_bits(5)
        if aot not in (AOT_AAC_MAIN, AOT_AAC_LC, AOT_AAC_LTP):
            raise Unsupported(f"AAC object type {aot}")
        # GASpecificConfig
        short_frame = br.read_bits(1)
        if br.read_bits(1):  # dependsOnCoreCoder
            br.read_bits(14)
        if br.read_bits(1):  # extensionFlag
            pass
        channels = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 8}.get(ch_config)
        if channels is None or channels == 0:
            raise Unsupported("AAC channel configuration")
        if rate == 0:
            raise DecodeError("ASC sample rate is zero")
        return AudioSpecificConfig(
            object_type=aot,
            sample_rate=rate,
            n_channels=channels,
            samples=960 if short_frame else 1024,
            sbr_present=sbr,
            channels=channels_for_config(ch_config),
        )

    @staticmethod
    def build(object_type: int, sample_rate: int, n_channels: int) -> bytes:
        """Serialize a minimal two-byte ASC (for ADTS-derived params)."""
        sr_idx = SAMPLE_RATES.index(sample_rate)
        word = (object_type << 11) | (sr_idx << 7) | (n_channels << 3)
        return word.to_bytes(2, "big")
