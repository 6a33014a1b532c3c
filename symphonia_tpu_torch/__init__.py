"""symphonia_tpu_torch — the PyTorch/CUDA port of symphonia_tpu.

The package stands alone: its host stage (probe, demuxers, metadata, the
per-packet codecs, the numpy oracles and table builders, and the loader
of the repository's native C++ host library, ``native/``) is its own copy
of the reference package's, and nothing here imports ``symphonia_tpu`` or
JAX. The dense decode math runs on an explicit device through kernels
written by hand for NVIDIA Hopper (``csrc/*.cu``, built with nvcc on first
use) or, on CPU tensors, through their plain PyTorch twins.

Ported so far, on one card: FLAC, MPEG audio Layers I, II and III, AAC-LC
and Ogg Vorbis through :mod:`.batch`'s batch decoders (``decode_bytes``,
``decode_many``, ``decode_file``); every other stream those functions take
(PCM in WAV, AIFF, CAF and MP4, ADPCM, ALAC, FLAC in Matroska, ...)
through the reference's per-packet loop on the host, counted in
``batch.packet_routes``; the combined four-codec decode step of the
reference's driver entry point through :mod:`.entry`; and the last two TPU
programs, K12 (the PCM batch unpack, ``ops.pcm.decode_pcm_batch``) and K13
(the device Rice decode, ``ops.rice_device.rice_decode_lanes`` and
``tools/bench_rice_device.py``); the repository's bench and mutation
soak (``tools/bench.py``, ``tools/soak.py``); its conformance checker,
player and resampler (``tools/check.py``, ``play.py``, ``resample.py``,
``ui.py``) and its examples; and the multi-card form of the entry step
(``entry.dryrun_multichip`` over :mod:`.parallel`, ``torch.distributed``
ranks with halos where the step couples lanes).

Facade (as the reference's, symphonia/src/lib.rs): the same top-level
names as the reference package (its core types and errors, and
``MediaSourceStream``), from this package's own ``core``; lazily
constructed global ``Probe`` and ``CodecRegistry`` with every enabled
format and codec registered.
"""

from __future__ import annotations

from typing import Optional

from .core import (  # noqa: F401  (re-exports)
    AudioBuffer,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
    AudioSpec,
    Channels,
    CodecRegistry,
    DecodeError,
    EndOfStream,
    Error,
    FormatOptions,
    FormatReader,
    Hint,
    IoError,
    MetadataOptions,
    Packet,
    Probe,
    ResetRequired,
    SampleFormat,
    SeekMode,
    SeekTo,
    Time,
    TimeBase,
    Track,
    Unsupported,
)
from .core.io import MediaSourceStream

__version__ = "0.1.0"

_PROBE: Optional[Probe] = None
_CODECS: Optional[CodecRegistry] = None


def get_probe() -> Probe:
    """The global format/metadata probe (symphonia/src/lib.rs:225)."""
    global _PROBE
    if _PROBE is None:
        _PROBE = Probe()
        _register_enabled_formats(_PROBE)
    return _PROBE


def get_codecs() -> CodecRegistry:
    """The global codec registry (symphonia/src/lib.rs:215)."""
    global _CODECS
    if _CODECS is None:
        _CODECS = CodecRegistry()
        _register_enabled_codecs(_CODECS)
    return _CODECS


def _register_enabled_formats(probe: Probe) -> None:
    """Register every format reader and metadata reader
    (symphonia/src/lib.rs:234-300 register_enabled_formats)."""
    from .formats import adts, aiff, caf, flac, isomp4, mkv, mpa, ogg, wav
    from .metadata import ape, id3v1, id3v2

    for mod in (wav, aiff, caf, flac, mpa, ogg, adts, isomp4, mkv, id3v2,
                id3v1):
        probe.register(mod.DESCRIPTOR)
    probe.register(ape.DESCRIPTOR)
    probe.register(ape.DESCRIPTOR_BEFORE_ID3V1)


def _register_enabled_codecs(registry: CodecRegistry) -> None:
    """Register every decoder (symphonia/src/lib.rs
    register_enabled_codecs)."""
    from .codecs.aac import AacDecoder
    from .codecs.adpcm import AdpcmDecoder
    from .codecs.alac import AlacDecoder
    from .codecs.flac import FlacDecoder
    from .codecs.mpa import MpaDecoder
    from .codecs.pcm import PcmDecoder
    from .codecs.vorbis import VorbisDecoder

    for cls in (PcmDecoder, AdpcmDecoder, FlacDecoder, MpaDecoder,
                VorbisDecoder, AacDecoder, AlacDecoder):
        registry.register_audio_decoder(cls)


from .batch import (AacBatchDecoder, DecodedAudio,  # noqa: E402,F401
                    FlacBatchDecoder, Mp3BatchDecoder, VorbisBatchDecoder,
                    decode_bytes, decode_file, decode_many)
