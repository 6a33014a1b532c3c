"""symphonia_tpu.core — framework substrate.

The host-side analog of the reference's ``symphonia-core`` crate: errors,
time units, packets, planar audio buffers + sample conversion, byte/bit I/O,
Huffman codebooks, checksums, format/codec contracts, probing, and the
metadata model. The TPU compute kernels live in ``symphonia_tpu.ops``.
"""

from . import errors, units, packet, audio, codecs, formats, meta, probe, checksum
from .errors import (
    Error,
    IoError,
    EndOfStream,
    DecodeError,
    SeekError,
    Unsupported,
    LimitError,
    ResetRequired,
)
from .units import Time, TimeBase
from .packet import Packet
from .audio import AudioBuffer, AudioSpec, Channels, Position, SampleFormat
from .formats import (
    FormatOptions,
    FormatReader,
    PacketTable,
    SeekIndex,
    SeekMode,
    SeekTo,
    SeekedTo,
    Track,
)
from .codecs import (
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
    CodecRegistry,
    FinalizeResult,
    Tier,
)
from .meta import MetadataLog, MetadataOptions, MetadataRevision, RawTag, Visual
from .probe import Descriptor, Hint, Probe, ProbeOptions, ProbeResult
