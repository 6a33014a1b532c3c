"""Error taxonomy for symphonia_tpu.

Mirrors the reference's error contract (symphonia-core/src/errors.rs:43-57):
recoverable decode errors vs. IO errors vs. hard resets. Decoders raise
``DecodeError`` for malformed-but-skippable packets; demuxers raise
``ResetRequired`` when the stream fundamentally changes (e.g. chained OGG);
``LimitError`` guards DoS caps; ``EndOfStream`` terminates pull loops.
"""

from __future__ import annotations


class Error(Exception):
    """Base class for all symphonia_tpu errors."""


class IoError(Error):
    """An underlying I/O failure (reference: errors.rs IoError)."""


class EndOfStream(IoError):
    """The end of the media source was reached mid-read.

    The reference maps ``std::io::ErrorKind::UnexpectedEof`` to this; format
    readers translate it into the end-of-stream condition for packet loops.
    """


class DecodeError(Error):
    """The bitstream is malformed. The caller may skip the packet and
    continue (reference: errors.rs DecodeError semantics)."""


class SeekError(Error):
    """A seek could not be satisfied (unseekable source, out of range,
    or missing index). Reference: errors.rs SeekError{Unseekable,
    ForwardOnly, OutOfRange, InvalidTrack}."""

    UNSEEKABLE = "source is unseekable"
    FORWARD_ONLY = "source supports forward seeks only"
    OUT_OF_RANGE = "requested position is out of range"
    INVALID_TRACK = "invalid track id"


class Unsupported(Error):
    """The feature/codec/container is not supported (errors.rs Unsupported)."""


class LimitError(Error):
    """A configured DoS/resource limit was reached (errors.rs LimitError)."""


class ResetRequired(Error):
    """The decoder chain must be rebuilt: track list changed mid-stream
    (e.g. a chained OGG physical stream; reference formats/mod.rs:644)."""
