"""Byte and bit level I/O.

Host-side analog of symphonia-core/src/io/: a buffered ``MediaSourceStream``
over any file-like object, endian-aware byte readers, MSB-first and LSB-first
bit readers (the scalar *oracles* against which the vectorized TPU entropy
kernels in ``symphonia_tpu.ops`` are tested), and the multi-level LUT Huffman
``Codebook``.
"""

from .media_source import MediaSourceStream, BufReader, ScopedStream, MonitorStream
from .bits import BitReaderLtr, BitReaderRtl
from .codebook import Codebook, CodebookBuilder, BitOrder

__all__ = [
    "MediaSourceStream",
    "BufReader",
    "ScopedStream",
    "MonitorStream",
    "BitReaderLtr",
    "BitReaderRtl",
    "Codebook",
    "CodebookBuilder",
    "BitOrder",
]
