"""symphonia_tpu_torch — the PyTorch/CUDA port of symphonia_tpu.

The host stage (probe, demuxers, native C++ entropy extraction) is the
reference package's own, imported; the dense decode math runs on an
explicit device through kernels written by hand for NVIDIA Hopper
(``csrc/*.cu``, built with nvcc on first use) or, on CPU tensors, through
their plain PyTorch twins. This package never imports JAX.

Ported so far: FLAC, MPEG audio Layers I, II and III, AAC-LC and Ogg
Vorbis through :mod:`.batch` (``decode_bytes``, ``decode_many``,
``decode_file``).
"""

from .batch import (AacBatchDecoder, DecodedAudio,  # noqa: F401
                    FlacBatchDecoder, Mp3BatchDecoder, VorbisBatchDecoder,
                    decode_bytes, decode_file, decode_many)

__version__ = "0.1.0"
