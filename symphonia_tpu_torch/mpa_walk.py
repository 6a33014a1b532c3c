"""The frame-table walk of a seekable MPEG audio stream in compiled host
code, and the reader built on it.

``formats.mpa.MpaReader`` (a verbatim copy of the reference's reader)
walks a stream's frames in Python, one ``try_parse_header`` a frame
(~1,150 for a 30 s clip), after finding the first frame with numpy masks
over the whole stream. :class:`MpaReader` here is its subclass, with the
walk made one call of ``csrc/mpa_walk.cpp``, which applies the same rules
(header rejections, frame sizes, compatibility, the strict two-header
resync, where the walk stops) and so gives the same frame offsets and
sizes for every input. Everything else stays the verbatim reader's: the
bytes read through the ``MediaSourceStream``, the Xing/Info/VBRI probe,
the gapless fields, packets, the packet table and seek.

g++ builds the library at first use into ``_build/``, under a name keyed
by a hash of the source and flags, so a stale library is never loaded;
it writes a temporary file and renames it. Where g++ or the library is
missing, or inside ``native.disabled()``, the reader runs the verbatim
walk. Each reader adds one to the counter ``mpa_walk_native_streams``
(compiled walk) or ``mpa_walk_host_streams`` (verbatim walk) of
:mod:`.trace`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import native, trace
from .codecs.mpa_common import (
    LAYER1,
    LAYER2,
    LAYER3,
    MPEG1,
    MPEG2,
    MPEG2P5,
    _SAMPLE_RATES,
    tables,
    try_parse_header,
)
from .core.audio import Channels
from .core.codecs import (
    CODEC_ID_MP1,
    CODEC_ID_MP2,
    CODEC_ID_MP3,
    AudioCodecParameters,
)
from .core.errors import Unsupported
from .core.formats import FormatOptions, FormatReader, Track
from .core.meta import MetadataLog
from .core.units import TimeBase
from .formats import mpa
from .formats.mpa import parse_info_tag

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "mpa_walk.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
# Every frame the bitrate tables allow is at least 24 bytes (MPEG-2 Layer
# III at 8 kbit/s and 24 kHz), so a stream of n bytes holds fewer than
# n // 16 + 1 frames.
_MIN_FRAME = 16

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
_TABLES = None  # (bitrates int32 [5, 16], rates int32 [3, 3])


def _build() -> Optional[Path]:
    """The library's path, built by g++ where it is not there yet; None
    where g++ is missing or fails."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    so = BUILD_DIR / f"libmpa_walk_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([gxx] + FLAGS + ["-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return so


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded walker, built on first use; None where it cannot be
    built or loaded, or inside ``native.disabled()``."""
    global _LIB, _TRIED, _TABLES
    if native._DISABLED:
        return None
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            so = _build()
            try:
                lib = ctypes.CDLL(str(so)) if so is not None else None
            except OSError:
                lib = None
            if lib is not None:
                lib.mpa_walk.restype = ctypes.c_int64
                lib.mpa_walk.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
                t = tables()
                bitrates = np.zeros((5, 16), np.int32)
                for row, key in enumerate(
                        ("bit_rates_mpeg1_l1", "bit_rates_mpeg1_l2",
                         "bit_rates_mpeg1_l3", "bit_rates_mpeg2_l1",
                         "bit_rates_mpeg2_l23")):
                    bitrates[row, :len(t[key])] = t[key]
                rates = np.asarray([_SAMPLE_RATES[v]
                                    for v in (MPEG1, MPEG2, MPEG2P5)],
                                   np.int32)
                _TABLES = (bitrates, rates)
                _LIB = lib
        return _LIB


def walk(lib: ctypes.CDLL, buf: bytes):
    """(first, offsets, sizes): the offset of the stream's first strictly
    verified frame, and the frame table from it (that frame included), as
    int64 arrays. Raises ``Unsupported`` where no frame is found, as the
    verbatim reader does."""
    cap = len(buf) // _MIN_FRAME + 1
    table = np.empty((2, cap), np.int64)
    first = ctypes.c_int64(-1)
    bitrates, rates = _TABLES
    n = lib.mpa_walk(buf, len(buf), bitrates.ctypes.data, rates.ctypes.data,
                     ctypes.byref(first), table.ctypes.data,
                     table[1].ctypes.data, cap)
    if n == -1:
        raise Unsupported("no MPEG audio frames found")
    if n < 0:
        raise RuntimeError(f"mpa_walk: more than {cap} frames")
    return first.value, table[0, :n], table[1, :n]


class MpaReader(mpa.MpaReader):
    """``formats.mpa.MpaReader`` whose frame table comes from the compiled
    walk: the same attributes, set to the same values, for every input.
    It keeps the class name, which the tools print as the container's."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        lib = _lib()
        if lib is None:
            super().__init__(mss, options)
            trace.count("mpa_walk_host_streams", 1)
            return
        FormatReader.__init__(self, mss, options)
        self._metadata = MetadataLog()
        start = mss.pos()
        # Read the remainder (batch-first whole-stream scan).
        chunks = []
        while True:
            b = mss.read_upto(1 << 22)
            if not b:
                break
            chunks.append(b)
        buf = b"".join(chunks)

        first_off, offsets, sizes = walk(lib, buf)
        first_hdr = try_parse_header(buf, first_off)
        self._buf = buf
        self._start = start

        # Probe the first frame for a Xing/Info/VBRI tag; its frame is then
        # no audio frame.
        info = parse_info_tag(
            buf[first_off : first_off + first_hdr.frame_size], first_hdr)
        skip = 1 if info.present else 0

        self.header = first_hdr
        spf = first_hdr.duration
        self._offsets = offsets[skip:].copy()
        self._sizes = sizes[skip:].copy()
        self._spf = spf
        self._cursor = 0

        delay = info.enc_delay if self.options.enable_gapless else 0
        padding = info.enc_padding if self.options.enable_gapless else 0
        total = len(self._offsets) * spf
        self._delay = delay
        self._padding = padding if delay + padding <= total else 0
        self._total_out = max(0, total - self._delay - self._padding)

        codec = {LAYER1: CODEC_ID_MP1, LAYER2: CODEC_ID_MP2,
                 LAYER3: CODEC_ID_MP3}[first_hdr.layer]
        params = AudioCodecParameters(
            codec=codec,
            sample_rate=first_hdr.sample_rate,
            channels=Channels.from_count(first_hdr.n_channels),
            max_frames_per_packet=spf,
        )
        self._track = Track(
            id=0,
            codec_params=params,
            time_base=TimeBase(1, first_hdr.sample_rate),
            num_frames=self._total_out,
            delay=self._delay,
            padding=self._padding,
        )
        trace.count("mpa_walk_native_streams", 1)

