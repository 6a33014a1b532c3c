"""Buffered byte-level readers.

Host-side analog of symphonia-core/src/io/{mod.rs,media_source_stream.rs,
buf_reader.rs,scoped_stream.rs,monitor_stream.rs}:

* ``MediaSourceStream`` — buffered, rewindable reader over any file-like
  source (media_source_stream.rs:52; ring buffer + exponential read-ahead).
* ``BufReader`` — zero-copy reader over in-memory bytes (buf_reader.rs).
* ``ScopedStream`` — read-limited wrapper used by probe scoring and chunk
  walkers (scoped_stream.rs).
* ``MonitorStream`` — observer wrapper feeding CRC/MD5 monitors per read
  (monitor_stream.rs).

All expose the ``ReadBytes`` surface (io/mod.rs:145): exact and best-effort
reads, LE/BE integer/float helpers, peeking, ignoring, and position/seek.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Optional, Protocol, Union

from ..errors import EndOfStream, IoError, SeekError


class _ReadBytesMixin:
    """Endian helpers implemented on top of ``read_bytes`` (io/mod.rs:145)."""

    def read_bytes(self, n: int) -> bytes:  # pragma: no cover - abstract
        raise NotImplementedError

    def read_byte(self) -> int:
        return self.read_bytes(1)[0]

    read_u8 = read_byte

    def read_i8(self) -> int:
        return struct.unpack("b", self.read_bytes(1))[0]

    def read_u16le(self) -> int:
        return int.from_bytes(self.read_bytes(2), "little")

    def read_u16be(self) -> int:
        return int.from_bytes(self.read_bytes(2), "big")

    def read_i16le(self) -> int:
        return int.from_bytes(self.read_bytes(2), "little", signed=True)

    def read_i16be(self) -> int:
        return int.from_bytes(self.read_bytes(2), "big", signed=True)

    def read_u24le(self) -> int:
        return int.from_bytes(self.read_bytes(3), "little")

    def read_u24be(self) -> int:
        return int.from_bytes(self.read_bytes(3), "big")

    def read_u32le(self) -> int:
        return int.from_bytes(self.read_bytes(4), "little")

    def read_u32be(self) -> int:
        return int.from_bytes(self.read_bytes(4), "big")

    def read_i32le(self) -> int:
        return int.from_bytes(self.read_bytes(4), "little", signed=True)

    def read_i32be(self) -> int:
        return int.from_bytes(self.read_bytes(4), "big", signed=True)

    def read_u64le(self) -> int:
        return int.from_bytes(self.read_bytes(8), "little")

    def read_u64be(self) -> int:
        return int.from_bytes(self.read_bytes(8), "big")

    def read_f32le(self) -> float:
        return struct.unpack("<f", self.read_bytes(4))[0]

    def read_f32be(self) -> float:
        return struct.unpack(">f", self.read_bytes(4))[0]

    def read_f64le(self) -> float:
        return struct.unpack("<d", self.read_bytes(8))[0]

    def read_f64be(self) -> float:
        return struct.unpack(">d", self.read_bytes(8))[0]

    def read_quad_bytes(self) -> bytes:
        return self.read_bytes(4)

    def read_to_null(self, max_len: int = 65536) -> bytes:
        """Read a null-terminated byte string (terminator consumed)."""
        out = bytearray()
        for _ in range(max_len):
            b = self.read_byte()
            if b == 0:
                break
            out.append(b)
        return bytes(out)


class MediaSourceStream(_ReadBytesMixin):
    """Buffered reader over a file-like source (media_source_stream.rs:52).

    The reference uses a 64 kB power-of-2 ring with exponential read-ahead
    (media_source_stream.rs:22-31,73-74). Here a sliding ``bytearray`` window
    plays the same role: reads refill with exponentially growing chunks
    (8 kB -> 64 kB), back-seeks within the retained window are free, and
    absolute seeks delegate to the underlying source when seekable.
    """

    MIN_READAHEAD = 8 * 1024
    MAX_READAHEAD = 64 * 1024
    # Retain this many trailing bytes when compacting, for cheap back-seeks.
    RETAIN = 64 * 1024

    def __init__(self, source: Union[bytes, bytearray, memoryview, BinaryIO]):
        if isinstance(source, (bytes, bytearray, memoryview)):
            source = io.BytesIO(bytes(source))
        self._src: BinaryIO = source
        self._seekable = self._probe_seekable()
        self._len = self._probe_len() if self._seekable else None
        # Buffer window: bytes [self._abs, self._abs + len(self._buf)).
        self._buf = bytearray()
        self._abs = self._src.tell() if self._seekable else 0
        self._pos = 0  # index into _buf
        self._readahead = self.MIN_READAHEAD

    # -- source properties -------------------------------------------------

    def _probe_seekable(self) -> bool:
        try:
            return self._src.seekable()
        except AttributeError:
            return False

    def _probe_len(self) -> Optional[int]:
        try:
            cur = self._src.tell()
            end = self._src.seek(0, io.SEEK_END)
            self._src.seek(cur)
            return end
        except (OSError, AttributeError):
            return None

    def is_seekable(self) -> bool:
        return self._seekable

    def byte_len(self) -> Optional[int]:
        return self._len

    def pos(self) -> int:
        return self._abs + self._pos

    # -- buffering ---------------------------------------------------------

    def _fill(self, need: int) -> int:
        """Ensure >= ``need`` unread bytes are buffered; returns available."""
        avail = len(self._buf) - self._pos
        while avail < need:
            want = max(need - avail, self._readahead)
            self._readahead = min(self._readahead * 2, self.MAX_READAHEAD)
            try:
                chunk = self._src.read(want)
            except OSError as e:  # pragma: no cover - passthrough
                raise IoError(str(e)) from e
            if not chunk:
                break
            self._buf.extend(chunk)
            avail = len(self._buf) - self._pos
        self._compact()
        return len(self._buf) - self._pos

    def _compact(self) -> None:
        if self._pos > 4 * self.RETAIN:
            drop = self._pos - self.RETAIN
            del self._buf[:drop]
            self._abs += drop
            self._pos -= drop

    # -- ReadBytes ---------------------------------------------------------

    def read_bytes(self, n: int) -> bytes:
        if n < 0:
            # A negative count (from a corrupt size field a caller failed
            # to validate) must never walk the cursor backwards.
            raise EndOfStream(f"negative read of {n} bytes at pos {self.pos()}")
        if self._fill(n) < n:
            raise EndOfStream(f"needed {n} bytes at pos {self.pos()}")
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n
        return out

    def read_upto(self, n: int) -> bytes:
        if n <= 0:
            return b""
        avail = min(self._fill(n), n)
        out = bytes(self._buf[self._pos : self._pos + avail])
        self._pos += avail
        return out

    def peek_bytes(self, n: int) -> bytes:
        """Peek up to n bytes without consuming (may return fewer at EOF)."""
        avail = min(self._fill(n), n)
        return bytes(self._buf[self._pos : self._pos + avail])

    def peek_bytes_exact(self, n: int) -> bytes:
        if self._fill(n) < n:
            raise EndOfStream(f"needed {n} bytes at pos {self.pos()}")
        return bytes(self._buf[self._pos : self._pos + n])

    def ignore_bytes(self, n: int) -> None:
        if self._seekable and n > len(self._buf) - self._pos + self.MAX_READAHEAD:
            self.seek(self.pos() + n)
            return
        while n > 0:
            step = min(n, 1 << 20)
            got = min(self._fill(step), step)
            if got == 0:
                raise EndOfStream("eof while ignoring bytes")
            self._pos += got
            n -= got

    # -- seeking -----------------------------------------------------------

    def seek(self, target: int) -> int:
        """Absolute seek. Uses the buffered window when possible
        (SeekBuffered, io/mod.rs:467), else the underlying source."""
        if self._abs <= target <= self._abs + len(self._buf):
            self._pos = target - self._abs
            return target
        if not self._seekable:
            if target >= self.pos():
                self.ignore_bytes(target - self.pos())
                return target
            raise SeekError(SeekError.FORWARD_ONLY)
        try:
            self._src.seek(target)
        except OSError as e:
            raise SeekError(str(e)) from e
        self._buf.clear()
        self._abs = target
        self._pos = 0
        self._readahead = self.MIN_READAHEAD
        return target

    def seek_buffered_rev(self, delta: int) -> None:
        """Rewind ``delta`` bytes within the buffered window
        (media_source_stream.rs seek_buffered_rev)."""
        if delta > self._pos:
            raise SeekError("rewind exceeds buffered window")
        self._pos -= delta

    def into_inner(self) -> BinaryIO:
        return self._src


class BufReader(_ReadBytesMixin):
    """Reader over an in-memory byte buffer (buf_reader.rs)."""

    def __init__(self, data: Union[bytes, bytearray, memoryview], start: int = 0):
        self._data = memoryview(data)
        self._pos = start

    def read_bytes(self, n: int) -> bytes:
        if n < 0 or self._pos + n > len(self._data):
            raise EndOfStream(f"needed {n} bytes at pos {self._pos}")
        out = bytes(self._data[self._pos : self._pos + n])
        self._pos += n
        return out

    def read_upto(self, n: int) -> bytes:
        n = max(0, min(n, len(self._data) - self._pos))
        out = bytes(self._data[self._pos : self._pos + n])
        self._pos += n
        return out

    def peek_bytes(self, n: int) -> bytes:
        n = min(n, len(self._data) - self._pos)
        return bytes(self._data[self._pos : self._pos + n])

    def ignore_bytes(self, n: int) -> None:
        if self._pos + n > len(self._data):
            raise EndOfStream("eof while ignoring bytes")
        self._pos += n

    def pos(self) -> int:
        return self._pos

    def seek(self, target: int) -> int:
        if not 0 <= target <= len(self._data):
            raise SeekError(SeekError.OUT_OF_RANGE)
        self._pos = target
        return target

    def bytes_available(self) -> int:
        return len(self._data) - self._pos

    def remaining(self) -> bytes:
        return bytes(self._data[self._pos :])


class ScopedStream(_ReadBytesMixin):
    """Wraps a reader, limiting reads to ``length`` bytes (scoped_stream.rs).

    Implements ``FiniteStream`` (io/mod.rs:518): ``bytes_read``,
    ``bytes_available``, and ``ignore`` of the unread remainder.
    """

    def __init__(self, inner, length: int):
        self._inner = inner
        self._len = length
        self._read = 0

    def read_bytes(self, n: int) -> bytes:
        if self._read + n > self._len:
            raise EndOfStream("scoped stream limit reached")
        out = self._inner.read_bytes(n)
        self._read += n
        return out

    def read_upto(self, n: int) -> bytes:
        n = min(n, self._len - self._read)
        out = self._inner.read_upto(n)
        self._read += len(out)
        return out

    def peek_bytes(self, n: int) -> bytes:
        return self._inner.peek_bytes(min(n, self._len - self._read))

    def ignore_bytes(self, n: int) -> None:
        if self._read + n > self._len:
            raise EndOfStream("scoped stream limit reached")
        self._inner.ignore_bytes(n)
        self._read += n

    def byte_len(self) -> int:
        return self._len

    def bytes_read(self) -> int:
        return self._read

    def bytes_available(self) -> int:
        return self._len - self._read

    def ignore(self) -> None:
        """Skip whatever remains of the scope."""
        self.ignore_bytes(self._len - self._read)

    def pos(self) -> int:
        return self._inner.pos()


class MonitorStream(_ReadBytesMixin):
    """Feeds every byte read into a monitor (CRC/MD5) (monitor_stream.rs)."""

    def __init__(self, inner, monitor):
        self._inner = inner
        self.monitor = monitor

    def read_bytes(self, n: int) -> bytes:
        out = self._inner.read_bytes(n)
        self.monitor.process(out)
        return out

    def read_upto(self, n: int) -> bytes:
        out = self._inner.read_upto(n)
        self.monitor.process(out)
        return out

    def peek_bytes(self, n: int) -> bytes:
        return self._inner.peek_bytes(n)

    def ignore_bytes(self, n: int) -> None:
        # Monitored streams must observe ignored bytes too.
        self.monitor.process(self._inner.read_bytes(n))

    def pos(self) -> int:
        return self._inner.pos()

    def into_inner(self):
        return self._inner
