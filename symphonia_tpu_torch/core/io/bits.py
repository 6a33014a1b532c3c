"""Scalar bit readers: MSB-first (LTR) and LSB-first (RTL).

Host oracle for symphonia-core/src/io/bit.rs: ``BitReaderLtr`` (bit.rs:865,
``ReadBitsLtr`` bit.rs:502 — FLAC/MP3/AAC/ALAC) and ``BitReaderRtl``
(bit.rs:1305, ``ReadBitsRtl`` bit.rs:941 — Vorbis). The vectorized batch
equivalents used on the TPU path live in ``symphonia_tpu.ops.bitpack``;
these scalar readers are the reference implementation they are tested
against, and are used directly for header-level parsing on the host.
"""

from __future__ import annotations

from typing import Union

from ..errors import EndOfStream

_MASK = [(1 << n) - 1 for n in range(65)]


class BitReaderLtr:
    """MSB-first bit reader (bit.rs:865).

    Bits are consumed from the most-significant end of each byte, as used by
    FLAC, MP3, AAC, and ALAC.
    """

    __slots__ = ("_data", "_pos", "_buf", "_cnt")

    def __init__(self, data: Union[bytes, bytearray, memoryview]):
        self._data = memoryview(data)
        self._pos = 0  # next byte index
        self._buf = 0  # bit cache, left-aligned at bit (_cnt-1)
        self._cnt = 0  # cached bit count

    # -- position ----------------------------------------------------------

    def bits_left(self) -> int:
        return (len(self._data) - self._pos) * 8 + self._cnt

    def bits_read(self) -> int:
        return self._pos * 8 - self._cnt

    # -- core --------------------------------------------------------------

    def _load(self) -> None:
        """Pull up to 8 bytes into the cache."""
        end = min(self._pos + 8, len(self._data))
        if end == self._pos:
            raise EndOfStream("bitstream exhausted")
        chunk = self._data[self._pos : end]
        n = end - self._pos
        self._buf = (self._buf << (n * 8)) | int.from_bytes(chunk, "big")
        self._cnt += n * 8
        self._pos = end

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_bits(self, n: int) -> int:
        """Read ``n`` (0..=64) bits as an unsigned int (read_bits_leq32/64)."""
        if n == 0:
            return 0
        while self._cnt < n:
            self._load()
        self._cnt -= n
        val = self._buf >> self._cnt
        self._buf &= _MASK[self._cnt] if self._cnt <= 64 else (1 << self._cnt) - 1
        return val

    def read_bits_signed(self, n: int) -> int:
        """Read ``n`` bits as a two's-complement signed int."""
        v = self.read_bits(n)
        if n and v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary_zeros(self) -> int:
        """Count 0-bits until a 1 (consuming it); Rice quotient
        (bit.rs:642 read_unary_zeros)."""
        zeros = 0
        while True:
            if self._cnt == 0:
                self._load()
            if self._buf == 0:
                zeros += self._cnt
                self._cnt = 0
                continue
            lz = self._cnt - self._buf.bit_length()
            zeros += lz
            # consume lz zeros + the terminating 1
            self._cnt -= lz + 1
            self._buf &= (1 << self._cnt) - 1
            return zeros

    def read_unary_ones(self) -> int:
        """Count 1-bits until a 0 (consuming it) (bit.rs read_unary_ones)."""
        ones = 0
        while True:
            if self._cnt == 0:
                self._load()
            inv = (~self._buf) & ((1 << self._cnt) - 1)
            if inv == 0:
                ones += self._cnt
                self._cnt = 0
                continue
            lo = self._cnt - inv.bit_length()
            ones += lo
            self._cnt -= lo + 1
            self._buf &= (1 << self._cnt) - 1
            return ones

    def read_unary_zeros_capped(self, cap: int) -> int:
        """Unary read, failing past ``cap`` zeros (bit.rs capped variants)."""
        zeros = 0
        while True:
            if self._cnt == 0:
                self._load()
            if self._buf == 0:
                zeros += self._cnt
                self._cnt = 0
            else:
                lz = self._cnt - self._buf.bit_length()
                zeros += lz
                self._cnt -= lz + 1
                self._buf &= (1 << self._cnt) - 1
                if zeros > cap:
                    raise EndOfStream("unary code exceeded cap")
                return zeros
            if zeros > cap:
                raise EndOfStream("unary code exceeded cap")

    def ignore_bits(self, n: int) -> None:
        # Consume cached bits first, then skip whole bytes.
        take = min(n, self._cnt)
        if take:
            self._cnt -= take
            self._buf &= (1 << self._cnt) - 1
            n -= take
        skip_bytes = n // 8
        if self._pos + skip_bytes > len(self._data):
            raise EndOfStream("bitstream exhausted")
        self._pos += skip_bytes
        n -= skip_bytes * 8
        if n:
            self.read_bits(n)

    def realign(self) -> None:
        """Discard bits up to the next byte boundary."""
        self._cnt -= self._cnt % 8
        self._buf &= (1 << self._cnt) - 1

    def read_codebook(self, codebook) -> int:
        """Decode one codeword via a Codebook (bit.rs:771)."""
        return codebook.decode_ltr(self)


class BitReaderRtl:
    """LSB-first bit reader (bit.rs:1305), as used by Vorbis.

    Bits are consumed from the least-significant end of each byte.
    """

    __slots__ = ("_data", "_pos", "_buf", "_cnt")

    def __init__(self, data: Union[bytes, bytearray, memoryview]):
        self._data = memoryview(data)
        self._pos = 0
        self._buf = 0  # next bit at LSB
        self._cnt = 0

    def bits_left(self) -> int:
        return (len(self._data) - self._pos) * 8 + self._cnt

    def bits_read(self) -> int:
        return self._pos * 8 - self._cnt

    def _load(self) -> None:
        end = min(self._pos + 8, len(self._data))
        if end == self._pos:
            raise EndOfStream("bitstream exhausted")
        chunk = self._data[self._pos : end]
        self._buf |= int.from_bytes(chunk, "little") << self._cnt
        self._cnt += (end - self._pos) * 8
        self._pos = end

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        while self._cnt < n:
            self._load()
        val = self._buf & _MASK[n]
        self._buf >>= n
        self._cnt -= n
        return val

    def read_bits_signed(self, n: int) -> int:
        v = self.read_bits(n)
        if n and v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_bits_array(self, width: int, count: int):
        """``count`` consecutive ``read_bits(width)`` reads as an int64
        array — value-identical to the sequential loop (LSB-first fixed
        stride), vectorized via ``np.unpackbits`` for the Vorbis setup
        hot loops (codebook entry lengths, VQ multiplicands). Raises
        EndOfStream (reader exhausted) when the span passes the end,
        like the sequential loop's failing read would."""
        import numpy as np

        if count <= 0:
            return np.zeros(0, dtype=np.int64)
        total = width * count
        start = self.bits_read()
        if start + total > len(self._data) * 8:
            # Same exhausted end state on both size paths (the sequential
            # loop would stop mid-way; callers treat EndOfStream as fatal
            # either way, but keep the state path-independent).
            self._pos = len(self._data)
            self._buf = 0
            self._cnt = 0
            raise EndOfStream("bitstream exhausted")
        if total < 256:  # unpackbits overhead beats tiny loops
            return np.fromiter(
                (self.read_bits(width) for _ in range(count)),
                dtype=np.int64, count=count)
        b0 = start // 8
        b1 = (start + total + 7) // 8
        bits = np.unpackbits(
            np.frombuffer(self._data[b0:b1], dtype=np.uint8),
            bitorder="little")
        off = start - b0 * 8
        fields = bits[off : off + total].reshape(count, width)
        vals = fields.astype(np.int64) @ (
            np.int64(1) << np.arange(width, dtype=np.int64))
        # Re-anchor the reader just past the span: discard the consumed
        # low bits of the split byte (LSB-first), keeping the invariant
        # bits_read() == start + total.
        end = start + total
        self._pos = end // 8
        self._buf = 0
        self._cnt = 0
        if end % 8:
            self.read_bits(end % 8)
        return vals

    def read_unary_ones(self) -> int:
        """Count 1-bits (from LSB) until a 0, consuming it."""
        ones = 0
        while True:
            if self._cnt == 0:
                self._load()
            inv = (~self._buf) & ((1 << self._cnt) - 1)
            if inv == 0:
                ones += self._cnt
                self._cnt = 0
                continue
            tz = (inv & -inv).bit_length() - 1
            ones += tz
            self._buf >>= tz + 1
            self._cnt -= tz + 1
            return ones

    def ignore_bits(self, n: int) -> None:
        take = min(n, self._cnt)
        if take:
            self._buf >>= take
            self._cnt -= take
            n -= take
        skip_bytes = n // 8
        if self._pos + skip_bytes > len(self._data):
            raise EndOfStream("bitstream exhausted")
        self._pos += skip_bytes
        n -= skip_bytes * 8
        if n:
            self.read_bits(n)

    def read_codebook(self, codebook) -> int:
        return codebook.decode_rtl(self)
