"""Checksum monitors: CRC-8, CRC-16, CRC-32, MD5.

Analog of symphonia-core/src/checksum/: table-driven CRCs with the same
polynomials the reference uses —

* CRC-8  poly 0x07  (FLAC frame headers; checksum/crc8.rs)
* CRC-16 poly 0x8005 (FLAC frames, ADTS; checksum/crc16.rs)
* CRC-32 poly 0x04C11DB7, MSB-first, init 0, no reflection (OGG pages;
  checksum/crc32.rs)
* MD5 via hashlib (FLAC STREAMINFO verification; checksum/md5.rs)

Each exposes the ``Monitor`` interface: ``process(bytes)`` + ``crc()`` /
``digest()``. Bulk processing is vectorized with numpy table lookups so
host-side verification keeps up with the batched TPU decode path.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _make_table_msb(poly: int, width: int) -> np.ndarray:
    """Byte-at-a-time table for an MSB-first (non-reflected) CRC."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & top) else (crc << 1)
            crc &= mask
        table[i] = crc
    return table


_CRC8_TABLE = _make_table_msb(0x07, 8).astype(np.uint8)
_CRC16_TABLE = _make_table_msb(0x8005, 16).astype(np.uint16)
_CRC32_TABLE = _make_table_msb(0x04C11DB7, 32).astype(np.uint32)

# Native bulk dispatch (identical tables in native/symphonia_host.cpp):
# resolved lazily so `core` stays importable without the toolchain. Small
# buffers stay in Python — the ctypes call costs more than the loop.
_NATIVE_MIN = 64
_native_lib = None


def _native():
    global _native_lib
    if _native_lib is None:
        try:
            from .. import native as _n

            lib = _n._load()
            _native_lib = (lib, _n._u8ptr) if lib is not None else False
        except Exception:
            _native_lib = False
    return _native_lib


def _native_crc(fn_name: str, data, init: int):
    nat = _native()
    if not nat:
        return None
    lib, u8ptr = nat
    fn = getattr(lib, fn_name, None)
    if fn is None:
        return None
    a = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    return int(fn(u8ptr(a), len(a), init))


class Crc8:
    """CRC-8/FLAC (poly 0x07, init 0) — checksum/crc8.rs."""

    def __init__(self, init: int = 0):
        self._crc = init

    def process(self, data: bytes) -> None:
        if len(data) >= _NATIVE_MIN:
            got = _native_crc("sh_crc8_init", data, self._crc)
            if got is not None:
                self._crc = got
                return
        crc = self._crc
        table = _CRC8_TABLE
        for b in data:
            crc = int(table[crc ^ b])
        self._crc = crc

    def crc(self) -> int:
        return self._crc


class Crc16:
    """CRC-16/BUYPASS (poly 0x8005, init 0, MSB-first) — checksum/crc16.rs."""

    def __init__(self, init: int = 0):
        self._crc = init

    def process(self, data: bytes) -> None:
        if len(data) >= _NATIVE_MIN:
            got = _native_crc("sh_crc16", data, self._crc)
            if got is not None:
                self._crc = got
                return
        crc = self._crc
        table = _CRC16_TABLE
        for b in data:
            crc = ((crc << 8) & 0xFFFF) ^ int(table[((crc >> 8) ^ b) & 0xFF])
        self._crc = crc

    def crc(self) -> int:
        return self._crc


class Crc32:
    """CRC-32/MPEG-2-style MSB-first, init 0, xorout 0 (OGG pages) —
    checksum/crc32.rs."""

    def __init__(self, init: int = 0):
        self._crc = init

    def process(self, data: bytes) -> None:
        if len(data) >= _NATIVE_MIN:
            got = _native_crc("sh_crc32", data, self._crc)
            if got is not None:
                self._crc = got
                return
        crc = self._crc
        table = _CRC32_TABLE
        for b in data:
            crc = ((crc << 8) & 0xFFFFFFFF) ^ int(table[((crc >> 24) ^ b) & 0xFF])
        self._crc = crc

    def crc(self) -> int:
        return self._crc


def crc8_buf(data: bytes, init: int = 0) -> int:
    """One-shot CRC-8 over a buffer."""
    c = Crc8(init)
    c.process(data)
    return c.crc()


def crc16_buf(data: bytes, init: int = 0) -> int:
    c = Crc16(init)
    c.process(data)
    return c.crc()


def crc32_buf(data: bytes, init: int = 0) -> int:
    c = Crc32(init)
    c.process(data)
    return c.crc()


def crc16_batch(buffers: list) -> np.ndarray:
    """CRC-16 over many buffers (per-frame FLAC verification)."""
    return np.array([crc16_buf(b) for b in buffers], dtype=np.uint16)


class Md5:
    """MD5 monitor (checksum/md5.rs) backed by hashlib."""

    def __init__(self):
        self._h = hashlib.md5()

    def process(self, data: bytes) -> None:
        self._h.update(data)

    def digest(self) -> bytes:
        return self._h.digest()

    def hexdigest(self) -> str:
        return self._h.hexdigest()
