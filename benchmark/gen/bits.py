"""Vectorised MSB-first bit packing for the stream generators (torch, on
any device).

A field is (bit position, value, length): ``length`` bits of ``value``,
most significant first, starting at that absolute bit of the output.
Fields never overlap, so adding them into 64-bit words is OR-ing them;
zero bits between fields (a Rice code's unary part, padding to a byte)
need no field at all. A field is at most 57 bits long, so it touches at
most two words.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_FIELD = 57


class BitBuffer:
    """A zeroed bit string of ``n_bits`` that fields are added into."""

    def __init__(self, n_bits: int, device):
        self.n_bits = int(n_bits)
        self.words = torch.zeros((self.n_bits + 63) // 64 + 1,
                                 dtype=torch.int64, device=device)

    def put(self, pos: torch.Tensor, val: torch.Tensor,
            length: torch.Tensor) -> None:
        pos, val, length = (t.reshape(-1).to(torch.int64)
                            for t in (pos, val, length))
        if not len(pos):
            return
        if int(length.max()) > MAX_FIELD:
            raise ValueError("a field is longer than 57 bits")
        val = val & ((1 << length) - 1)
        w = pos >> 6
        end = (pos & 63) + length  # 0 .. 120
        first = torch.where(end <= 64, val << (64 - end).clamp(min=0),
                            val >> (end - 64).clamp(min=0))
        self.words.index_add_(0, w, first)
        cross = end > 64
        self.words.index_add_(0, w[cross] + 1,
                              val[cross] << (128 - end[cross]))

    def to_bytes(self) -> np.ndarray:
        """The bit string as big-endian bytes, ``ceil(n_bits / 8)`` long."""
        raw = self.words.cpu().numpy().view(np.uint64).astype(">u8")
        return raw.view(np.uint8)[: (self.n_bits + 7) // 8].copy()


def crc_table(poly: int, width: int) -> np.ndarray:
    """MSB-first CRC table of ``width`` bits (no reflection)."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    out = np.zeros(256, np.int64)
    for b in range(256):
        c = b << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if c & top else (c << 1)
        out[b] = c & mask
    return out


CRC8 = crc_table(0x07, 8)
CRC16 = crc_table(0x8005, 16)


def crc_rows(buf: np.ndarray, starts, lengths, table: np.ndarray,
             width: int) -> np.ndarray:
    """CRC (init 0) of each byte range ``buf[s : s + n]``, all ranges at
    once: one step per byte position, across the ranges still open."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    mask = (1 << width) - 1
    order = np.argsort(-lengths, kind="stable")
    s_sorted, n_sorted = starts[order], lengths[order]
    crc = np.zeros(len(starts), np.int64)
    live = len(order)
    for i in range(int(n_sorted.max(initial=0))):
        while live and n_sorted[live - 1] <= i:
            live -= 1
        c = crc[:live]
        byte = buf[s_sorted[:live] + i].astype(np.int64)
        crc[:live] = ((c << 8) & mask) ^ table[(c >> (width - 8)) ^ byte]
    out = np.zeros(len(starts), np.int64)
    out[order] = crc
    return out
