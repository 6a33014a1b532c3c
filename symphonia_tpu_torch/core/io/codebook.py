"""Huffman / VLC codebooks.

Analog of the reference's multi-level LUT codebook (symphonia-core/src/io/
bit.rs:18-495: ``Codebook``, ``Entry::Jump/Value``, ``CodebookBuilder``).

Two decode surfaces:

* a scalar tree-walk ``decode_ltr``/``decode_rtl`` used for host header
  parsing and as the test oracle, and
* a flat multi-level lookup table (``build_lut``) of uniform ``block_bits``
  blocks — the layout the native C++ entropy stages (``native/*.cpp``)
  mirror with their two-level LUTs and packed single-probe fast tables.

Codewords are canonical MSB-first integers. Vorbis codebooks (lengths only)
get codewords assigned with the Vorbis canonical algorithm
(reference: symphonia-codec-vorbis/src/codebook.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BitOrder:
    MSB = "msb"  # FLAC/MP3/AAC/ALAC bit order
    LSB = "lsb"  # Vorbis bit order (bit *packing*; codewords still MSB-first)


@dataclass
class Codebook:
    """An immutable prefix-code table.

    ``codes[i]`` is the MSB-first codeword of length ``lens[i]`` mapping to
    ``values[i]``.
    """

    codes: np.ndarray  # uint32
    lens: np.ndarray  # uint8
    values: np.ndarray  # int32
    max_len: int
    _tree: Optional[Dict[Tuple[int, int], int]] = field(default=None, repr=False)
    _lut: Optional[Tuple[np.ndarray, np.ndarray, int]] = field(default=None, repr=False)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_codes(
        codes: Sequence[int], lens: Sequence[int], values: Sequence[int]
    ) -> "Codebook":
        codes_a = np.asarray(codes, dtype=np.uint32)
        lens_a = np.asarray(lens, dtype=np.uint8)
        values_a = np.asarray(values, dtype=np.int32)
        if not (len(codes_a) == len(lens_a) == len(values_a)):
            raise ValueError("codes/lens/values length mismatch")
        max_len = int(lens_a.max()) if len(lens_a) else 0
        return Codebook(codes_a, lens_a, values_a, max_len)

    @staticmethod
    def from_lengths_canonical(
        lengths: Sequence[int], values: Optional[Sequence[int]] = None
    ) -> "Codebook":
        """Assign canonical codewords from lengths (Vorbis algorithm).

        Entries with length 0 are unused (sparse codebooks). Mirrors
        symphonia-codec-vorbis/src/codebook.rs synthesis: shortest codes
        first, each next codeword is the lowest available branch.
        """
        # Native fast path: the identical loop in C++ (sh_codebook_assign;
        # ~40 codebooks per Vorbis setup make this construction-time hot).
        # Any failure falls through to the Python loop below.
        try:
            from ... import native as _native

            got = _native.codebook_assign(np.asarray(lengths, np.int32))
        except Exception:
            got = None
        if got is not None:
            codes_n, st = got
            if st == 1:
                raise ValueError("over-specified codebook")
            if st == 2:
                raise ValueError("under-specified codebook")
            if st == 3:
                raise ValueError("invalid codeword length")
            lens_n = np.asarray(lengths, np.int64)
            mask = lens_n > 0
            if not mask.any():
                return Codebook.from_codes([], [], [])
            vals_n = (np.arange(len(lens_n), dtype=np.int64)[mask]
                      if values is None
                      else np.asarray(values, np.int64)[mask])
            return Codebook.from_codes(
                codes_n[mask].astype(np.int64), lens_n[mask], vals_n)
        # Python ints only below: numpy int32 lengths would drag the >>
        # arithmetic into int32 and overflow on left-aligned codes.
        if isinstance(lengths, np.ndarray):
            lengths = lengths.tolist()
        if values is None:
            values = list(range(len(lengths)))
        # Left-aligned branch-splitting assignment (the classic canonical
        # Huffman construction; equivalent to the reference's synthesis in
        # symphonia-codec-vorbis/src/codebook.rs). ``available[l]`` holds a
        # free left-aligned 32-bit branch point at depth ``l`` (0 = none).
        used: List[Tuple[int, int, int]] = []  # (code, len, value)
        available = [0] * 33
        first = True
        for val, ln in zip(values, lengths):
            if ln == 0:
                continue
            if not 1 <= ln <= 32:
                raise ValueError(f"invalid codeword length {ln}")
            if first:
                code_aligned = 0
                for j in range(1, ln + 1):
                    available[j] = 1 << (32 - j)
                first = False
            else:
                y = ln
                while y > 0 and available[y] == 0:
                    y -= 1
                if y == 0:
                    raise ValueError("over-specified codebook")
                code_aligned = available[y]
                available[y] = 0
                for j in range(y + 1, ln + 1):
                    available[j] = code_aligned + (1 << (32 - j))
            used.append((code_aligned >> (32 - ln), ln, val))
        if not used:
            return Codebook.from_codes([], [], [])
        if len(used) > 1 and any(available[1:]):
            raise ValueError("under-specified codebook")
        codes_a = [c for c, _, _ in used]
        lens_a = [l for _, l, _ in used]
        vals_a = [v for _, _, v in used]
        return Codebook.from_codes(codes_a, lens_a, vals_a)

    # -- scalar decode (oracle) --------------------------------------------

    def _ensure_tree(self) -> Dict[Tuple[int, int], int]:
        if self._tree is None:
            tree = {}
            for c, l, v in zip(
                self.codes.tolist(), self.lens.tolist(), self.values.tolist()
            ):
                tree[(int(l), int(c))] = int(v)
            object.__setattr__(self, "_tree", tree)
        return self._tree

    def decode_ltr(self, reader) -> int:
        """Decode one symbol from an MSB-first bit reader."""
        tree = self._ensure_tree()
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | reader.read_bit()
            v = tree.get((ln, code))
            if v is not None:
                return v
        raise ValueError("invalid codeword")

    # Vorbis packs bits LSB-first but codewords are still walked MSB-first,
    # one bit at a time — the identical tree walk applies.
    decode_rtl = decode_ltr

    # -- vectorized LUT ----------------------------------------------------

    def build_lut(self, block_bits: int = 8) -> Tuple[np.ndarray, np.ndarray, int]:
        """Build the flat multi-level LUT (bit.rs CodebookBuilder:217-460).

        Returns ``(lut_val int32, lut_len int8, block_bits)``. The LUT is a
        concatenation of 2**block_bits-entry tables. For index ``i`` in a
        table at base ``b``: if ``lut_len[b+i] > 0`` the entry is a leaf
        consuming ``lut_len`` bits with symbol ``lut_val``; if ``lut_len ==
        0`` then ``lut_val`` is the base of the next-level table (consume
        ``block_bits`` bits and continue); if ``lut_len < 0`` the prefix is
        invalid.
        """
        if self._lut is not None and self._lut[2] == block_bits:
            return self._lut
        size = 1 << block_bits
        entries = list(
            zip(self.codes.tolist(), self.lens.tolist(), self.values.tolist())
        )

        tables: List[Tuple[np.ndarray, np.ndarray]] = []

        def build_table(prefix_entries, depth) -> int:
            """Build table for codes with their first depth*block_bits bits
            stripped; returns table index."""
            val = np.zeros(size, dtype=np.int32)
            ln = np.full(size, -1, dtype=np.int8)
            idx = len(tables)
            tables.append((val, ln))
            # group longer codes by their next block_bits prefix
            subgroups: Dict[int, list] = {}
            for code, clen, v in prefix_entries:
                if clen <= block_bits:
                    base = (code << (block_bits - clen)) & (size - 1)
                    for i in range(1 << (block_bits - clen)):
                        val[base + i] = v
                        ln[base + i] = clen
                else:
                    pre = (code >> (clen - block_bits)) & (size - 1)
                    rem_code = code & ((1 << (clen - block_bits)) - 1)
                    subgroups.setdefault(pre, []).append((rem_code, clen - block_bits, v))
            for pre, group in subgroups.items():
                sub_idx = build_table(group, depth + 1)
                val[pre] = sub_idx * size
                ln[pre] = 0
            return idx

        if entries:
            build_table(entries, 0)
        else:
            tables.append(
                (np.zeros(size, dtype=np.int32), np.full(size, -1, dtype=np.int8))
            )
        lut_val = np.concatenate([t[0] for t in tables])
        lut_len = np.concatenate([t[1] for t in tables])
        lut = (lut_val, lut_len.astype(np.int8), block_bits)
        object.__setattr__(self, "_lut", lut)
        return lut

    def __len__(self) -> int:
        return len(self.codes)


class CodebookBuilder:
    """Incremental builder mirroring bit.rs CodebookBuilder:217."""

    def __init__(self, bit_order: str = BitOrder.MSB):
        self.bit_order = bit_order
        self._codes: List[int] = []
        self._lens: List[int] = []
        self._values: List[int] = []

    def add(self, code: int, length: int, value: int) -> None:
        self._codes.append(code)
        self._lens.append(length)
        self._values.append(value)

    def finish(self) -> Codebook:
        return Codebook.from_codes(self._codes, self._lens, self._values)
