"""Minimal Vorbis mirror encoder for floor-0 / residue-0 structural tests.

Emits identification + setup headers and audio packets for a mono,
single-mode (short-block) stream whose setup uses floor type 0 (LSP
curve, spec §6.2) and residue type 0 (interleaved partitions, §8.6.2) —
paths no real-world fixture in this image exercises (house_lo.ogg is
floor 1 / residue 2). All codebooks use equal code lengths, so the
canonical codeword for entry i is simply i (written MSb-first, Vorbis I
§3.2.1) and the builder stays independent of the decoder's codebook
synthesis. Independent of decoder code.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

RATE = 8000
BS_EXP = 8          # 256-sample blocks, n2 = 128
N2 = 128
ORDER = 4           # floor0 LSP order
AMP_BITS = 6
AMP_OFFSET = 10
BARK_SIZE = 64
PART_SIZE = 8       # residue partition size
N_PARTS = N2 // PART_SIZE

# Floor0 VQ book (book 0): dims=2, 16 entries, lookup type 1.
F0_LV = 4                      # lookup1_values(16, 2)
F0_MULTS = [0, 1, 2, 3]        # value_bits = 2
F0_MIN = 0.25                  # mantissa 1, exp 786 (1 * 2^-2)
F0_DELTA = 0.25

# Residue VQ book (book 2): dims=2, 16 entries, lookup type 2.
R_MULTS = [(i * 3 + 1) % 8 for i in range(32)]  # value_bits = 3
R_MIN = -3.5                   # sign 1, mantissa 7, exp 787 (7 * 2^-1)
R_DELTA = 1.0                  # mantissa 1, exp 788


class BitWriterLsb:
    """LSB-first packer (the Vorbis bit order: first bit written lands in
    the least-significant bit of the first byte)."""

    def __init__(self):
        self.bits: List[int] = []

    def write(self, val: int, n: int) -> None:
        for i in range(n):
            self.bits.append((val >> i) & 1)

    def write_codeword(self, val: int, length: int) -> None:
        """Huffman codewords are consumed MSb-of-codeword first."""
        for i in range(length - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def to_bytes(self) -> bytes:
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def float32_pack(mantissa: int, exponent: int, sign: int) -> int:
    """Inverse of the spec §9.2.2 unpack: value = ±mantissa * 2^(exp-788)."""
    return (sign << 31) | (exponent << 21) | mantissa


def f0_vq(entry: int) -> np.ndarray:
    """Decoder-visible VQ row of floor0 book entry (float64 build then f32,
    matching _read_codebook's lookup-1 math)."""
    m = np.array([F0_MULTS[entry % F0_LV], F0_MULTS[(entry // F0_LV) % F0_LV]],
                 dtype=np.float64)
    return (m * F0_DELTA + F0_MIN).astype(np.float32)


def r_vq(entry: int) -> np.ndarray:
    m = np.array(R_MULTS[2 * entry : 2 * entry + 2], dtype=np.float64)
    return (m * R_DELTA + R_MIN).astype(np.float32)


def build_ident_header() -> bytes:
    bw = BitWriterLsb()
    bw.write(0, 32)          # version
    bw.write(1, 8)           # channels
    bw.write(RATE, 32)
    bw.write(0, 32)          # bitrate max
    bw.write(0, 32)          # bitrate nominal
    bw.write(0, 32)          # bitrate min
    bw.write(BS_EXP, 4)
    bw.write(BS_EXP, 4)
    bw.write(1, 1)           # framing
    return b"\x01vorbis" + bw.to_bytes()


def _write_codebook(bw: BitWriterLsb, dims: int, entries: int, length: int,
                    lookup: int, value_bits: int = 0,
                    min_pack: int = 0, delta_pack: int = 0,
                    mults: Optional[List[int]] = None) -> None:
    bw.write(0x564342, 24)   # sync
    bw.write(dims, 16)
    bw.write(entries, 24)
    bw.write(0, 1)           # not ordered
    bw.write(0, 1)           # not sparse
    for _ in range(entries):
        bw.write(length - 1, 5)
    bw.write(lookup, 4)
    if lookup in (1, 2):
        bw.write(min_pack, 32)
        bw.write(delta_pack, 32)
        bw.write(value_bits - 1, 4)
        bw.write(0, 1)       # sequence_p
        for m in mults:
            bw.write(m, value_bits)


def build_setup_header() -> bytes:
    bw = BitWriterLsb()
    bw.write(2, 8)  # 3 codebooks
    # Book 0: floor0 VQ (dims 2, 16 entries, len 4, lookup 1).
    _write_codebook(bw, 2, 16, 4, 1, value_bits=2,
                    min_pack=float32_pack(1, 786, 0),
                    delta_pack=float32_pack(1, 786, 0),
                    mults=F0_MULTS)
    # Book 1: residue classbook (dims 2, 4 entries, len 2, lookup 0).
    _write_codebook(bw, 2, 4, 2, 0)
    # Book 2: residue VQ (dims 2, 16 entries, len 4, lookup 2).
    _write_codebook(bw, 2, 16, 4, 2, value_bits=3,
                    min_pack=float32_pack(7, 787, 1),
                    delta_pack=float32_pack(1, 788, 0),
                    mults=R_MULTS)
    # Time transforms: one, type 0.
    bw.write(0, 6)
    bw.write(0, 16)
    # One floor: type 0.
    bw.write(0, 6)
    bw.write(0, 16)          # floor type
    bw.write(ORDER, 8)
    bw.write(RATE, 16)
    bw.write(BARK_SIZE, 16)
    bw.write(AMP_BITS, 6)
    bw.write(AMP_OFFSET, 8)
    bw.write(0, 4)           # num_books - 1
    bw.write(0, 8)           # book 0
    # One residue: type 0.
    bw.write(0, 6)
    bw.write(0, 16)          # residue type
    bw.write(0, 24)          # begin
    bw.write(N2, 24)         # end
    bw.write(PART_SIZE - 1, 24)
    bw.write(1, 6)           # classifications - 1 = 1 (2 classes)
    bw.write(1, 8)           # classbook = book 1
    for _ in range(2):       # cascade: pass-0 bit only
        bw.write(1, 3)
        bw.write(0, 1)
    for _ in range(2):       # books[class][0] = book 2
        bw.write(2, 8)
    # One mapping: type 0, 1 submap, no coupling.
    bw.write(0, 6)
    bw.write(0, 16)
    bw.write(0, 1)           # submaps flag
    bw.write(0, 1)           # coupling flag
    bw.write(0, 2)           # reserved
    bw.write(0, 8)           # time config (unused)
    bw.write(0, 8)           # submap floor
    bw.write(0, 8)           # submap residue
    # One mode: short block, mapping 0.
    bw.write(0, 6)
    bw.write(0, 1)           # block_flag
    bw.write(0, 16)
    bw.write(0, 16)
    bw.write(0, 8)
    bw.write(1, 1)           # framing
    return b"\x05vorbis" + bw.to_bytes()


def build_audio_packet(
    amplitude: int,
    floor_entries: Tuple[int, int],
    class_entries: List[int],
    part_entries: List[List[int]],
) -> bytes:
    """One audio packet. ``amplitude`` 0 emits an unused floor (and no
    residue bits — the channel is do-not-decode). ``class_entries`` are
    the N_PARTS//2 classbook entries (2 classwords each);
    ``part_entries`` is one list of 4 residue-book entries per partition
    whose class has a pass-0 book (both classes do here)."""
    bw = BitWriterLsb()
    bw.write(0, 1)           # audio packet
    # single mode: 0 mode bits; short block: no window flags
    bw.write(amplitude, AMP_BITS)
    if amplitude == 0:
        return bw.to_bytes()
    bw.write(0, 1)           # book index (ilog(1) = 1 bit)
    for e in floor_entries:
        bw.write_codeword(e, 4)
    it = iter(part_entries)
    for cw in class_entries:
        bw.write_codeword(cw, 2)
        for _ in range(2):   # the 2 partitions classified by this codeword
            for e in next(it):
                bw.write_codeword(e, 4)
    return bw.to_bytes()


def expected_residue(class_entries: List[int], part_entries: List[List[int]]
                     ) -> np.ndarray:
    """Independent reconstruction of the residue vector from the emitted
    entries (spec §8.6.2 format 0: stride-interleaved adds)."""
    v = np.zeros(N2, dtype=np.float32)
    it = iter(part_entries)
    for ci, _cw in enumerate(class_entries):
        for k in range(2):
            pc = ci * 2 + k
            off = pc * PART_SIZE
            step = PART_SIZE // 2
            for i, e in enumerate(next(it)):
                v[off + i : off + i + 2 * step : step] += r_vq(e)
    return v


def random_packet(rng) -> tuple:
    """(packet bytes, amplitude, floor_entries, class_entries, part_entries)."""
    amplitude = int(rng.integers(1, 1 << AMP_BITS))
    # Ascending-accumulating LSP coefficients stay in (0, pi): entries
    # whose VQ rows are positive (all are: min 0.25).
    floor_entries = (int(rng.integers(0, 16)), int(rng.integers(0, 16)))
    class_entries = [int(rng.integers(0, 4)) for _ in range(N_PARTS // 2)]
    part_entries = [[int(rng.integers(0, 16)) for _ in range(4)]
                    for _ in range(N_PARTS)]
    pkt = build_audio_packet(amplitude, floor_entries, class_entries,
                             part_entries)
    return pkt, amplitude, floor_entries, class_entries, part_entries


def build_stream(n_packets: int, seed: int = 0):
    """Returns (extra_data id+setup concatenation, [packet bytes],
    [per-packet emitted-entry tuples])."""
    rng = np.random.default_rng(seed)
    extra = build_ident_header() + build_setup_header()
    pkts, info = [], []
    for i in range(n_packets):
        if i % 5 == 3:
            pkts.append(build_audio_packet(0, (0, 0), [], []))
            info.append((0, None, None, None))
        else:
            p, amp, fe, ce, pe = random_packet(rng)
            pkts.append(p)
            info.append((amp, fe, ce, pe))
    return extra, pkts, info


# ---------------------------------------------------------------------------
# Stereo variant: coupling + residue type 2 + two block sizes.
# house_lo.ogg exercises none of these (mono, floor1/residue1, single
# short mode), so this variant is the only coverage for square-polar
# coupling, residue-2 channel interleave, and long-block window flags.
# ---------------------------------------------------------------------------

BS1_EXP = 9          # long blocks: 512 samples, n2 = 256
N2_LONG = 256
R2_END = 2 * N2_LONG  # residue end covers the long block; short clips


def build_ident_header_stereo() -> bytes:
    bw = BitWriterLsb()
    bw.write(0, 32)
    bw.write(2, 8)
    bw.write(RATE, 32)
    bw.write(0, 96)
    bw.write(BS_EXP, 4)
    bw.write(BS1_EXP, 4)
    bw.write(1, 1)
    return b"\x01vorbis" + bw.to_bytes()


def build_setup_header_stereo() -> bytes:
    bw = BitWriterLsb()
    bw.write(2, 8)  # 3 codebooks (same books as the mono variant)
    _write_codebook(bw, 2, 16, 4, 1, value_bits=2,
                    min_pack=float32_pack(1, 786, 0),
                    delta_pack=float32_pack(1, 786, 0),
                    mults=F0_MULTS)
    _write_codebook(bw, 2, 4, 2, 0)
    _write_codebook(bw, 2, 16, 4, 2, value_bits=3,
                    min_pack=float32_pack(7, 787, 1),
                    delta_pack=float32_pack(1, 788, 0),
                    mults=R_MULTS)
    bw.write(0, 6)
    bw.write(0, 16)          # one time transform, type 0
    # One floor: type 0 (as mono variant).
    bw.write(0, 6)
    bw.write(0, 16)
    bw.write(ORDER, 8)
    bw.write(RATE, 16)
    bw.write(BARK_SIZE, 16)
    bw.write(AMP_BITS, 6)
    bw.write(AMP_OFFSET, 8)
    bw.write(0, 4)
    bw.write(0, 8)
    # One residue: type 2.
    bw.write(0, 6)
    bw.write(2, 16)
    bw.write(0, 24)          # begin
    bw.write(R2_END, 24)     # end (clipped to n_ch*n2 for short blocks)
    bw.write(PART_SIZE - 1, 24)
    bw.write(1, 6)           # 2 classes
    bw.write(1, 8)           # classbook
    for _ in range(2):
        bw.write(1, 3)
        bw.write(0, 1)
    for _ in range(2):
        bw.write(2, 8)
    # One mapping: 1 submap, one coupling step (mag 0, ang 1).
    bw.write(0, 6)
    bw.write(0, 16)
    bw.write(0, 1)           # submaps flag (1 submap)
    bw.write(1, 1)           # coupling flag
    bw.write(0, 8)           # steps - 1
    bw.write(0, 1)           # magnitude ch (ilog(1) = 1 bit)
    bw.write(1, 1)           # angle ch
    bw.write(0, 2)           # reserved
    bw.write(0, 8)
    bw.write(0, 8)           # submap floor
    bw.write(0, 8)           # submap residue
    # Two modes: short and long.
    bw.write(1, 6)
    bw.write(0, 1)           # mode 0: short
    bw.write(0, 16)
    bw.write(0, 16)
    bw.write(0, 8)
    bw.write(1, 1)           # mode 1: long
    bw.write(0, 16)
    bw.write(0, 16)
    bw.write(0, 8)
    bw.write(1, 1)           # framing
    return b"\x05vorbis" + bw.to_bytes()


def build_audio_packet_stereo(
    long_block: bool,
    amps: Tuple[int, int],
    floor_entries: Tuple[Tuple[int, int], Tuple[int, int]],
    class_entries: List[int],
    part_entries: List[List[int]],
) -> bytes:
    """Stereo packet: mode bit, window flags (long), two floor0 channels,
    one interleaved residue-2 vector (decoded unless both floors are
    unused — coupling propagates not-do-not-decode to both channels)."""
    bw = BitWriterLsb()
    bw.write(0, 1)
    bw.write(1 if long_block else 0, 1)   # mode number (ilog(1) = 1 bit)
    if long_block:
        bw.write(0, 1)                    # prev window flag
        bw.write(0, 1)                    # next window flag
    for ch in range(2):
        bw.write(amps[ch], AMP_BITS)
        if amps[ch]:
            bw.write(0, 1)
            for e in floor_entries[ch]:
                bw.write_codeword(e, 4)
    if amps[0] == 0 and amps[1] == 0:
        return bw.to_bytes()
    it = iter(part_entries)
    for cw in class_entries:
        bw.write_codeword(cw, 2)
        for _ in range(2):
            for e in next(it):
                bw.write_codeword(e, 4)
    return bw.to_bytes()


def expected_stereo_residue(long_block: bool, class_entries: List[int],
                            part_entries: List[List[int]]) -> np.ndarray:
    """[2, n2] residue after inverse coupling, reconstructed from the
    emitted entries (spec §8.6.2 format 2 deinterleave + §4.3.4 square
    polar), independent of decoder code."""
    n2 = N2_LONG if long_block else N2
    n = 2 * n2
    flat = np.zeros(n, dtype=np.float32)
    it = iter(part_entries)
    for ci, _cw in enumerate(class_entries):
        for k in range(2):
            off = (ci * 2 + k) * PART_SIZE
            i = 0
            for e in next(it):
                flat[off + i : off + i + 2] += r_vq(e)
                i += 2
    res = flat.reshape(n2, 2).T.copy()
    m, a = res[0].copy(), res[1].copy()
    new_m = np.empty_like(m)
    new_a = np.empty_like(a)
    for i in range(n2):
        if m[i] > 0:
            if a[i] > 0:
                new_m[i], new_a[i] = m[i], m[i] - a[i]
            else:
                new_m[i], new_a[i] = m[i] + a[i], m[i]
        else:
            if a[i] > 0:
                new_m[i], new_a[i] = m[i], m[i] + a[i]
            else:
                new_m[i], new_a[i] = m[i] - a[i], m[i]
    return np.stack([new_m, new_a])


def n_parts_stereo(long_block: bool) -> int:
    return (2 * (N2_LONG if long_block else N2)) // PART_SIZE


def build_stream_stereo(n_packets: int, seed: int = 0):
    """Returns (extra_data, [packets], [(long_block, amps, fe, ce, pe)])."""
    rng = np.random.default_rng(seed)
    extra = build_ident_header_stereo() + build_setup_header_stereo()
    pkts, info = [], []
    for i in range(n_packets):
        long_block = bool(rng.integers(0, 2))
        if i % 6 == 4:
            amps = (0, 0)
            pkt = build_audio_packet_stereo(long_block, amps,
                                            ((0, 0), (0, 0)), [], [])
            pkts.append(pkt)
            info.append((long_block, amps, None, None, None))
            continue
        # One channel's floor is periodically unused; residue still
        # decodes for both (coupling propagation).
        amp0 = 0 if i % 6 == 1 else int(rng.integers(1, 1 << AMP_BITS))
        amps = (amp0, int(rng.integers(1, 1 << AMP_BITS)))
        fe = tuple((int(rng.integers(0, 16)), int(rng.integers(0, 16)))
                   for _ in range(2))
        parts = n_parts_stereo(long_block)
        ce = [int(rng.integers(0, 4)) for _ in range(parts // 2)]
        pe = [[int(rng.integers(0, 16)) for _ in range(4)]
              for _ in range(parts)]
        pkts.append(build_audio_packet_stereo(long_block, amps, fe, ce, pe))
        info.append((long_block, amps, fe, ce, pe))
    return extra, pkts, info
