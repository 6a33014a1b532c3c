"""Vorbis header parsing: identification, comment, and setup headers.

Analog of symphonia-codec-vorbis/src/lib.rs:75-144,408-770 and codebook.rs:
codebook synthesis (lengths -> canonical codewords -> VQ lookup tables),
floor 0/1 configs, residue 0/1/2 configs, mappings, and modes, all read
LSB-first (Vorbis I spec §4.2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..core.errors import DecodeError
from ..core.io.bits import BitReaderRtl
from ..core.io.codebook import Codebook

VORBIS_MAGIC = b"vorbis"


def ilog(x: int) -> int:
    """Vorbis ilog: position of highest set bit (ilog(0)=0, ilog(7)=3)."""
    return max(x, 0).bit_length()


def float32_unpack(x: int) -> float:
    """Vorbis packed float (spec §9.2.2)."""
    mantissa = x & 0x1FFFFF
    exponent = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(mantissa) * 2.0 ** (exponent - 788)


def lookup1_values(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries (spec §9.2.3)."""
    v = int(entries ** (1.0 / dims))
    while (v + 1) ** dims <= entries:
        v += 1
    while v**dims > entries:
        v -= 1
    return v


@dataclass
class VorbisCodebook:
    codebook: Codebook  # prefix code over used entries
    dims: int
    vq: Optional[np.ndarray]  # [entries, dims] float32, None if lookup 0


@dataclass
class Floor0Config:
    order: int
    rate: int
    bark_map_size: int
    amplitude_bits: int
    amplitude_offset: int
    books: List[int]


@dataclass
class Floor1Config:
    partition_class_list: List[int]
    class_dims: List[int]
    class_subclass_bits: List[int]
    class_masterbooks: List[int]
    subclass_books: List[List[int]]  # -1 = none
    multiplier: int
    x_list: List[int]
    # Derived: sort order and neighbors.
    sort_order: List[int] = field(default_factory=list)
    low_neighbors: List[int] = field(default_factory=list)
    high_neighbors: List[int] = field(default_factory=list)


@dataclass
class FloorConfig:
    kind: int  # 0 or 1
    f0: Optional[Floor0Config] = None
    f1: Optional[Floor1Config] = None


@dataclass
class ResidueConfig:
    kind: int  # 0, 1, 2
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    cascade: List[int]
    books: List[List[int]]  # [class][pass] -> book or -1


@dataclass
class MappingConfig:
    coupling_steps: List[Tuple[int, int]]  # (magnitude_ch, angle_ch)
    mux: List[int]  # channel -> submap
    submap_floor: List[int]
    submap_residue: List[int]


@dataclass
class ModeConfig:
    block_flag: bool
    mapping: int


@dataclass
class IdentHeader:
    n_channels: int
    sample_rate: int
    bs0_exp: int
    bs1_exp: int


@dataclass
class Setup:
    codebooks: List[VorbisCodebook]
    floors: List[FloorConfig]
    residues: List[ResidueConfig]
    mappings: List[MappingConfig]
    modes: List[ModeConfig]


def read_ident_header(data: bytes) -> IdentHeader:
    """Identification header (spec §4.2.2; lib.rs:75)."""
    if len(data) < 30 or data[0] != 1 or data[1:7] != VORBIS_MAGIC:
        raise DecodeError("invalid vorbis identification header")
    br = BitReaderRtl(data[7:])
    version = br.read_bits(32)
    if version != 0:
        raise DecodeError("unsupported vorbis version")
    n_channels = br.read_bits(8)
    sample_rate = br.read_bits(32)
    br.read_bits(32)  # bitrate_maximum
    br.read_bits(32)  # bitrate_nominal
    br.read_bits(32)  # bitrate_minimum
    bs0_exp = br.read_bits(4)
    bs1_exp = br.read_bits(4)
    if not (6 <= bs0_exp <= 13 and bs0_exp <= bs1_exp <= 13):
        raise DecodeError("invalid vorbis block sizes")
    if n_channels == 0 or sample_rate == 0:
        raise DecodeError("invalid vorbis channels/rate")
    if not br.read_bits(1):
        raise DecodeError("missing framing bit")
    return IdentHeader(n_channels, sample_rate, bs0_exp, bs1_exp)


def _read_codebook(br: BitReaderRtl, skim: bool = False) -> VorbisCodebook:
    """One codebook (spec §3.2; codebook.rs).

    ``skim`` walks the exact same bit layout but materializes nothing —
    the OGG mapper only needs the mode list at the end of the setup
    header (packet durations), not the codebooks themselves; the decoder
    re-parses fully at construction and reports any codebook errors.
    """
    if br.read_bits(24) != 0x564342:
        raise DecodeError("codebook sync lost")
    dims = br.read_bits(16)
    entries = br.read_bits(24)
    # Reference bounds (codebook.rs:232-245): dims 0 would divide by zero
    # in lookup1_values; the size caps bound in-memory VQ tables.
    if dims == 0:
        raise DecodeError("codebook dimension cannot be 0")
    if dims > 32:
        raise DecodeError("codebook dimension too large")
    if entries > 128 * 1024:
        raise DecodeError("codebook entries too large")
    ordered = br.read_bits(1)
    if skim and not ordered:
        if br.read_bits(1):  # sparse: per-entry presence flags
            for _ in range(entries):
                if br.read_bits(1):
                    br.ignore_bits(5)
        else:
            br.ignore_bits(entries * 5)
        lookup_type = br.read_bits(4)
        if lookup_type in (1, 2):
            br.ignore_bits(64)  # min/delta floats
            value_bits = br.read_bits(4) + 1
            br.read_bits(1)
            n_vals = (lookup1_values(entries, dims) if lookup_type == 1
                      else entries * dims)
            br.ignore_bits(n_vals * value_bits)
        elif lookup_type != 0:
            raise DecodeError("reserved codebook lookup type")
        return VorbisCodebook(None, dims, None)
    lengths = np.zeros(entries, dtype=np.int32)
    if not ordered:
        sparse = br.read_bits(1)
        if sparse:
            for i in range(entries):
                if br.read_bits(1):
                    lengths[i] = br.read_bits(5) + 1
        else:
            lengths[:] = br.read_bits_array(5, entries) + 1
    else:
        cur_entry = 0
        cur_len = br.read_bits(5) + 1
        while cur_entry < entries:
            num = br.read_bits(ilog(entries - cur_entry))
            if cur_entry + num > entries:
                raise DecodeError("ordered codebook overflow")
            lengths[cur_entry : cur_entry + num] = cur_len
            cur_entry += num
            cur_len += 1

    try:
        cb = Codebook.from_lengths_canonical(lengths)
    except ValueError as e:
        raise DecodeError(f"bad codebook: {e}") from e

    lookup_type = br.read_bits(4)
    vq = None
    if lookup_type in (1, 2):
        min_value = float32_unpack(br.read_bits(32))
        delta = float32_unpack(br.read_bits(32))
        value_bits = br.read_bits(4) + 1
        sequence_p = br.read_bits(1)
        if lookup_type == 1:
            lv = lookup1_values(entries, dims)
            mults = br.read_bits_array(value_bits, lv).astype(np.float64)
            # value[e][d] = mults[(e // lv**d) % lv] * delta + min (+cumsum)
            e = np.arange(entries)[:, None]
            d = np.arange(dims)[None, :]
            idx = (e // (lv ** d)) % lv if dims else np.zeros((entries, 0), int)
            vq = mults[idx] * delta + min_value
        else:
            count = entries * dims
            mults = br.read_bits_array(value_bits, count).astype(np.float64)
            vq = mults.reshape(entries, dims) * delta + min_value
        if sequence_p:
            vq = np.cumsum(vq, axis=1)
        vq = vq.astype(np.float32)
    elif lookup_type != 0:
        raise DecodeError("reserved codebook lookup type")
    return VorbisCodebook(cb, dims, vq)


def _read_floor(br: BitReaderRtl, n_codebooks: int) -> FloorConfig:
    ftype = br.read_bits(16)
    if ftype == 0:
        order = br.read_bits(8)
        rate = br.read_bits(16)
        bark_map_size = br.read_bits(16)
        amplitude_bits = br.read_bits(6)
        amplitude_offset = br.read_bits(8)
        num_books = br.read_bits(4) + 1
        books = [br.read_bits(8) for _ in range(num_books)]
        if any(b >= n_codebooks for b in books) or order < 1:
            raise DecodeError("invalid floor0 config")
        return FloorConfig(0, f0=Floor0Config(order, rate, bark_map_size,
                                              amplitude_bits, amplitude_offset,
                                              books))
    if ftype != 1:
        raise DecodeError("reserved floor type")
    partitions = br.read_bits(5)
    pcl = [br.read_bits(4) for _ in range(partitions)]
    max_class = max(pcl) if pcl else -1
    dims, sub_bits, masterbooks, sub_books = [], [], [], []
    for _ in range(max_class + 1):
        d = br.read_bits(3) + 1
        s = br.read_bits(2)
        mb = br.read_bits(8) if s else -1
        if mb >= n_codebooks:
            raise DecodeError("invalid floor1 masterbook")
        bl = []
        for _ in range(1 << s):
            b = br.read_bits(8) - 1
            if b >= n_codebooks:
                raise DecodeError("invalid floor1 subclass book")
            bl.append(b)
        dims.append(d)
        sub_bits.append(s)
        masterbooks.append(mb)
        sub_books.append(bl)
    multiplier = br.read_bits(2) + 1
    rangebits = br.read_bits(4)
    x_list = [0, 1 << rangebits]
    for p in range(partitions):
        for _ in range(dims[pcl[p]]):
            x_list.append(br.read_bits(rangebits))
    if len(x_list) > 65 or len(set(x_list)) != len(x_list):
        raise DecodeError("invalid floor1 X list")
    cfg = Floor1Config(pcl, dims, sub_bits, masterbooks, sub_books,
                       multiplier, x_list)
    # Derived: sort order + neighbors (spec low/high_neighbor).
    n = len(x_list)
    cfg.sort_order = sorted(range(n), key=lambda i: x_list[i])
    for i in range(n):
        low, high = 0, 1
        if i >= 2:
            lx, hx = -1, 1 << 30
            for j in range(i):
                if lx < x_list[j] < x_list[i]:
                    lx, low = x_list[j], j
                if x_list[i] < x_list[j] < hx:
                    hx, high = x_list[j], j
        cfg.low_neighbors.append(low)
        cfg.high_neighbors.append(high)
    return FloorConfig(1, f1=cfg)


def _read_residue(br: BitReaderRtl, n_codebooks: int) -> ResidueConfig:
    rtype = br.read_bits(16)
    if rtype > 2:
        raise DecodeError("reserved residue type")
    begin = br.read_bits(24)
    end = br.read_bits(24)
    psize = br.read_bits(24) + 1
    nclass = br.read_bits(6) + 1
    classbook = br.read_bits(8)
    if classbook >= n_codebooks:
        raise DecodeError("invalid residue classbook")
    cascade = []
    for _ in range(nclass):
        low = br.read_bits(3)
        high = br.read_bits(5) if br.read_bits(1) else 0
        cascade.append((high << 3) | low)
    books = []
    for c in range(nclass):
        row = []
        for p in range(8):
            if cascade[c] & (1 << p):
                b = br.read_bits(8)
                if b >= n_codebooks:
                    raise DecodeError("invalid residue book")
                row.append(b)
            else:
                row.append(-1)
        books.append(row)
    return ResidueConfig(rtype, begin, end, psize, nclass, classbook, cascade, books)


def _read_mapping(br: BitReaderRtl, n_channels: int, n_floors: int, n_residues: int) -> MappingConfig:
    mtype = br.read_bits(16)
    if mtype != 0:
        raise DecodeError("reserved mapping type")
    submaps = br.read_bits(4) + 1 if br.read_bits(1) else 1
    coupling = []
    if br.read_bits(1):
        steps = br.read_bits(8) + 1
        bits = ilog(n_channels - 1)
        for _ in range(steps):
            mag = br.read_bits(bits)
            ang = br.read_bits(bits)
            if mag == ang or mag >= n_channels or ang >= n_channels:
                raise DecodeError("invalid coupling step")
            coupling.append((mag, ang))
    if br.read_bits(2):
        raise DecodeError("mapping reserved bits set")
    if submaps > 1:
        mux = [br.read_bits(4) for _ in range(n_channels)]
        if any(m >= submaps for m in mux):
            raise DecodeError("invalid mapping mux")
    else:
        mux = [0] * n_channels
    sm_floor, sm_residue = [], []
    for _ in range(submaps):
        br.read_bits(8)  # unused time config
        f = br.read_bits(8)
        r = br.read_bits(8)
        if f >= n_floors or r >= n_residues:
            raise DecodeError("invalid submap floor/residue")
        sm_floor.append(f)
        sm_residue.append(r)
    return MappingConfig(coupling, mux, sm_floor, sm_residue)


def read_setup_header(data: bytes, ident: IdentHeader,
                      skim: bool = False) -> Setup:
    """Setup header (spec §4.2.4; lib.rs:408-770). ``skim`` skips
    codebook/VQ materialization (bit-exact walk) — for consumers that
    only need floors/residues/mappings/modes (the OGG mapper)."""
    if len(data) < 7 or data[0] != 5 or data[1:7] != VORBIS_MAGIC:
        raise DecodeError("invalid vorbis setup header")
    br = BitReaderRtl(data[7:])

    n_books = br.read_bits(8) + 1
    codebooks = [_read_codebook(br, skim) for _ in range(n_books)]

    # Time domain transforms: all zero in Vorbis I.
    for _ in range(br.read_bits(6) + 1):
        if br.read_bits(16) != 0:
            raise DecodeError("nonzero time transform")

    floors = [_read_floor(br, n_books) for _ in range(br.read_bits(6) + 1)]
    residues = [_read_residue(br, n_books) for _ in range(br.read_bits(6) + 1)]
    mappings = [
        _read_mapping(br, ident.n_channels, len(floors), len(residues))
        for _ in range(br.read_bits(6) + 1)
    ]
    modes = []
    for _ in range(br.read_bits(6) + 1):
        block_flag = bool(br.read_bits(1))
        if br.read_bits(16) != 0 or br.read_bits(16) != 0:
            raise DecodeError("nonzero window/transform type")
        mapping = br.read_bits(8)
        if mapping >= len(mappings):
            raise DecodeError("invalid mode mapping")
        modes.append(ModeConfig(block_flag, mapping))
    if not br.read_bits(1):
        raise DecodeError("missing setup framing bit")
    return Setup(codebooks, floors, residues, mappings, modes)
