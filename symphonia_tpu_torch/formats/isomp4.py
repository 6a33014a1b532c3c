"""ISO Base Media File Format (MP4/M4A) demuxer.

Analog of symphonia-format-isomp4 (``IsoMp4Reader``, demuxer.rs:137): atom
tree walk (atoms/mod.rs), sample description -> codec parameters incl.
esds/ALAC/FLAC/Opus entries (stsd.rs, esds.rs), sample lookup over the
stts/stsc/stsz/stco/co64 tables (stream.rs:33-483), fragmented moof/traf/
trun segments (stream.rs:83-331, trun.rs), edit-list delay (elst.rs),
iTunes ``ilst`` metadata (ilst.rs), and table-driven seek (demuxer.rs:500).

Batch-first: the sample tables are expanded once into flat numpy arrays
(offset/size/ts per sample) which *are* the packet table.
"""

from __future__ import annotations

import bisect
import struct
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.audio import Channels
from ..core.codecs import (
    CODEC_ID_AAC,
    CODEC_ID_AC3,
    CODEC_ID_ALAC,
    CODEC_ID_EAC3,
    CODEC_ID_FLAC,
    CODEC_ID_MP3,
    CODEC_ID_OPUS,
    AudioCodecParameters,
    CODEC_ID_PCM_F32BE, CODEC_ID_PCM_F32LE, CODEC_ID_PCM_F64BE,
    CODEC_ID_PCM_F64LE, CODEC_ID_PCM_S16BE, CODEC_ID_PCM_S16LE,
    CODEC_ID_PCM_S24BE, CODEC_ID_PCM_S24LE, CODEC_ID_PCM_S32BE,
    CODEC_ID_PCM_S32LE, CODEC_ID_PCM_S8, CODEC_ID_PCM_U8,
    CODEC_ID_PCM_U16BE, CODEC_ID_PCM_U16LE, CODEC_ID_PCM_U24BE,
    CODEC_ID_PCM_U24LE, CODEC_ID_PCM_U32BE, CODEC_ID_PCM_U32LE,
)
from ..core.errors import DecodeError, EndOfStream, SeekError, Unsupported
from ..core.formats import (
    FormatOptions,
    FormatReader,
    PacketTable,
    SeekTo,
    SeekedTo,
    Track,
)
from ..core.meta import MetadataLog, MetadataRevision, RawTag, StandardTagKey as K, Visual
from ..core.packet import Packet
from ..core.probe import Descriptor
from ..core.units import TimeBase

_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta", b"edts",
    b"dinf", b"mvex", b"moof", b"traf",
}

# DoS bounds for trun sample-row materialization. Zero-size samples
# consume no stream bytes, so byte anchors cannot bound them — and each
# row costs real list/scheduling work (a soak-found 2 KB pipe input
# claimed 5x5.7M zero-size samples: 29 s). No real audio stream carries
# more than a handful of empty samples.
_TRUN_EMPTY_SAMPLE_CAP = 1 << 16
# On a pipe the stream length is unknown (a 16 MiB size is assumed), so
# byte anchors alone still admit millions of 1-byte samples; cap the
# cumulative materialized rows instead (2M samples = 12+ h of 48 kHz AAC
# — far beyond any real streamed program).
_PIPE_SAMPLE_CAP = 1 << 21

# Version 0/1 PCM sample entries: fourcc -> (codec id, bytes/sample),
# mirroring pcm_codec_id (stsd.rs:356-367). Packets are coalesced per
# chunk (every MP4 sample is one PCM frame).
_MP4_PCM = {
    b"raw ": (CODEC_ID_PCM_U8, 1),
    b"twos": (CODEC_ID_PCM_S16BE, 2),
    b"sowt": (CODEC_ID_PCM_S16LE, 2),
    b"in24": (CODEC_ID_PCM_S24LE, 3),
    b"in32": (CODEC_ID_PCM_S32LE, 4),
    b"fl32": (CODEC_ID_PCM_F32LE, 4),
    b"fl64": (CODEC_ID_PCM_F64LE, 8),
}

# Visual sample entries: fourcc -> experimental video codec id
# (stsd.rs:87-95 VisualSampleEntry arm); tracks are described via
# other_tracks(), not demuxed, matching the MKV V_* handling.
_MP4_VIDEO = {
    b"av01": "av1", b"avc1": "h264", b"dvh1": "hevc", b"dvhe": "hevc",
    b"hev1": "hevc", b"hvc1": "hevc", b"mp4v": "mpeg4video",
    b"vp08": "vp8", b"vp09": "vp9",
}

# Subtitle sample entries (stsd.rs:99-101): tx3g carries MOV timed text.
_MP4_SUBTITLE = {b"tx3g": "mov_text", b"text": None, b"stpp": None}


def _lpcm_codec_id(bits: int, flags: int) -> Optional[str]:
    """Version-2 `lpcm` sample-format flags -> codec id (stsd.rs:386-430)."""
    is_float = bool(flags & 0x1)
    be = bool(flags & 0x2)
    signed = bool(flags & 0x4)
    if is_float:
        return {(32, True): CODEC_ID_PCM_F32BE, (64, True): CODEC_ID_PCM_F64BE,
                (32, False): CODEC_ID_PCM_F32LE,
                (64, False): CODEC_ID_PCM_F64LE}.get((bits, be))
    if signed:
        if bits == 8:
            return CODEC_ID_PCM_S8
        return {(16, True): CODEC_ID_PCM_S16BE, (24, True): CODEC_ID_PCM_S24BE,
                (32, True): CODEC_ID_PCM_S32BE, (16, False): CODEC_ID_PCM_S16LE,
                (24, False): CODEC_ID_PCM_S24LE,
                (32, False): CODEC_ID_PCM_S32LE}.get((bits, be))
    if bits == 8:
        return CODEC_ID_PCM_U8
    return {(16, True): CODEC_ID_PCM_U16BE, (24, True): CODEC_ID_PCM_U24BE,
            (32, True): CODEC_ID_PCM_U32BE, (16, False): CODEC_ID_PCM_U16LE,
            (24, False): CODEC_ID_PCM_U24LE,
            (32, False): CODEC_ID_PCM_U32LE}.get((bits, be))


class _RangeView:
    """Sparse read-through view of a seekable stream.

    Behaves like the whole-file ``bytes`` buffer (``len``, integer index,
    step-1 slices) but holds only prefetched metadata-atom ranges in
    memory; any uncovered access (sample data inside ``mdat``) seeks the
    MediaSourceStream window at access time. This is what makes the MP4
    reader O(window): the reference reads each sample from disk at its
    table offset (demuxer.rs:618-663) instead of buffering the file.

    Coordinates are stream offsets relative to the reader's start pos.
    """

    def __init__(self, mss, base: int, length: int):
        self._mss = mss
        self._base = base
        self._len = length
        self._los: List[int] = []           # sorted range starts
        self._ranges: List[Tuple[int, int, bytes]] = []  # (lo, hi, bytes)

    def add(self, lo: int, data: bytes) -> None:
        if not data:
            return
        i = bisect.bisect_left(self._los, lo)
        self._los.insert(i, lo)
        self._ranges.insert(i, (lo, lo + len(data), data))

    def stored_bytes(self) -> int:
        return sum(len(r[2]) for r in self._ranges)

    def covers(self, lo: int, hi: int) -> bool:
        """True when [lo, hi) lies fully inside one stored range."""
        i = bisect.bisect_right(self._los, lo) - 1
        return i >= 0 and hi <= self._ranges[i][1]

    def _read_file(self, lo: int, hi: int) -> bytes:
        if hi <= lo:
            return b""
        if self._mss is None:
            # Forward-only source: the parser must never need bytes it
            # did not keep (metadata atoms are stored as they arrive).
            raise DecodeError("isomp4: reference into unbuffered pipe region")
        self._mss.seek(self._base + lo)
        return self._mss.read_upto(hi - lo)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, key):
        if isinstance(key, slice):
            lo, hi, step = key.indices(self._len)
            if step != 1:
                raise ValueError("_RangeView supports step-1 slices only")
            if hi <= lo:
                return b""
            i = bisect.bisect_right(self._los, lo) - 1
            if i >= 0:
                rlo, rhi, data = self._ranges[i]
                if hi <= rhi:  # fast path: fully inside one stored range
                    return data[lo - rlo : hi - rlo]
            # Piecewise: stored spans fill what they cover, the stream
            # window fills the gaps.
            out = []
            pos = lo
            j = max(i, 0)
            while pos < hi and j < len(self._ranges):
                rlo, rhi, data = self._ranges[j]
                if rhi <= pos:
                    j += 1
                    continue
                if rlo >= hi:
                    break
                if rlo > pos:
                    out.append(self._read_file(pos, min(rlo, hi)))
                    pos = min(rlo, hi)
                    if pos >= hi:
                        break
                take_hi = min(hi, rhi)
                out.append(data[pos - rlo : take_hi - rlo])
                pos = take_hi
                j += 1
            if pos < hi:
                out.append(self._read_file(pos, hi))
            return b"".join(out)
        idx = int(key)
        if idx < 0:
            idx += self._len
        b = self[idx : idx + 1]
        if not b:
            raise IndexError("index out of range")
        return b[0]


def iter_atoms_h(buf: bytes, start: int, end: int):
    """Yield (type, header_start, body_start, body_end) for atoms in
    [start, end) — header_start differs from body_start by 8 or, for
    64-bit largesize atoms, 16 bytes."""
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(buf[pos : pos + 4], "big")
        atype = buf[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            size = int.from_bytes(buf[pos + 8 : pos + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            break
        yield atype, pos, pos + hdr, pos + size
        pos += size


def iter_atoms(buf: bytes, start: int, end: int):
    """Yield (type, body_start, body_end) for atoms in [start, end)."""
    for atype, _h, b, e in iter_atoms_h(buf, start, end):
        yield atype, b, e


def find_atom(buf, start, end, path: List[bytes]):
    for atype, b, e in iter_atoms(buf, start, end):
        if atype == path[0]:
            if len(path) == 1:
                return b, e
            return find_atom(buf, b, e, path[1:])
    return None


@dataclass
class Mp4Track:
    track_id: int
    timescale: int = 0
    codec: Optional[str] = None
    sample_rate: int = 0
    n_channels: int = 0
    bits_per_sample: Optional[int] = None
    extra_data: Optional[bytes] = None
    ch_layout: Optional[object] = None  # positioned Channels when known (ASC)
    # Expanded sample table.
    offsets: Optional[np.ndarray] = None
    sizes: Optional[np.ndarray] = None
    ts: Optional[np.ndarray] = None
    durs: Optional[np.ndarray] = None
    # Per-sample composition-time offsets (ctts / trun cts; pts = dts +
    # pts_off) and sync-sample flags (stss / trun sample flags). Always
    # allocated alongside the table so fragment appends stay aligned.
    pts_off: Optional[np.ndarray] = None
    key: Optional[np.ndarray] = None
    delay: int = 0  # edit-list media offset in timescale ticks
    duration: int = 0
    language: Optional[str] = None  # mdhd packed ISO-639-2/T code
    # Experimental video/subtitle description (stsd.rs visual/subtitle
    # sample entries); the trak is surfaced via other_tracks(), not demuxed.
    other_params: Optional[object] = None
    # v0/v1 PCM entries: bytes per PCM frame (all channels); packets
    # coalesce per chunk in _expand_sample_tables.
    pcm_frame_bytes: int = 0


def _parse_esds(body: bytes):
    """(objectTypeIndication, DecoderSpecificInfo) from an esds box
    (esds.rs). Either may be None; MP3-in-MP4 signals via OTI 0x69/0x6B
    with no DSI (the reference maps OTI to the codec id)."""
    pos = 4  # version/flags

    def read_desc(p):
        tag = body[p]
        p += 1
        size = 0
        for _ in range(4):
            b = body[p]
            p += 1
            size = (size << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return tag, size, p

    try:
        tag, size, pos = read_desc(pos)  # ES descriptor (0x03)
        if tag != 0x03:
            return None, None
        pos += 2  # ES id
        flags = body[pos]
        pos += 1
        if flags & 0x80:
            pos += 2
        if flags & 0x40:
            pos += 1 + body[pos]
        if flags & 0x20:
            pos += 2
        tag, size, pos = read_desc(pos)  # DecoderConfig (0x04)
        if tag != 0x04:
            return None, None
        dc_end = pos + size
        oti = body[pos]
        pos += 13  # objectType, streamType, bufferSize, bitrates
        if pos >= dc_end:
            return oti, None
        tag, size, pos = read_desc(pos)  # DecoderSpecificInfo (0x05)
        if tag != 0x05:
            return oti, None
        return oti, body[pos : pos + size]
    except IndexError:
        return None, None


# iTunes ilst key maps live in metadata/std_tag.py (ITUNES_MAP /
# ITUNES_FREEFORM_MAP — atoms/ilst.rs + utils/itunes.rs analogs).


class IsoMp4Reader(FormatReader):
    """ISO MP4 format reader (isomp4 demuxer.rs:137)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        start = mss.pos()
        total = mss.byte_len() if mss.is_seekable() else None
        if total is not None:
            # O(window) mode: prefetch metadata atoms only; sample bytes
            # are read through the stream window at packet time
            # (demuxer.rs:618-663 reads per packet from disk).
            buf = self._scan_seekable(mss, start, total - start)
        else:
            # Pipes: no random access to mdat, so buffer the stream.
            chunks = []
            while True:
                b = mss.read_upto(1 << 22)
                if not b:
                    break
                chunks.append(b)
            buf = b"".join(chunks)
        self._buf = buf
        self._start = start

        # Verify ftyp.
        atoms = list(iter_atoms(buf, 0, len(buf)))
        if not any(t == b"ftyp" for t, _, _ in atoms):
            if not any(t == b"moov" for t, _, _ in atoms):
                raise Unsupported("not an ISO media file")

        moov = find_atom(buf, 0, len(buf), [b"moov"])
        if moov is None:
            raise Unsupported("missing moov atom")

        self._tracks: List[Mp4Track] = []
        trak_err: Optional[DecodeError] = None
        for atype, b, e in iter_atoms(buf, *moov):
            if atype == b"trak":
                # One malformed trak must not kill its valid siblings;
                # a file with NO parsable track re-raises the first error
                # (so single-track malformed files fail as before).
                try:
                    t = self._parse_trak(buf, b, e)
                except DecodeError as exc:
                    trak_err = trak_err or exc
                    continue
                if t is not None and (t.codec is not None
                                      or t.other_params is not None):
                    self._tracks.append(t)
            elif atype == b"mvex":
                self._parse_mvex(buf, b, e)
            elif atype == b"udta":
                self._parse_udta(buf, b, e)
        if not self._tracks and trak_err is not None:
            raise trak_err

        # Fragmented movies: sidx-indexed lazy loading when the moov carries
        # no usable sample tables (demuxer.rs:500-584); otherwise an eager
        # moof scan appends samples to the tables.
        self._parse_sidx(buf)
        self._frag_loaded = 0
        tables_empty = all(len(t.offsets) == 0 for t in self._tracks)
        if self._sidx_segments and tables_empty:
            # Lazy: load the first segment so packet params/cursors work.
            self._ensure_fragments_loaded(0)
        else:
            self._sidx_segments = []
            self._parse_fragments(buf)

        self._finish_tracks()

    def _finish_tracks(self) -> None:
        """Validate tracks and build the public Track objects + cursors."""
        if not self._tracks:
            raise Unsupported("no supported tracks in MP4")

        self._cursor = {t.track_id: 0 for t in self._tracks}
        self._track_objs = []
        self._other_tracks: List[Track] = []
        for t in self._tracks:
            if t.other_params is not None:
                # Video/subtitle track: demuxed via next_packet /
                # packet_table like the reference, surfaced through
                # other_tracks() (no audio decoder applies).
                self._other_tracks.append(Track(
                    id=t.track_id, codec_params=t.other_params,
                    time_base=TimeBase(1, t.timescale or 1),
                    num_frames=(int(t.durs.sum()) if t.durs is not None
                                and len(t.durs) else None),
                    duration=t.duration or None,
                    language=t.language))
                continue
            params = AudioCodecParameters(
                codec=t.codec,
                sample_rate=t.sample_rate or t.timescale,
                channels=t.ch_layout
                or (Channels.from_count(t.n_channels) if t.n_channels else None),
                bits_per_sample=t.bits_per_sample,
                extra_data=t.extra_data,
            )
            num_frames = int(t.durs.sum()) if t.durs is not None else None
            if self._sidx_segments and self._sidx_timescale:
                # Lazy mode: the total comes from the segment index.
                num_frames = (self._sidx_total_dur * (t.timescale or 1)
                              // self._sidx_timescale)
            self._track_objs.append(
                Track(
                    id=t.track_id,
                    codec_params=params,
                    time_base=TimeBase(1, t.timescale or 1),
                    num_frames=num_frames,
                    duration=t.duration or None,
                    delay=t.delay,
                    language=t.language,
                )
            )

    # -- seekable atom prefetch --------------------------------------------

    # Kept-atom caps: a crafted moov/moof size must not force a giant
    # allocation. Oversized atoms keep header-only coverage; the view's
    # read-through fallback still makes any access correct, just unbuffered.
    _KEEP_CAP = 1 << 25          # 32 MiB for general metadata atoms
    _KEEP_CAP_MOOV = 1 << 28     # 256 MiB: huge-file sample tables are real

    @staticmethod
    def _scan_seekable(mss, base: int, length: int) -> "_RangeView":
        """Walk top-level atoms via seeks, prefetching everything except
        ``mdat`` (and over-cap atoms) into a sparse ``_RangeView``."""
        view = _RangeView(mss, base, length)
        pos = 0
        while pos + 8 <= length:
            mss.seek(base + pos)
            hdr = mss.read_upto(16)
            if len(hdr) < 8:
                break
            size = int.from_bytes(hdr[0:4], "big")
            atype = hdr[4:8]
            hlen = 8
            if size == 1:
                if len(hdr) < 16:
                    view.add(pos, hdr)
                    break
                size = int.from_bytes(hdr[8:16], "big")
                hlen = 16
            elif size == 0:
                size = length - pos
            if size < hlen or pos + size > length:
                # Malformed tail: keep the header so iter_atoms sees the
                # same bytes and stops at the same point a full buffer would.
                view.add(pos, hdr)
                break
            cap = (IsoMp4Reader._KEEP_CAP_MOOV if atype == b"moov"
                   else IsoMp4Reader._KEEP_CAP)
            if atype != b"mdat" and size <= cap:
                mss.seek(base + pos)
                view.add(pos, mss.read_upto(size))
            else:
                view.add(pos, hdr[:hlen])
            pos += size
        return view

    # -- moov parsing ------------------------------------------------------

    def _parse_trak(self, buf, b, e) -> Optional[Mp4Track]:
        t = Mp4Track(track_id=len(self._tracks))
        tkhd = find_atom(buf, b, e, [b"tkhd"])
        if tkhd and tkhd[1] - tkhd[0] >= 4:
            # Slices clamp at EOF but scalar byte reads raise: every
            # version read below needs the full-box header present.
            version = buf[tkhd[0]]
            off = tkhd[0] + 4 + (8 if version == 1 else 4) * 2
            t.track_id = int.from_bytes(buf[off : off + 4], "big")
        mdia = find_atom(buf, b, e, [b"mdia"])
        if mdia is None:
            return None
        mdhd = find_atom(buf, *mdia, [b"mdhd"])
        if mdhd and mdhd[1] - mdhd[0] >= 4:
            version = buf[mdhd[0]]
            if version == 1:
                t.timescale = int.from_bytes(buf[mdhd[0] + 20 : mdhd[0] + 24], "big")
                t.duration = int.from_bytes(buf[mdhd[0] + 24 : mdhd[0] + 32], "big")
                lang_off = mdhd[0] + 32
            else:
                t.timescale = int.from_bytes(buf[mdhd[0] + 12 : mdhd[0] + 16], "big")
                t.duration = int.from_bytes(buf[mdhd[0] + 16 : mdhd[0] + 20], "big")
                lang_off = mdhd[0] + 20
            if lang_off + 2 <= mdhd[1]:
                # Packed ISO-639-2/T: three 5-bit letters biased by 0x60.
                packed = int.from_bytes(buf[lang_off : lang_off + 2], "big")
                letters = [((packed >> s) & 0x1F) + 0x60 for s in (10, 5, 0)]
                if all(0x61 <= c <= 0x7A for c in letters) and packed != 0x7FFF:
                    t.language = bytes(letters).decode("ascii")
        stbl = find_atom(buf, *mdia, [b"minf", b"stbl"])
        if stbl is None:
            return None
        self._parse_stsd(buf, t, stbl)
        if t.other_params is not None:
            # Experimental video/subtitle track: demuxed like every other
            # track (demuxer.rs:618-663 has no track-type filter), with
            # composition offsets and sync flags from ctts/stss
            # (atoms/ctts.rs, atoms/stss.rs). A malformed stbl degrades to
            # a described-only (empty-table) track rather than failing the
            # whole container.
            try:
                self._expand_sample_tables(buf, t, stbl)
                self._parse_ctts_stss(buf, t, stbl)
            except DecodeError:
                t.offsets = np.zeros(0, np.int64)
                t.sizes = np.zeros(0, np.int64)
                t.ts = np.zeros(0, np.int64)
                t.durs = np.zeros(0, np.int64)
                t.pts_off = np.zeros(0, np.int64)
                t.key = np.ones(0, bool)
            return t
        self._expand_sample_tables(buf, t, stbl)
        # ctts/stss apply to every track (the fragment path already applies
        # trun cts offsets and sample flags uniformly); audio tracks almost
        # never carry them, and a malformed table on an otherwise-good
        # audio track degrades to dts/all-sync rather than failing it.
        try:
            self._parse_ctts_stss(buf, t, stbl)
        except DecodeError:
            t.pts_off = np.zeros(len(t.offsets), np.int64)
            t.key = np.ones(len(t.offsets), bool)
        # Edit list -> delay (elst.rs).
        elst = find_atom(buf, b, e, [b"edts", b"elst"])
        if elst and elst[1] - elst[0] >= 8:
            version = buf[elst[0]]
            count = int.from_bytes(buf[elst[0] + 4 : elst[0] + 8], "big")
            pos = elst[0] + 8
            # Byte anchor: a crafted count must not spin billions of
            # clamped-slice iterations.
            count = min(count, (elst[1] - pos) // (20 if version == 1 else 12))
            for _ in range(count):
                if version == 1:
                    seg_dur = int.from_bytes(buf[pos : pos + 8], "big")
                    media_time = int.from_bytes(buf[pos + 8 : pos + 16], "big", signed=True)
                    pos += 20
                else:
                    seg_dur = int.from_bytes(buf[pos : pos + 4], "big")
                    media_time = int.from_bytes(buf[pos + 4 : pos + 8], "big", signed=True)
                    pos += 12
                if media_time > 0:
                    t.delay = media_time
        return t

    def _parse_stsd(self, buf, t: Mp4Track, stbl) -> None:
        stsd = find_atom(buf, *stbl, [b"stsd"])
        if stsd is None:
            return
        pos = stsd[0] + 8  # entry count precedes; iter_atoms bounds the walk
        for atype, b, e in iter_atoms(buf, pos, stsd[1]):
            entry = buf[b : e]
            # SampleEntry: 6 reserved + 2 data_ref_index, audio: 8 more
            # reserved, channels(2), samplesize(2), 4 reserved, rate(4, 16.16)
            version = int.from_bytes(entry[8:10], "big") if len(entry) >= 10 else 0
            if len(entry) >= 28:
                t.n_channels = int.from_bytes(entry[16:18], "big")
                t.bits_per_sample = int.from_bytes(entry[18:20], "big") or None
                t.sample_rate = int.from_bytes(entry[24:26], "big")
            # Child config atoms follow the v0 fields; a v1 (QuickTime)
            # entry inserts 16 bytes of packet-layout fields first
            # (stsd.rs:229-246).
            sub_start = b + 28 + (16 if version == 1 else 0)
            if atype == b"mp4a":
                t.codec = CODEC_ID_AAC
                esds = find_atom(buf, sub_start, e, [b"esds"])
                if esds is None:
                    # QuickTime wraps decoder params in a 'wave'
                    # (siDecompressionParam) atom (atoms/wave.rs).
                    wave = find_atom(buf, sub_start, e, [b"wave"])
                    if wave:
                        esds = find_atom(buf, wave[0], wave[1], [b"esds"])
                if esds:
                    oti, asc = _parse_esds(buf[esds[0] : esds[1]])
                    if oti in (0x69, 0x6B):
                        # MPEG-2 BC / MPEG-1 audio in mp4a (the common
                        # "ffmpeg -c copy mp3 -> m4a" layout): the codec
                        # comes from the OTI, no DSI (esds.rs OTI map).
                        t.codec = CODEC_ID_MP3
                    elif asc:
                        t.extra_data = asc
                        from ..common.mpeg import AudioSpecificConfig

                        try:
                            parsed = AudioSpecificConfig.read(asc)
                            t.sample_rate = parsed.sample_rate
                            t.n_channels = parsed.n_channels
                            t.ch_layout = parsed.channels
                        except Exception:
                            pass
            elif atype == b"alac":
                t.codec = CODEC_ID_ALAC
                sub = find_atom(buf, sub_start, e, [b"alac"])
                if sub:
                    t.extra_data = buf[sub[0] + 4 : sub[1]]
            elif atype == b"fLaC":
                t.codec = CODEC_ID_FLAC
                sub = find_atom(buf, sub_start, e, [b"dfLa"])
                if sub:
                    # dfLa: version/flags + metadata blocks; STREAMINFO first.
                    t.extra_data = buf[sub[0] + 8 : sub[0] + 8 + 34]
            elif atype == b"Opus":
                t.codec = CODEC_ID_OPUS
                sub = find_atom(buf, sub_start, e, [b"dOps"])
                if sub:
                    # dOps stores the id-header fields BIG-endian with
                    # Version 0; an RFC 7845 OpusHead is little-endian
                    # with version 1, so rebuild it field by field
                    # (atoms/opus.rs:37-59), mapping table verbatim.
                    d = bytes(buf[sub[0] : sub[1]])
                    if 11 <= len(d) <= 268:
                        t.extra_data = (
                            b"OpusHead" + bytes([1, d[1]])
                            + int.from_bytes(d[2:4], "big").to_bytes(2, "little")
                            + int.from_bytes(d[4:8], "big").to_bytes(4, "little")
                            + int.from_bytes(d[8:10], "big").to_bytes(2, "little")
                            + d[10:])
            elif atype in (b"ac-3", b"ec-3"):
                # Described-only: the reference surfaces AC-3/E-AC-3 params
                # via dac3/dec3 (atoms/{dac3,dec3}.rs) but ships no decoder.
                t.codec = CODEC_ID_AC3 if atype == b"ac-3" else CODEC_ID_EAC3
                sub = find_atom(buf, sub_start, e,
                                [b"dac3" if atype == b"ac-3" else b"dec3"])
                if sub:
                    t.extra_data = bytes(buf[sub[0]:sub[1]])
            elif atype == b".mp3":
                t.codec = CODEC_ID_MP3
            elif atype in _MP4_PCM:
                # Uncompressed QuickTime audio, v0/v1 sample entries
                # (stsd.rs:212-265). Every MP4 sample is one PCM frame;
                # packets coalesce per chunk.
                codec, nbytes = _MP4_PCM[atype]
                if version == 0 and t.bits_per_sample not in (None,
                                                              8 * nbytes):
                    raise DecodeError("isomp4: invalid pcm sample size")
                if version == 1:
                    # v1 bytes-per-audio-sample supersedes sample_size
                    # (stsd.rs:246-257).
                    bpas = int.from_bytes(entry[32:36], "big")
                    if bpas != nbytes:
                        raise DecodeError(
                            "isomp4: invalid pcm bytes per sample")
                if t.n_channels < 1:
                    # 0 channels breaks the PCM frame math; >2 is legal
                    # QuickTime multichannel (frame size scales fine).
                    raise DecodeError("isomp4: invalid number of channels")
                t.codec = codec
                t.bits_per_sample = 8 * nbytes
                t.pcm_frame_bytes = nbytes * t.n_channels
            elif atype == b"lpcm":
                # Version-2 sample entry (stsd.rs:266-298): f64 rate,
                # u32 channels, explicit sample format flags; every MP4
                # sample is already a multi-frame packet.
                if len(entry) < 64 or int.from_bytes(entry[8:10], "big") != 2:
                    raise DecodeError("isomp4: malformed lpcm entry")
                if int.from_bytes(entry[44:48], "big") != 0x7F000000:
                    raise DecodeError("isomp4: lpcm reserved mismatch")
                t.sample_rate = int(struct.unpack(">d", entry[32:40])[0])
                t.n_channels = int.from_bytes(entry[40:44], "big")
                bits = int.from_bytes(entry[48:52], "big")
                flags = int.from_bytes(entry[52:56], "big")
                codec = _lpcm_codec_id(bits, flags)
                if codec is None:
                    raise DecodeError("isomp4: unsupported lpcm format")
                t.codec = codec
                t.bits_per_sample = bits
            elif atype in _MP4_VIDEO:
                from ..core.video import VideoCodecParameters, VideoExtraData

                p = VideoCodecParameters(codec=_MP4_VIDEO[atype])
                if len(entry) >= 28:
                    p.width = int.from_bytes(entry[24:26], "big")
                    p.height = int.from_bytes(entry[26:28], "big")
                # Codec configuration boxes follow the 70-byte
                # VisualSampleEntry body (avcC/hvcC/esds/av1C/vpcC...).
                if e - b > 78:
                    for ctype, cb, ce in iter_atoms(buf, b + 78, e):
                        p.extra_data.append(VideoExtraData(
                            id=ctype.decode("latin1").strip(),
                            data=bytes(buf[cb:ce])))
                t.other_params = p
            elif atype in _MP4_SUBTITLE:
                from ..core.subtitle import SubtitleCodecParameters

                t.other_params = SubtitleCodecParameters(
                    codec=_MP4_SUBTITLE[atype] or "null_subtitle")
            break  # only first entry

    @staticmethod
    def _table_array(buf, start, width, count, dtype, what, bound=None):
        """Checked big-endian table read: a declared entry count that
        exceeds the atom's own bytes (``bound`` = atom body end) is a
        DecodeError (the reference errors on short atom reads), not a raw
        numpy ValueError — and never silently reads past the atom into
        its neighbors' bytes."""
        end = start + width * count
        if count < 0 or end > (len(buf) if bound is None else bound):
            raise DecodeError(f"isomp4: truncated {what} table")
        return np.frombuffer(buf[start:end], dtype=dtype).astype(np.int64)

    def _expand_sample_tables(self, buf, t: Mp4Track, stbl) -> None:
        def table(name):
            a = find_atom(buf, *stbl, [name])
            return a

        stsz = table(b"stsz")
        sizes = None
        if stsz:
            uniform = int.from_bytes(buf[stsz[0] + 4 : stsz[0] + 8], "big")
            count = int.from_bytes(buf[stsz[0] + 8 : stsz[0] + 12], "big")
            if uniform:
                # DoS bound: count samples of `uniform` bytes each must fit
                # the file, so the file size caps the count a crafted
                # uniform-size stsz can claim (a mutated count drove a
                # 117 s np.full in the soak). Pipe readers set
                # _stsz_byte_bound (file size unknown) and additionally cap
                # the row count — their per-sample scheduling loop is what
                # a crafted count would actually drive.
                pipe_bound = getattr(self, "_stsz_byte_bound", None)
                bound = (pipe_bound if pipe_bound is not None
                         else len(buf)) // uniform
                if pipe_bound is not None:
                    bound = min(bound, _PIPE_SAMPLE_CAP)
                if count > bound:
                    raise DecodeError("isomp4: stsz count exceeds stream")
                sizes = np.full(count, uniform, dtype=np.int64)
            else:
                sizes = self._table_array(buf, stsz[0] + 12, 4, count,
                                          ">u4", "stsz", bound=stsz[1])
        if sizes is None or len(sizes) == 0:
            t.offsets = np.zeros(0, np.int64)
            t.sizes = np.zeros(0, np.int64)
            t.ts = np.zeros(0, np.int64)
            t.durs = np.zeros(0, np.int64)
            t.pts_off = np.zeros(0, np.int64)
            t.key = np.ones(0, bool)
            return
        n = len(sizes)

        # stco/co64: chunk offsets.
        stco = table(b"stco")
        if stco:
            cc = int.from_bytes(buf[stco[0] + 4 : stco[0] + 8], "big")
            chunk_offsets = self._table_array(buf, stco[0] + 8, 4, cc,
                                              ">u4", "stco", bound=stco[1])
        else:
            co64 = table(b"co64")
            if co64 is None:
                raise DecodeError("isomp4: missing stco/co64 sample table")
            cc = int.from_bytes(buf[co64[0] + 4 : co64[0] + 8], "big")
            chunk_offsets = self._table_array(buf, co64[0] + 8, 8, cc,
                                              ">u8", "co64", bound=co64[1])

        # stsc: samples per chunk runs.
        stsc = table(b"stsc")
        if stsc is None:
            raise DecodeError("isomp4: missing stsc sample table")
        sc = int.from_bytes(buf[stsc[0] + 4 : stsc[0] + 8], "big")
        runs = self._table_array(buf, stsc[0] + 8, 12, sc, ">u4",
                                 "stsc", bound=stsc[1]).reshape(-1, 3)
        # (first_chunk, samples, desc_idx)

        if t.pcm_frame_bytes:
            # v0/v1 PCM: every MP4 sample is one PCM frame; emitting
            # per-frame packets would mean millions of 2-8 byte reads.
            # Coalesce each chunk into one packet of samples-per-chunk
            # frames (stsz granularity for QuickTime uncompressed audio
            # is muxer-dependent, so the chunk byte count derives from
            # the frame size like ffmpeg's mov demuxer does). The PCM
            # decoder takes whole frames of any count; a final short
            # chunk clips at the stream end.
            fb = t.pcm_frame_bytes
            offs, durs = [], []
            si = 0
            for ri in range(len(runs)):
                first = int(runs[ri, 0]) - 1
                spc = max(0, int(runs[ri, 1]))
                last = (int(runs[ri + 1, 0]) - 1 if ri + 1 < len(runs)
                        else len(chunk_offsets))
                for ci in range(max(0, first), min(last, len(chunk_offsets))):
                    if si >= n:
                        break
                    take = min(spc, n - si)
                    offs.append(int(chunk_offsets[ci]))
                    durs.append(take)
                    si += take
            t.offsets = np.asarray(offs, np.int64)
            t.durs = np.asarray(durs, np.int64)
            t.sizes = t.durs * fb
            t.ts = np.concatenate([[0], np.cumsum(t.durs[:-1])]) \
                if len(t.durs) else np.zeros(0, np.int64)
            t.pts_off = np.zeros(len(t.durs), np.int64)
            t.key = np.ones(len(t.durs), bool)
            return

        # Expand to per-sample offsets.
        offsets = np.empty(n, dtype=np.int64)
        si = 0
        for ri in range(len(runs)):
            first = int(runs[ri, 0]) - 1
            spc = int(runs[ri, 1])
            last = int(runs[ri + 1, 0]) - 1 if ri + 1 < len(runs) else len(chunk_offsets)
            # Clamp malformed first_chunk values into the stco range (the
            # PCM branch above does the same): out-of-range indexes must
            # not raise raw IndexError or wrap negatively.
            for ci in range(max(0, first), min(last, len(chunk_offsets))):
                if si >= n:
                    break
                take = min(spc, n - si)
                base = int(chunk_offsets[ci])
                cs = np.concatenate([[0], np.cumsum(sizes[si : si + take - 1])]) if take > 1 else np.zeros(1, np.int64)
                offsets[si : si + take] = base + cs
                si += take
        if si < n:
            offsets[si:] = 0
            sizes = sizes.copy()
            sizes[si:] = 0

        # stts: durations.
        stts = table(b"stts")
        if stts is None:
            raise DecodeError("isomp4: missing stts sample table")
        tc = int.from_bytes(buf[stts[0] + 4 : stts[0] + 8], "big")
        truns = self._table_array(buf, stts[0] + 8, 8, tc, ">u4",
                                  "stts", bound=stts[1]).reshape(-1, 2)
        # Clip run counts before materializing: only n durations are
        # needed, and crafted counts must not drive a giant np.repeat.
        # The cumulative cut bounds the expansion at < 2n even when MANY
        # rows each claim up to n samples (per-row clipping alone still
        # allowed rows x n).
        counts = np.minimum(truns[:, 0], n)
        k = int(np.searchsorted(np.cumsum(counts), n)) + 1
        durs = np.repeat(truns[:k, 1], counts[:k])[:n]
        if len(durs) < n:
            pad = durs[-1] if len(durs) else 0
            durs = np.concatenate([durs, np.full(n - len(durs), pad, np.int64)])
        ts = np.concatenate([[0], np.cumsum(durs[:-1])])

        t.offsets = offsets
        t.sizes = sizes
        t.ts = ts
        t.durs = durs
        t.pts_off = np.zeros(n, np.int64)
        t.key = np.ones(n, bool)

    def _parse_ctts_stss(self, buf, t: Mp4Track, stbl) -> None:
        """Composition-time offsets and sync-sample flags (atoms/ctts.rs,
        atoms/stss.rs). pts = dts + ctts offset; a missing stss means
        every sample is a sync sample (ISO 14496-12 8.6.2)."""
        n = len(t.offsets)
        ctts = find_atom(buf, *stbl, [b"ctts"])
        if ctts is not None and n and ctts[1] - ctts[0] >= 8:
            version = buf[ctts[0]]
            cc = int.from_bytes(buf[ctts[0] + 4 : ctts[0] + 8], "big")
            rows = self._table_array(buf, ctts[0] + 8, 8, cc, ">u4",
                                     "ctts", bound=ctts[1]).reshape(-1, 2)
            counts = np.minimum(rows[:, 0], n)
            # Cumulative cut: bound the materialized expansion at < 2n
            # (many rows each claiming up to n would otherwise allocate
            # rows x n elements before the [:n] slice).
            k = int(np.searchsorted(np.cumsum(counts), n)) + 1
            offs = rows[:k, 1]
            if version == 1:
                # v1 offsets are signed 32-bit (v0 unsigned).
                offs = (offs.astype(np.uint32)).astype(np.int32).astype(np.int64)
            expanded = np.repeat(offs, counts[:k])[:n]
            t.pts_off[: len(expanded)] = expanded
        stss = find_atom(buf, *stbl, [b"stss"])
        if stss is not None and n and stss[1] - stss[0] >= 8:
            cc = int.from_bytes(buf[stss[0] + 4 : stss[0] + 8], "big")
            nums = self._table_array(buf, stss[0] + 8, 4, cc, ">u4", "stss",
                                      bound=stss[1])
            t.key = np.zeros(n, bool)
            nums = nums[(nums >= 1) & (nums <= n)] - 1  # 1-based sample ids
            t.key[nums] = True

    def _parse_sidx(self, buf) -> None:
        """Segment index atoms -> [(start_ts, byte_lo, byte_hi)] per
        referenced subsegment (demuxer.rs:500-584 seek path). Offsets are
        relative to the first byte after the sidx atom."""
        self._sidx_segments: List[Tuple[int, int, int]] = []
        self._sidx_timescale = 0
        self._sidx_track_id: Optional[int] = None
        for atype, b, e in iter_atoms(buf, 0, len(buf)):
            if atype != b"sidx" or e - b < 12:
                continue
            version = buf[b]
            ref_id = int.from_bytes(buf[b + 4 : b + 8], "big")
            timescale = int.from_bytes(buf[b + 8 : b + 12], "big")
            pos = b + 12
            if version == 0:
                earliest = int.from_bytes(buf[pos : pos + 4], "big")
                first_off = int.from_bytes(buf[pos + 4 : pos + 8], "big")
                pos += 8
            else:
                earliest = int.from_bytes(buf[pos : pos + 8], "big")
                first_off = int.from_bytes(buf[pos + 8 : pos + 16], "big")
                pos += 16
            count = int.from_bytes(buf[pos + 2 : pos + 4], "big")
            pos += 4
            anchor = e + first_off
            ts = earliest
            for _ in range(count):
                word = int.from_bytes(buf[pos : pos + 4], "big")
                ref_type = word >> 31
                size = word & 0x7FFFFFFF
                dur = int.from_bytes(buf[pos + 4 : pos + 8], "big")
                pos += 12
                if ref_type == 0:  # media reference
                    self._sidx_segments.append((ts, anchor, anchor + size))
                ts += dur
                anchor += size
            self._sidx_timescale = timescale
            self._sidx_track_id = ref_id
            self._sidx_total_dur = ts - earliest
            break  # one index per presentation is the common layout

    def _ensure_fragments_loaded(self, upto_segment: int) -> None:
        """Lazily parse moof/trun tables for sidx segments [loaded..upto]."""
        while self._frag_loaded <= upto_segment and \
                self._frag_loaded < len(self._sidx_segments):
            _ts, lo, hi = self._sidx_segments[self._frag_loaded]
            self._parse_fragments(self._buf, lo, min(hi, len(self._buf)))
            self._frag_loaded += 1

    def _parse_mvex(self, buf, lo: int, hi: int) -> None:
        """Record per-track trex defaults (trex.rs): fragments whose tfhd
        omits default duration/size inherit them from here (resolution
        order is trun > tfhd > trex)."""
        defaults = getattr(self, "_trex_defaults", None)
        if defaults is None:
            defaults = self._trex_defaults = {}
        for atype, b, e in iter_atoms(buf, lo, hi):
            if atype != b"trex" or e - b < 24:
                continue
            track_id = int.from_bytes(buf[b + 4 : b + 8], "big")
            dur = int.from_bytes(buf[b + 12 : b + 16], "big")
            size = int.from_bytes(buf[b + 16 : b + 20], "big")
            flags = int.from_bytes(buf[b + 20 : b + 24], "big")
            defaults[track_id] = (dur, size, flags)

    def _parse_fragments(self, buf, lo: int = 0, hi: Optional[int] = None) -> None:
        """Minimal moof/traf/trun support (fragmented MP4, stream.rs:83).

        Per-trun rows accumulate in per-track column lists and flush to
        the track arrays ONCE per call: appending via np.concatenate per
        trun is quadratic over many tiny truns (a crafted-fragment DoS).
        """
        if hi is None:
            hi = len(buf)
        # track_id -> [off_chunks, sz_chunks, dr_chunks, pto_chunks,
        #              kf_chunks, ts_chunks, next_ts, track]
        acc: dict = {}

        def _acc(track):
            a = acc.get(track.track_id)
            if a is None:
                nt = (int(track.ts[-1] + track.durs[-1])
                      if len(track.ts) else 0)
                a = acc[track.track_id] = [[], [], [], [], [], [], nt, track]
            return a

        for atype, moof_start, b, e in iter_atoms_h(buf, lo, hi):
            if atype != b"moof":
                continue
            # default-base-is-moof offsets anchor at the atom HEADER
            # (which is 16 bytes for a 64-bit largesize moof, not 8).
            for t2, tb, te in iter_atoms(buf, b, e):
                if t2 != b"traf":
                    continue
                tfhd = find_atom(buf, tb, te, [b"tfhd"])
                if tfhd is None:
                    continue
                flags = int.from_bytes(buf[tfhd[0] + 1 : tfhd[0] + 4], "big")
                pos = tfhd[0] + 4
                track_id = int.from_bytes(buf[pos : pos + 4], "big")
                pos += 4
                base_offset = moof_start
                if flags & 0x1:
                    base_offset = int.from_bytes(buf[pos : pos + 8], "big")
                    pos += 8
                if flags & 0x2:
                    pos += 4
                default_dur, default_size, default_flags = getattr(
                    self, "_trex_defaults", {}).get(track_id, (0, 0, 0))
                if flags & 0x8:
                    default_dur = int.from_bytes(buf[pos : pos + 4], "big")
                    pos += 4
                if flags & 0x10:
                    default_size = int.from_bytes(buf[pos : pos + 4], "big")
                    pos += 4
                if flags & 0x20:
                    default_flags = int.from_bytes(buf[pos : pos + 4], "big")
                    pos += 4
                track = next((t for t in self._tracks if t.track_id == track_id), None)
                if track is None:
                    continue
                for t3, rb, re_ in iter_atoms(buf, tb, te):
                    if t3 != b"trun" or re_ - rb < 8:
                        continue
                    trun_version = buf[rb]
                    tflags = int.from_bytes(buf[rb + 1 : rb + 4], "big")
                    cnt = int.from_bytes(buf[rb + 4 : rb + 8], "big")
                    pos2 = rb + 8
                    data_off = 0
                    first_flags = None
                    if tflags & 0x1:
                        data_off = int.from_bytes(buf[pos2 : pos2 + 4], "big", signed=True)
                        pos2 += 4
                    if tflags & 0x4:
                        first_flags = int.from_bytes(buf[pos2 : pos2 + 4],
                                                     "big")
                        pos2 += 4
                    # DoS bound: a crafted count must not drive a giant
                    # walk (mirrors the stsz cap). With per-sample fields
                    # the trun's own bytes cap the count; without them a
                    # sample still needs >= 1 byte of stream.
                    entry_sz = 4 * (bool(tflags & 0x100) + bool(tflags & 0x200)
                                    + bool(tflags & 0x400) + bool(tflags & 0x800))
                    if entry_sz:
                        if cnt > (re_ - pos2) // entry_sz:
                            raise DecodeError("isomp4: truncated trun table")
                    else:
                        # No per-sample fields: the trun's own bytes can't
                        # bound the count. Each sample claims default_size
                        # stream bytes, so a CUMULATIVE byte ledger caps
                        # the total across all truns (per-trun bounds
                        # alone let thousands of truns each claim the
                        # whole file). Pipe views report a sentinel
                        # length; use the explicit bound there (see
                        # _stsz_byte_bound) plus a row cap. default_size
                        # 0 claims no bytes, so empty samples get a small
                        # cumulative row cap of their own.
                        cap = getattr(self, "_stsz_byte_bound", None)
                        if default_size:
                            budget = cap if cap is not None else len(buf)
                            used_b = getattr(self, "_trun_bytes", 0)
                            bound = max(0, budget - used_b) // default_size
                            if cap is not None:  # pipe: length is assumed
                                used = getattr(self, "_trun_samples", 0)
                                bound = min(bound, _PIPE_SAMPLE_CAP - used)
                        else:
                            used = getattr(self, "_empty_trun_samples", 0)
                            bound = _TRUN_EMPTY_SAMPLE_CAP - used
                        if cnt > max(0, bound):
                            raise DecodeError(
                                "isomp4: trun count exceeds stream")
                        if default_size:
                            self._trun_bytes = getattr(
                                self, "_trun_bytes", 0) + cnt * default_size
                            if cap is not None:
                                self._trun_samples = getattr(
                                    self, "_trun_samples", 0) + cnt
                        else:
                            self._empty_trun_samples = getattr(
                                self, "_empty_trun_samples", 0) + cnt
                    offs, szs, drs, ptos, kfs = [], [], [], [], []
                    cur = base_offset + data_off
                    for k in range(cnt):
                        d = default_dur
                        s = default_size
                        f = default_flags
                        if k == 0 and first_flags is not None:
                            f = first_flags
                        if tflags & 0x100:
                            d = int.from_bytes(buf[pos2 : pos2 + 4], "big")
                            pos2 += 4
                        if tflags & 0x200:
                            s = int.from_bytes(buf[pos2 : pos2 + 4], "big")
                            pos2 += 4
                        if tflags & 0x400:
                            f = int.from_bytes(buf[pos2 : pos2 + 4], "big")
                            pos2 += 4
                        cts = 0
                        if tflags & 0x800:
                            # v1 composition offsets are signed (trun.rs).
                            cts = int.from_bytes(
                                buf[pos2 : pos2 + 4], "big",
                                signed=trun_version >= 1)
                            pos2 += 4
                        offs.append(cur)
                        szs.append(s)
                        drs.append(d)
                        ptos.append(cts)
                        # ISO 14496-12 sample flags bit 16:
                        # sample_is_non_sync_sample.
                        kfs.append(not ((f >> 16) & 1))
                        cur += s
                    if not offs:
                        # A zero-sample trun must append NOTHING: the
                        # [[0]] + cumsum idiom below would append one ts
                        # with no matching offset/size/dur row (soak-found
                        # length desync -> IndexError on the next trun).
                        continue
                    a = _acc(track)
                    drs_a = np.asarray(drs, np.int64)
                    new_ts = a[6] + np.concatenate(
                        [[0], np.cumsum(drs_a[:-1])])
                    a[6] += int(drs_a.sum())
                    a[0].append(np.asarray(offs, np.int64))
                    a[1].append(np.asarray(szs, np.int64))
                    a[2].append(drs_a)
                    a[3].append(np.asarray(ptos, np.int64))
                    a[4].append(np.asarray(kfs, bool))
                    a[5].append(new_ts)
        for offc, szc, drc, ptoc, kfc, tsc, _nt, track in acc.values():
            track.offsets = np.concatenate([track.offsets] + offc)
            track.sizes = np.concatenate([track.sizes] + szc)
            track.durs = np.concatenate([track.durs] + drc)
            track.ts = np.concatenate([track.ts] + tsc)
            track.pts_off = np.concatenate([track.pts_off] + ptoc)
            track.key = np.concatenate(
                [track.key.astype(bool)] + kfc)

    def _parse_udta(self, buf, b, e) -> None:
        meta = find_atom(buf, b, e, [b"meta"])
        if meta is None:
            return
        ilst = find_atom(buf, meta[0] + 4, meta[1], [b"ilst"])
        if ilst is None:
            return
        rev = MetadataRevision()
        for atype, ib, ie in iter_atoms(buf, *ilst):
            self._parse_ilst_item(buf, atype, ib, ie, rev)
        if rev.tags or rev.visuals:
            self._metadata.push(rev)

    @staticmethod
    def _decode_ilst_value(dtype: int, payload: bytes):
        """Typed `data` atom payload -> Python value (atoms/ilst.rs typed
        readers; itunes well-known data types). Returns None when the type
        is unrecognized (caller keeps the raw bytes)."""

        if dtype in (1, 4):  # UTF-8 (+ sort variant)
            return payload.decode("utf-8", "replace")
        if dtype in (2, 5):  # UTF-16 BE
            return payload.decode("utf-16-be", "replace")
        if dtype == 21:  # signed big-endian int (1/2/3/4/8 bytes)
            return int.from_bytes(payload, "big", signed=True)
        if dtype in (22, 0):  # unsigned big-endian int / implicit numeric
            return int.from_bytes(payload, "big")
        if dtype == 23 and len(payload) == 4:
            return struct.unpack(">f", payload)[0]
        if dtype == 24 and len(payload) == 8:
            return struct.unpack(">d", payload)[0]
        return None

    def _parse_ilst_item(self, buf, atype, ib, ie, rev) -> None:
        from ..metadata.std_tag import (
            ITUNES_FREEFORM_MAP, ITUNES_MAP, map_raw)

        data = find_atom(buf, ib, ie, [b"data"])
        if data is None:
            return
        dtype = int.from_bytes(buf[data[0] : data[0] + 4], "big") & 0xFFFFFF
        payload = buf[data[0] + 8 : data[1]]
        key = atype.decode("latin-1", "replace")

        if atype == b"covr":
            from ..core.meta import sniff_image

            mime = {13: "image/jpeg", 14: "image/png"}.get(dtype) \
                or sniff_image(payload)
            rev.visuals.append(Visual(media_type=mime, data=payload,
                                      usage="front_cover"))
            return
        if atype == b"----":
            # Freeform atom: mean (reverse-DNS namespace) + name + data
            # (ilst.rs FreeFormTag; utils/itunes.rs name map).
            mean = find_atom(buf, ib, ie, [b"mean"])
            name = find_atom(buf, ib, ie, [b"name"])
            mtxt = (buf[mean[0] + 4 : mean[1]].decode("utf-8", "replace")
                    if mean else "")
            ntxt = (buf[name[0] + 4 : name[1]].decode("utf-8", "replace")
                    if name else "")
            ffkey = f"{mtxt}:{ntxt}"
            val = self._decode_ilst_value(dtype, payload)
            rev.tags.extend(map_raw(
                ffkey, val if val is not None else payload,
                ITUNES_FREEFORM_MAP))
            return
        if atype in (b"trkn", b"disk") and len(payload) >= 6:
            # Implicit layout: pad16 + number u16 + total u16 (+ pad).
            num = int.from_bytes(payload[2:4], "big")
            total = int.from_bytes(payload[4:6], "big")
            nk, tk = ((K.TRACK_NUMBER, K.TRACK_TOTAL) if atype == b"trkn"
                      else (K.DISC_NUMBER, K.DISC_TOTAL))
            rev.tags.append(RawTag(key, num, nk))
            if total:
                rev.tags.append(RawTag(key, total, tk))
            return
        if atype == b"gnre" and len(payload) >= 2:
            # ID3v1 genre index + 1 (ilst.rs GenreTag).
            from ..metadata.id3v1 import GENRES

            idx = int.from_bytes(payload[:2], "big") - 1
            if 0 <= idx < len(GENRES):
                rev.tags.append(RawTag(key, GENRES[idx], K.GENRE))
            return
        if atype == b"rtng" and payload:
            advisory = {0: "None", 2: "Clean", 4: "Explicit"}.get(
                payload[0], str(payload[0]))
            rev.tags.append(RawTag(key, advisory, K.CONTENT_ADVISORY))
            return
        if atype == b"stik" and payload:
            media = {0: "Movie", 1: "Normal", 2: "Audio Book",
                     5: "Whacked Bookmark", 6: "Music Video", 9: "Short Film",
                     10: "TV Show", 11: "Booklet"}.get(payload[0], "Unknown")
            rev.tags.append(RawTag(key, media, K.MEDIA_FORMAT))
            return

        val = self._decode_ilst_value(dtype, payload)
        if val is None:
            # Unknown typed payload: preserve the raw bytes (no hex dumps).
            rev.tags.append(RawTag(key, payload))
            return
        rev.tags.extend(map_raw(key, val, ITUNES_MAP))

    # -- FormatReader ------------------------------------------------------

    def tracks(self) -> List[Track]:
        return self._track_objs

    def other_tracks(self) -> List[Track]:
        return getattr(self, "_other_tracks", [])

    def default_track(self) -> Optional[Track]:
        return self._track_objs[0] if self._track_objs else None

    def next_packet(self) -> Optional[Packet]:
        # Pick the track with the lowest next dts (demuxer.rs:618-663).
        # Loop rather than recurse: a crafted sidx can declare thousands
        # of segments that each contribute no packets.
        best = None
        while best is None:
            for t in self._tracks:
                i = self._cursor[t.track_id]
                if t.offsets is None or i >= len(t.offsets):
                    continue
                key = t.ts[i] / (t.timescale or 1)
                if best is None or key < best[0]:
                    best = (key, t, i)
            if best is None:
                if self._sidx_segments and \
                        self._frag_loaded < len(self._sidx_segments):
                    self._ensure_fragments_loaded(self._frag_loaded)
                    continue
                return None
        _, t, i = best
        self._cursor[t.track_id] = i + 1
        off, size = int(t.offsets[i]), int(t.sizes[i])
        ts = int(t.ts[i])
        if t.pts_off is not None and i < len(t.pts_off):
            ts += int(t.pts_off[i])  # pts = dts + ctts offset
        kf = (bool(t.key[i]) if t.key is not None and i < len(t.key)
              else True)
        return Packet(
            track_id=t.track_id,
            ts=ts,
            dur=int(t.durs[i]),
            data=self._buf[off : off + size],
            keyframe=kf,
        )

    def _default_mp4_track(self) -> Mp4Track:
        """First audio Mp4Track, else the first track of any kind."""
        return next((t for t in self._tracks if t.other_params is None),
                    self._tracks[0])

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        track = self._default_mp4_track()
        if to.track_id is not None:
            track = next((t for t in self._tracks if t.track_id == to.track_id), track)
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = int(to.time.to_seconds() * track.timescale)
        else:
            raise SeekError("no seek target")
        if self._sidx_segments:
            # sidx-directed: load fragments only up to the target's
            # subsegment (demuxer.rs:500-584); the byte range comes from
            # the segment index, not a full moof scan.
            ts_sidx = ts
            if self._sidx_timescale and track.timescale and \
                    self._sidx_timescale != track.timescale:
                ts_sidx = ts * self._sidx_timescale // track.timescale
            starts = [s[0] for s in self._sidx_segments]
            seg = max(0, int(np.searchsorted(starts, ts_sidx, side="right")) - 1)
            self._ensure_fragments_loaded(seg)
        if len(track.ts) == 0:
            # A track with no samples (fragmented file whose moofs were
            # all malformed, or an empty stbl) has nothing to seek to.
            raise SeekError("track has no samples")
        i = int(np.searchsorted(track.ts, ts, side="right")) - 1
        i = max(0, i)
        for t in self._tracks:
            # The target is in the seek track's timescale; rescale the
            # tick value per track before positioning its cursor (video
            # and audio timescales virtually always differ).
            t_ts = ts
            if track.timescale and t.timescale and \
                    t.timescale != track.timescale:
                t_ts = ts * t.timescale // track.timescale
            j = int(np.searchsorted(t.ts, t_ts, side="right")) - 1
            self._cursor[t.track_id] = max(0, j)
        return SeekedTo(track.track_id, ts, int(track.ts[i]))

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        if self._sidx_segments:  # bulk consumer: materialize everything
            self._ensure_fragments_loaded(len(self._sidx_segments) - 1)
        t = self._default_mp4_track()
        if track_id is not None:
            t = next(tt for tt in self._tracks if tt.track_id == track_id)
        n = len(t.offsets)
        # Table ts carries pts (dts + ctts offset), same as next_packet.
        ts_out = t.ts.copy()
        if t.pts_off is not None and len(t.pts_off):
            m = min(n, len(t.pts_off))
            ts_out[:m] += t.pts_off[:m]
        return PacketTable(
            track_id=t.track_id,
            offsets=t.offsets + self._start,
            sizes=t.sizes.copy(),
            ts=ts_out,
            dur=t.durs.copy(),
            trim_start=np.zeros(n, np.int32),
            trim_end=np.zeros(n, np.int32),
            data=[self._buf[int(o) : int(o + s)] for o, s in zip(t.offsets, t.sizes)],
        )


class Mp4StreamReader(IsoMp4Reader):
    """Forward-only (pipe) MP4 reader, O(window) for streamable layouts.

    The reference reads the stream sequentially the same way
    (demuxer.rs:618-663 reads each sample at its table offset; on a pipe
    that requires moov-before-mdat). Metadata atoms are stored as they
    arrive; once the moov (or, for fragments, each moof) is parsed, the
    following mdat's sample bytes are read forward through the MSS window
    at packet time. mdat-before-moov inputs degrade gracefully: those
    mdat bodies are buffered (no random access on a pipe), everything
    else still streams.
    """

    # A sample needs >= 1 byte; on a pipe the file size is unknown, so a
    # crafted uniform-stsz count is bounded by this instead (16M samples
    # is a 128 MB table — far beyond any real streamed program).
    _STSZ_PIPE_BOUND = 1 << 24

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        FormatReader.__init__(self, mss, options)
        self._metadata = MetadataLog()
        self._start = mss.pos()
        self._stsz_byte_bound = self._STSZ_PIPE_BOUND
        view = _RangeView(None, self._start, 1 << 62)
        self._view = view
        self._buf = view
        self._tracks = []
        self._sidx_segments: List[Tuple[int, int, int]] = []
        self._sidx_timescale = 0
        self._sidx_track_id = None
        self._frag_loaded = 0
        self._moov_parsed = False
        self._saw_ftyp = False
        self._eof = False
        self._cur_mdat_end: Optional[int] = None
        self._pending: deque = deque()
        self._emitted_dts: dict = {}  # track_id -> last emitted dts
        self._sched: Dict[int, int] = {}  # per-track scheduled-sample count

        # Walk until the moov has been parsed (buffering any mdat bodies
        # that precede it), so track params exist before the first packet.
        while not self._moov_parsed and self._step_atom(buffer_mdat=True):
            pass
        if not self._moov_parsed:
            raise Unsupported("missing moov atom" if self._saw_ftyp
                              else "not an ISO media file")
        self._finish_tracks()

    # -- incremental atom walk ---------------------------------------------

    def _pos(self) -> int:
        return self.mss.pos() - self._start

    def _step_atom(self, buffer_mdat: bool) -> bool:
        """Consume one top-level atom from the pipe. Returns False at EOF.

        In streaming mode (buffer_mdat=False) an mdat atom is not
        consumed: its samples are scheduled and emission reads them
        forward; the walk resumes past the mdat once the schedule drains.
        """
        mss = self.mss
        # Realign past the current mdat's unread tail first.
        if self._cur_mdat_end is not None:
            cur = self._pos()
            if cur < self._cur_mdat_end:
                try:
                    mss.ignore_bytes(self._cur_mdat_end - cur)
                except EndOfStream:
                    self._eof = True
                    return False
            elif cur > self._cur_mdat_end:
                # Emission read past the tracked mdat (multi-mdat table):
                # the walk cannot re-find an atom boundary on a pipe, so
                # stop rather than misparse sample bytes as headers.
                self._eof = True
                return False
            self._cur_mdat_end = None
        pos = self._pos()
        try:
            hdr = mss.read_bytes(8)
        except EndOfStream:
            self._eof = True
            return False
        size = int.from_bytes(hdr[0:4], "big")
        atype = hdr[4:8]
        hlen = 8
        if size == 1:
            try:
                hdr += mss.read_bytes(8)
            except EndOfStream:
                self._eof = True
                return False
            size = int.from_bytes(hdr[8:16], "big")
            hlen = 16
        elif size == 0:
            size = None  # to end of stream
        if size is not None and size < hlen:
            self._eof = True
            return False
        self._view.add(pos, hdr)
        body_lo = pos + hlen
        body_hi = None if size is None else pos + size

        if atype == b"mdat":
            if self._moov_parsed:
                self._schedule_new_samples()
                self._cur_mdat_end = body_hi
                if not buffer_mdat:
                    return True
                # Pre-moov walk continuing over a post-moov mdat cannot
                # happen (the walk stops once moov parses); fall through
                # only for safety.
            # moov not seen yet: buffer the body so its samples remain
            # addressable once the tables arrive.
            want = ((body_hi - body_lo)
                    if body_hi is not None else (1 << 62))
            got = bytearray()
            while want > 0:
                chunk = mss.read_upto(min(want, 1 << 22))
                if not chunk:
                    break
                got += chunk
                want -= len(chunk)
            self._view.add(body_lo, bytes(got))
            self._cur_mdat_end = None
            if want > 0 and body_hi is not None:
                self._eof = True
                return False
            return True

        if atype == b"ftyp":
            self._saw_ftyp = True
        if body_hi is None:
            # Unsized non-mdat atom: read to EOF (bounded by the cap).
            body = mss.read_upto(IsoMp4Reader._KEEP_CAP)
            self._view.add(body_lo, body)
            body_hi = body_lo + len(body)
            self._eof = True
        else:
            cap = (IsoMp4Reader._KEEP_CAP_MOOV if atype == b"moov"
                   else IsoMp4Reader._KEEP_CAP)
            if body_hi - body_lo > cap:
                try:
                    mss.ignore_bytes(body_hi - body_lo)
                except EndOfStream:
                    self._eof = True
                    return False
                return True
            try:
                self._view.add(body_lo, mss.read_bytes(body_hi - body_lo))
            except EndOfStream:
                self._eof = True
                return False

        if atype == b"moov":
            if not self._moov_parsed:  # a duplicate (mutated) moov must
                self._parse_moov_atoms(body_lo, body_hi)  # not re-schedule
        elif atype == b"moof" and self._moov_parsed:
            self._parse_fragments(self._view, pos, body_hi)
        return True

    def _parse_moov_atoms(self, lo: int, hi: int) -> None:
        trak_err: Optional[DecodeError] = None
        for atype, b, e in iter_atoms(self._view, lo, hi):
            if atype == b"trak":
                try:  # skip malformed traks; keep valid siblings
                    t = self._parse_trak(self._view, b, e)
                except DecodeError as exc:
                    trak_err = trak_err or exc
                    continue
                if t is not None and (t.codec is not None
                                      or t.other_params is not None):
                    self._tracks.append(t)
            elif atype == b"mvex":
                self._parse_mvex(self._view, b, e)
            elif atype == b"udta":
                self._parse_udta(self._view, b, e)
        if not self._tracks and trak_err is not None:
            raise trak_err
        self._moov_parsed = True
        self._sched = {t.track_id: 0 for t in self._tracks}
        # Samples may already be addressable (mdat buffered pre-moov).
        self._schedule_new_samples()

    def _schedule_new_samples(self) -> None:
        """Move every not-yet-scheduled table row into the pending queue,
        merged across tracks in file-offset order (offset order IS the
        only order a forward-only source can serve)."""
        entries = []
        for t in self._tracks:
            if t.offsets is None:
                continue
            i0 = self._sched.get(t.track_id, 0)
            for i in range(i0, len(t.offsets)):
                dts = int(t.ts[i])
                pts = dts
                if t.pts_off is not None and i < len(t.pts_off):
                    pts += int(t.pts_off[i])
                kf = (bool(t.key[i]) if t.key is not None and i < len(t.key)
                      else True)
                # dts rides along for seek matching: pts is non-monotonic
                # in decode order for ctts-bearing video tracks.
                entries.append((int(t.offsets[i]), int(t.sizes[i]),
                                pts, int(t.durs[i]), t.track_id, kf, dts))
            self._sched[t.track_id] = len(t.offsets)
        entries.sort(key=lambda x: x[0])
        self._pending.extend(entries)

    # -- packet interface ----------------------------------------------------

    def next_packet(self) -> Optional[Packet]:
        while True:
            while not self._pending:
                if self._eof:
                    return None
                if not self._step_atom(buffer_mdat=False):
                    if not self._pending:
                        return None
                    break
            off, size, ts, dur, tid, kf, dts = self._pending.popleft()
            self._emitted_dts[tid] = dts
            if size <= 0:
                continue
            hi = off + size
            if self._view.covers(off, hi):  # buffered (mdat-before-moov)
                data = self._view[off:hi]
            else:
                cur = self._pos()
                if off < cur:
                    # Overlapping/backward layout cannot stream; skip the
                    # packet rather than desync the whole walk.
                    continue
                try:
                    if off > cur:
                        self.mss.ignore_bytes(off - cur)
                    data = self.mss.read_bytes(size)
                except EndOfStream:
                    self._eof = True
                    return None
            return Packet(track_id=tid, ts=ts, dur=dur, data=data,
                          keyframe=kf)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        """Forward-only seek: drop pending packets before the target
        (backward targets raise, as on every pipe reader)."""
        track = self._default_mp4_track()
        if to.track_id is not None:
            track = next((t for t in self._tracks
                          if t.track_id == to.track_id), track)
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = int(to.time.to_seconds() * (track.timescale or 1))
        else:
            raise SeekError("no seek target")
        last = self._emitted_dts.get(track.track_id)
        if last is not None and ts < last:
            raise SeekError("cannot seek backward on a pipe")
        while True:
            for i, ent in enumerate(self._pending):
                # Match on dts (ent[6]): monotonic per track in decode
                # order, unlike pts for ctts-bearing video. The bulk
                # reader's seek also reports the landed sample's dts.
                if ent[4] == track.track_id and ent[6] + ent[3] > ts:
                    for _ in range(i):
                        self._pending.popleft()
                    return SeekedTo(track.track_id, ts, ent[6])
            self._pending.clear()
            if self._eof or not self._step_atom(buffer_mdat=False):
                raise SeekError("seek target beyond end of stream")

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        """Drain the pipe once into a materialized table (bulk consumers
        on unseekable sources inherently need the bytes in memory)."""
        rows = []
        while True:
            p = self.next_packet()
            if p is None:
                break
            if track_id is None or p.track_id == track_id:
                rows.append(p)
        tid = track_id if track_id is not None else \
            self._default_mp4_track().track_id
        rows = [p for p in rows if p.track_id == tid]
        n = len(rows)
        return PacketTable(
            track_id=tid,
            offsets=np.zeros(n, np.int64),
            sizes=np.asarray([len(p.data) for p in rows], np.int64),
            ts=np.asarray([p.ts for p in rows], np.int64),
            dur=np.asarray([p.dur for p in rows], np.int64),
            trim_start=np.zeros(n, np.int32),
            trim_end=np.zeros(n, np.int32),
            data=[p.data for p in rows],
        )


def _make_mp4_reader(mss, options: Optional[FormatOptions] = None):
    if mss.is_seekable():
        return IsoMp4Reader(mss, options)
    return Mp4StreamReader(mss, options)


def _score(context: bytes) -> int:
    if len(context) >= 12 and context[4:8] == b"ftyp":
        return 255
    if context[4:8] in (b"moov", b"mdat", b"free", b"skip", b"wide"):
        return 220
    return 0


# Markers: atom size (almost always starts 0x00 0x00) followed by ftyp etc.
# Match on common size prefixes via the score function; register the ftyp
# marker relative to position 4 is not expressible, so use 2-byte size-high
# prefix 0x00 0x00 (most files) and rely on score.
DESCRIPTOR = Descriptor(
    name="isomp4",
    markers=[b"\x00\x00"],
    factory=_make_mp4_reader,
    score=_score,
    tier=2,
)
