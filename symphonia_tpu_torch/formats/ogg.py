"""OGG demuxer.

Analog of symphonia-format-ogg (``OggReader``, demuxer.rs:34): CRC32-checked
page parsing (page.rs:144-331), physical->logical stream demux by serial
with packet reassembly across pages (logical.rs:50-620), codec *mappers*
that identify id-packets and assign packet durations — Vorbis
(mappings/vorbis.rs), FLAC (mappings/flac.rs), Opus (mappings/opus.rs) —
granule-position timestamping, and seek over the packet table.

Batch-first: the stream is scanned once into a page/packet table
(numpy-accelerated capture-pattern search) that serves next_packet,
packet_table, and bisection-free accurate seek.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.audio import Channels
from ..core.checksum import crc32_buf
from ..core.codecs import (
    CODEC_ID_FLAC,
    CODEC_ID_OPUS,
    CODEC_ID_VORBIS,
    AudioCodecParameters,
    VerificationCheck,
)
from ..core.errors import DecodeError, ResetRequired, SeekError, Unsupported
from ..core.formats import (
    FormatOptions,
    FormatReader,
    PacketTable,
    SeekMode,
    SeekTo,
    SeekedTo,
    Track,
)
from ..core.meta import MetadataLog, MetadataRevision
from ..core.packet import Packet
from ..core.probe import Descriptor
from ..core.units import TimeBase
from ..metadata.vorbis import parse_vorbis_comment

OGG_MARKER = b"OggS"


@dataclass
class OggPage:
    header_type: int
    granule: int
    serial: int
    seq: int
    packets: List[bytes]  # complete packet segments on this page
    partial: Optional[bytes]  # unterminated trailing data
    continued: bool  # first segment continues a previous packet


def parse_page(buf: bytes, pos: int, check_crc: bool = True) -> Tuple[OggPage, int]:
    """Parse one page at ``pos``; returns (page, next_pos) (page.rs:169)."""
    hdr = buf[pos : pos + 27]
    if len(hdr) < 27 or hdr[:4] != OGG_MARKER or hdr[4] != 0:
        raise DecodeError("invalid OGG page header")
    header_type = hdr[5]
    granule = int.from_bytes(hdr[6:14], "little", signed=True)
    serial, seq, crc = struct.unpack("<III", hdr[14:26])
    n_segs = hdr[26]
    seg_table = buf[pos + 27 : pos + 27 + n_segs]
    if len(seg_table) < n_segs:
        raise DecodeError("truncated page")
    body_len = int(sum(seg_table))
    body_start = pos + 27 + n_segs
    body = buf[body_start : body_start + body_len]
    if len(body) < body_len:
        raise DecodeError("truncated page body")
    if check_crc:
        zeroed = bytearray(buf[pos : body_start + body_len])
        zeroed[22:26] = b"\x00\x00\x00\x00"
        if crc32_buf(bytes(zeroed)) != crc:
            raise DecodeError("OGG page CRC mismatch")

    packets: List[bytes] = []
    partial: Optional[bytes] = None
    cur = bytearray()
    off = 0
    for lace in seg_table:
        cur += body[off : off + lace]
        off += lace
        if lace < 255:
            packets.append(bytes(cur))
            cur = bytearray()
    if cur:
        partial = bytes(cur)
    return (
        OggPage(header_type, granule, serial, seq, packets, partial,
                bool(header_type & 0x01)),
        body_start + body_len,
    )


# ---------------------------------------------------------------------------
# Codec mappers (mappings/*.rs)
# ---------------------------------------------------------------------------


class Mapper:
    codec: str = "null"
    sample_rate: int = 0
    delay: int = 0  # encoder lead-in frames (Opus pre-skip, opus.rs:62)

    def absorb_header(self, packet: bytes, meta: MetadataLog) -> bool:
        """Consume a header packet; True while more headers expected."""
        raise NotImplementedError

    def packet_dur(self, packet: bytes) -> int:
        raise NotImplementedError

    def codec_params(self) -> AudioCodecParameters:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def prime(self, packet: bytes) -> None:
        """Restore cross-packet duration state from the packet just BEFORE
        a seek landing point (no duration is emitted). Codecs whose packet
        durations are self-contained ignore this."""


class VorbisMapper(Mapper):
    """mappings/vorbis.rs: duration from mode block sizes."""

    codec = CODEC_ID_VORBIS

    def __init__(self, id_packet: bytes):
        from ..codecs.vorbis_setup import read_ident_header

        self.ident = read_ident_header(id_packet)
        self.sample_rate = self.ident.sample_rate
        self._id = id_packet
        self._setup: Optional[bytes] = None
        self._mode_flags: Optional[List[bool]] = None
        self._prev_bs: Optional[int] = None

    def absorb_header(self, packet: bytes, meta: MetadataLog) -> bool:
        if packet[:7] == b"\x03vorbis":
            try:
                meta.push(parse_vorbis_comment(packet[7:]))
            except DecodeError:
                pass  # malformed comment header: skip the metadata
            return True
        if packet[:7] == b"\x05vorbis":
            self._setup = packet
            # Skim: the mapper only needs the mode list for packet
            # durations; the decoder re-parses codebooks fully. Native
            # fast path first (strictly stricter parser — a reject falls
            # back to the authoritative Python walk).
            flags = None
            try:
                from .. import native as _native

                flags = _native.vorbis_skim_modes(self._id, packet)
            except Exception:
                flags = None
            if flags is None:
                from ..codecs.vorbis_setup import read_setup_header

                setup = read_setup_header(packet, self.ident, skim=True)
                flags = [m.block_flag for m in setup.modes]
            self._mode_flags = flags
            # Precomputed packet_dur fields (this runs per packet during
            # the bulk reader's physical-stream walk).
            from ..codecs.vorbis_setup import ilog

            self._dur_bits = ilog(len(flags) - 1)
            self._dur_mask = (1 << self._dur_bits) - 1
            bs0, bs1 = 1 << self.ident.bs0_exp, 1 << self.ident.bs1_exp
            self._bs_table = [bs1 if f else bs0 for f in flags]
            return False  # headers complete
        return True

    def packet_dur(self, packet: bytes) -> int:
        if not packet or packet[0] & 1 or self._mode_flags is None:
            return 0
        mode = (packet[0] >> 1) & self._dur_mask
        if mode >= len(self._bs_table):
            return 0
        bs = self._bs_table[mode]
        if self._prev_bs is None:
            dur = 0
        else:
            dur = (self._prev_bs + bs) // 4
        self._prev_bs = bs
        return dur

    def codec_params(self) -> AudioCodecParameters:
        extra = bytearray([2])
        for p in (self._id, b"\x03vorbis\x00\x00\x00\x00\x00\x01"):
            n = len(p)
            while n >= 255:
                extra.append(255)
                n -= 255
            extra.append(n)
        extra += self._id
        extra += b"\x03vorbis\x00\x00\x00\x00\x00\x01"
        extra += self._setup or b""
        return AudioCodecParameters(
            codec=self.codec,
            sample_rate=self.ident.sample_rate,
            channels=Channels.from_count(self.ident.n_channels),
            extra_data=bytes(extra),
        )

    def reset(self) -> None:
        self._prev_bs = None

    def prime(self, packet: bytes) -> None:
        # Extracting the mode flag sets _prev_bs; discard the duration.
        self._prev_bs = None
        self.packet_dur(packet)


class FlacMapper(Mapper):
    """mappings/flac.rs: OGG-encapsulated FLAC."""

    codec = CODEC_ID_FLAC

    def __init__(self, id_packet: bytes):
        from ..common.flac import StreamInfo

        # 0x7F 'FLAC' major minor nhdr(2) 'fLaC' block_header(4) STREAMINFO
        if id_packet[9:13] != b"fLaC":
            raise DecodeError("invalid OGG FLAC id packet")
        self.stream_info = StreamInfo.parse(id_packet[17:])
        self._si_payload = id_packet[17 : 17 + 34]
        self.sample_rate = self.stream_info.sample_rate

    def absorb_header(self, packet: bytes, meta: MetadataLog) -> bool:
        if not packet:
            return True  # zero-length header lace: skip, keep absorbing
        btype = packet[0] & 0x7F
        last = bool(packet[0] & 0x80)
        if btype == 4:
            try:
                meta.push(parse_vorbis_comment(packet[4:]))
            except DecodeError:
                pass
        return not last

    def packet_dur(self, packet: bytes) -> int:
        from ..common.flac import parse_frame_header

        try:
            return parse_frame_header(packet, self.stream_info).block_size
        except DecodeError:
            return 0

    def codec_params(self) -> AudioCodecParameters:
        si = self.stream_info
        return AudioCodecParameters(
            codec=self.codec,
            sample_rate=si.sample_rate,
            bits_per_sample=si.bits_per_sample,
            channels=Channels.from_count(si.channels),
            extra_data=self._si_payload,
            verification_check=VerificationCheck("md5", si.md5)
            if si.md5 != b"\x00" * 16
            else None,
        )


# Opus TOC config -> frame duration in 48 kHz samples (RFC 6716 §3.1).
_OPUS_FRAME_SIZES = [
    480, 960, 1920, 2880,  # SILK NB
    480, 960, 1920, 2880,  # SILK MB
    480, 960, 1920, 2880,  # SILK WB
    480, 960,              # Hybrid SWB
    480, 960,              # Hybrid FB
    120, 240, 480, 960,    # CELT NB
    120, 240, 480, 960,    # CELT WB
    120, 240, 480, 960,    # CELT SWB
    120, 240, 480, 960,    # CELT FB
]


class OpusMapper(Mapper):
    """mappings/opus.rs: demux-only (no Opus decoder, matching the
    reference's support level)."""

    codec = CODEC_ID_OPUS
    sample_rate = 48000

    def __init__(self, id_packet: bytes):
        if id_packet[:8] != b"OpusHead" or len(id_packet) < 12:
            raise DecodeError("invalid OpusHead")
        self.n_channels = id_packet[9]
        self.pre_skip = int.from_bytes(id_packet[10:12], "little")
        self.delay = self.pre_skip
        self._id = id_packet

    def absorb_header(self, packet: bytes, meta: MetadataLog) -> bool:
        if packet[:8] == b"OpusTags":
            try:
                meta.push(parse_vorbis_comment(packet[8:]))
            except DecodeError:
                pass
        return False

    def packet_dur(self, packet: bytes) -> int:
        if not packet:
            return 0
        toc = packet[0]
        config = toc >> 3
        count_code = toc & 0x3
        frame = _OPUS_FRAME_SIZES[config]
        if count_code == 0:
            n = 1
        elif count_code in (1, 2):
            n = 2
        else:
            n = packet[1] & 0x3F if len(packet) > 1 else 1
        return frame * n

    def codec_params(self) -> AudioCodecParameters:
        return AudioCodecParameters(
            codec=self.codec,
            sample_rate=48000,
            channels=Channels.from_count(self.n_channels),
            extra_data=self._id,
        )


def make_mapper(id_packet: bytes) -> Optional[Mapper]:
    if id_packet[:7] == b"\x01vorbis":
        return VorbisMapper(id_packet)
    if id_packet[:5] == b"\x7fFLAC":
        return FlacMapper(id_packet)
    if id_packet[:8] == b"OpusHead":
        return OpusMapper(id_packet)
    return None


def _mappable_bos(id_packet: bytes) -> bool:
    """True when the BOS id packet constructs a mapper. A matching magic
    whose header is malformed is NOT mappable (and must not abort the
    reader: the other logical streams still are, demuxer.rs:416-427)."""
    try:
        return make_mapper(id_packet) is not None
    except DecodeError:
        return False


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclass
class _PacketEntry:
    data: bytes
    ts: int
    dur: int
    trim_start: int = 0
    trim_end: int = 0
    pi: int = 0  # physical page index (interleave order across streams)


class OggReader(FormatReader):
    """OGG format reader (ogg demuxer.rs:34). A chained physical stream
    raises ResetRequired at the boundary (demuxer.rs:305)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        start_pos = mss.pos()
        chunks = []
        while True:
            b = mss.read_upto(1 << 22)
            if not b:
                break
            chunks.append(b)
        buf = b"".join(chunks)
        if not buf.startswith(OGG_MARKER):
            raise Unsupported("missing OggS capture pattern")

        # Scan pages. Capture-pattern candidates are computed ONCE and
        # advanced through by searchsorted: re-running the vectorized
        # search over the whole tail after every failed candidate was
        # quadratic (a dense-fake-marker file hung the probe for minutes).
        pages: List[OggPage] = []
        a = np.frombuffer(buf, dtype=np.uint8)
        marks = (np.nonzero(
            (a[:-3] == 0x4F) & (a[1:-2] == 0x67)
            & (a[2:-1] == 0x67) & (a[3:] == 0x53))[0]
            if len(buf) >= 4 else np.zeros(0, np.int64))
        pos = 0
        n = len(buf)
        while pos + 27 <= n:
            if buf[pos : pos + 4] != OGG_MARKER:
                mi = int(np.searchsorted(marks, pos))
                if mi >= len(marks):
                    break
                pos = int(marks[mi])
            try:
                page, pos = parse_page(buf, pos)
            except DecodeError:
                pos += 1
                continue
            pages.append(page)

        self._load_physical(pages)

    def _load_physical(self, pages: List[OggPage]) -> None:
        """Assemble one physical stream's logical streams; any chained
        physical stream's pages are kept for ResetRequired handling
        (demuxer.rs:305)."""
        streams: Dict[int, dict] = {}
        bos_order: List[int] = []
        end_of_physical = None
        for pi, page in enumerate(pages):
            if page.header_type & 0x02:  # BOS
                if streams and all(s.get("eos") for s in streams.values()):
                    end_of_physical = pi
                    break
                if page.serial in streams:
                    continue
                streams[page.serial] = {
                    "packets": [], "pending": b"", "mapper": None,
                    "headers_done": False, "page_granules": [], "eos": False,
                }
                bos_order.append(page.serial)
            st = streams.get(page.serial)
            if st is None or st["eos"]:
                continue
            pkts = list(page.packets)
            if page.continued and st["pending"]:
                if pkts:
                    pkts[0] = st["pending"] + pkts[0]
                    st["pending"] = b""
                elif page.partial is not None:
                    st["pending"] += page.partial
                    continue
            elif page.continued:
                # continuation without pending data: drop partial head
                if pkts:
                    pkts = pkts[1:]
            for p in pkts:
                if st["mapper"] is None:
                    if not st.get("unmappable"):
                        try:
                            st["mapper"] = make_mapper(p)
                        except DecodeError:
                            # Matching magic, malformed header: this
                            # stream is dead but its siblings are not.
                            st["unmappable"] = True
                    continue
                if not st["headers_done"] and st["mapper"] is not None:
                    more = st["mapper"].absorb_header(p, self._metadata)
                    if not more:
                        st["headers_done"] = True
                    continue
                st["packets"].append([p, pi])
            if page.partial is not None:
                st["pending"] += page.partial
            if page.granule >= 0 and not (page.header_type & 0x02):
                st["page_granules"].append((len(st["packets"]), page.granule))
            if page.header_type & 0x04:
                st["eos"] = True

        # Every mappable logical stream becomes a track (demuxer.rs:416-427:
        # grouped/multiplexed physical streams expose all logical streams;
        # track ids enumerate BOS order so single-stream files keep id 0).
        self._streams = []
        for serial in bos_order:
            st = streams[serial]
            if st["mapper"] is None:
                continue
            entries, start_ts, total = self._build_entries(st)
            m: Mapper = st["mapper"]
            st["entries"] = entries
            # Cached for seek bisection (rebuilding per call is O(packets)).
            st["ts_keys"] = np.asarray([e.ts for e in entries], np.int64)
            st["cursor"] = 0
            st["track"] = Track(
                id=len(self._streams),
                codec_params=m.codec_params(),
                time_base=TimeBase(1, m.sample_rate),
                num_frames=total - start_ts,
                start_ts=start_ts,
                delay=m.delay,
            )
            self._streams.append(st)
        if not self._streams:
            raise Unsupported("no mappable codec in OGG stream")
        self._stream = self._streams[0]
        self.mapper = self._stream["mapper"]
        self._track = self._stream["track"]
        self._chained_pages = pages[end_of_physical:] if end_of_physical else []

    @staticmethod
    def _build_entries(st):
        """Timestamps/trims for one logical stream, anchored to its page
        granules (logical.rs:230-556)."""
        mapper: Mapper = st["mapper"]
        entries: List[_PacketEntry] = []
        start_ts = 0
        ts = 0
        for p, pi in st["packets"]:
            dur = mapper.packet_dur(p)
            entries.append(_PacketEntry(p, ts, dur, pi=pi))
            ts += dur
        total = ts
        granules = st["page_granules"]
        if granules:
            # Leading trim: the first audio page's end granule is the
            # absolute sample position after its packets; when the decoded
            # duration up to that point exceeds it, the head is trimmed
            # (logical.rs:330-556 start_ts derivation). Header pages carry
            # granule 0 with no audio packets — skip to the first entry
            # that covers at least one packet.
            first_count, first_granule = next(
                ((c, g) for c, g in granules if c > 0), (0, -1))
            head_dur = sum(e.dur for e in entries[:first_count])
            if first_granule > head_dur and first_count > 0:
                # Stream starts at t > 0 (logical.rs:230 start_ts =
                # granule_end - total_dur): Opus granules include the
                # pre-skip, and mid-stream captures start late. Keep raw
                # granule time, exposing the offset as Track.start_ts.
                start_ts = first_granule - head_dur
                ts = start_ts
                for e in entries:
                    e.ts = ts
                    ts += e.dur
                total = ts
            if 0 <= first_granule < head_dur:
                trim = head_dur - first_granule
                for e in entries:
                    t = min(trim, e.dur)
                    e.trim_start += t
                    e.dur -= t
                    trim -= t
                    if trim <= 0:
                        break
                ts = 0
                for e in entries:
                    e.ts = ts
                    ts += e.dur
                total = ts
            last_count, last_granule = granules[-1]
            # Trailing partial-block trim (end granule < decoded length).
            if last_count == len(entries) and 0 < last_granule < total:
                trim = total - last_granule
                for e in reversed(entries):
                    t = min(trim, e.dur)
                    e.trim_end += t
                    e.dur -= t
                    trim -= t
                    if trim <= 0:
                        break
                # re-run timestamps
                ts = 0
                for e in entries:
                    e.ts = ts
                    ts += e.dur
                total = ts
        return entries, start_ts, total

    # -- FormatReader ------------------------------------------------------

    def tracks(self) -> List[Track]:
        return [st["track"] for st in self._streams]

    def next_packet(self) -> Optional[Packet]:
        # Deliver in physical page order across logical streams
        # (demuxer.rs:476: packets surface as pages are read; callers
        # filter by track id).
        best = None
        for tid, st in enumerate(self._streams):
            c = st["cursor"]
            if c < len(st["entries"]):
                key = (st["entries"][c].pi, tid)
                if best is None or key < best:
                    best = key
        if best is None:
            if self._chained_pages:
                # Chained physical stream: rebuild tracks and signal the
                # caller to recreate decoders (formats/mod.rs:644).
                self._load_physical(self._chained_pages)
                raise ResetRequired("chained OGG physical stream")
            return None
        tid = best[1]
        st = self._streams[tid]
        e = st["entries"][st["cursor"]]
        st["cursor"] += 1
        return Packet(track_id=tid, ts=e.ts, dur=e.dur, data=e.data,
                      trim_start=e.trim_start, trim_end=e.trim_end)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        tid = to.track_id if to.track_id is not None else 0
        if not (0 <= tid < len(self._streams)):
            raise SeekError("unknown track id")
        track: Track = self._streams[tid]["track"]
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")

        # Reposition EVERY logical stream to the same wall-clock instant
        # (demuxer.rs:163-304 bisects the physical stream, which moves all
        # logical streams together).
        t = track.time_base.calc_time(ts)
        actual = 0
        for j, st in enumerate(self._streams):
            sts = ts if j == tid else st["track"].time_base.calc_timestamp(t)
            i = max(0, int(np.searchsorted(st["ts_keys"], sts,
                                           side="right")) - 1)
            # Back up one packet so the decoder regains its overlap state.
            if mode == SeekMode.ACCURATE:
                i = max(0, i - 1)
            st["cursor"] = i
            st["mapper"].reset()
            if j == tid:
                actual = st["entries"][i].ts if st["entries"] else 0
        return SeekedTo(tid, ts, actual)

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        tid = track_id if track_id is not None else 0
        if not (0 <= tid < len(self._streams)):
            raise SeekError("unknown track id")
        es = self._streams[tid]["entries"]
        n = len(es)
        return PacketTable(
            track_id=tid,
            offsets=np.full(n, -1, dtype=np.int64),
            sizes=np.asarray([len(e.data) for e in es], dtype=np.int64),
            ts=np.asarray([e.ts for e in es], dtype=np.int64),
            dur=np.asarray([e.dur for e in es], dtype=np.int64),
            trim_start=np.asarray([e.trim_start for e in es], dtype=np.int32),
            trim_end=np.asarray([e.trim_end for e in es], dtype=np.int32),
            data=[e.data for e in es],
        )


class _SecondaryStream:
    """Per-serial state for an additional mappable logical stream of a
    grouped (multiplexed) physical stream read over a pipe. Shares the
    primary's packet/trim machinery (the ``st`` parameter of
    OggStreamReader._page_packets/_enqueue_packet/_after_page)."""

    def __init__(self, mapper: "Mapper", serial: int, track_id: int):
        self.mapper = mapper
        self.serial = serial
        self._track_id = track_id
        self._pending = b""
        self._ts = 0
        self._queue: List[Packet] = []
        self._anchored = False
        self._first_granule_pending = True
        self._eos = False
        self._start_ts = 0
        self.headers_done = False
        self.dead = False  # headers never completed: drop the stream
        self._track: Optional[Track] = None

    def finish_headers(self) -> None:
        self.headers_done = True
        self._track = Track(
            id=self._track_id,
            codec_params=self.mapper.codec_params(),
            time_base=TimeBase(1, self.mapper.sample_rate),
            num_frames=None,
            start_ts=self._start_ts,
            delay=self.mapper.delay,
        )


class OggStreamReader(FormatReader):
    """Incremental OGG reader: O(window) memory over the MSS, one page at a
    time (demuxer.rs:134 + logical.rs packet reassembly), with byte-bisection
    seek on granule positions for seekable sources (demuxer.rs:163-304).

    This is the streaming counterpart of the read-all :class:`OggReader`
    (the bulk/batch path); unseekable sources (pipes) are routed here by the
    probe factory.
    """

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        self._data_start = mss.pos()
        self._queue: List[Packet] = []
        self._pending = b""
        self._ts = 0
        self._anchored = False
        self._first_granule_pending = True
        self._eos = False
        self.mapper: Optional[Mapper] = None
        self._serial: Optional[int] = None
        self._track_id = 0
        self._order: List[object] = []  # states, in packet-enqueue order
        self._secondary: dict = {}  # serial -> _SecondaryStream
        self._read_headers()

    # -- page IO -------------------------------------------------------------

    def _try_page_here(self) -> Optional[Tuple[OggPage, int]]:
        """Parse a page at the current MSS position without consuming.
        Returns (page, byte_len) or None if the bytes here aren't a page."""
        hdr = self.mss.peek_bytes(27)
        if len(hdr) < 27 or hdr[:4] != OGG_MARKER or hdr[4] != 0:
            return None
        n_segs = hdr[26]
        head = self.mss.peek_bytes(27 + n_segs)
        if len(head) < 27 + n_segs:
            return None
        body_len = int(sum(head[27:]))
        total = 27 + n_segs + body_len
        buf = self.mss.peek_bytes(total)
        if len(buf) < total:
            return None
        try:
            page, _ = parse_page(buf, 0)
        except DecodeError:
            return None
        return page, total

    def _next_page(self, resync_limit: int = 1 << 20) -> Optional[OggPage]:
        """Read the next CRC-valid page, resyncing over junk (bounded)."""
        skipped = 0
        while skipped <= resync_limit:
            got = self._try_page_here()
            if got is not None:
                page, total = got
                self.mss.ignore_bytes(total)
                return page
            b = self.mss.read_upto(1)
            if not b:
                return None
            skipped += 1
        return None

    # -- logical stream ------------------------------------------------------

    def _read_headers(self, bos_page: Optional[OggPage] = None) -> None:
        """Identify the primary mappable stream and absorb its headers.
        ``bos_page``: an already-consumed BOS page starting a (chained)
        physical stream."""
        self.mapper = None
        self._serial = None
        self._headers_done = False
        hdr_pages = 0

        def secondaries_pending() -> bool:
            return any(not st.headers_done and not st.dead
                       for st in self._secondary.values())

        while (self.mapper is None or not self._headers_done
               or secondaries_pending()):
            if bos_page is not None:
                page, bos_page = bos_page, None
            else:
                page = self._next_page()
            if page is None or hdr_pages >= 1024:
                if self.mapper is not None and self._headers_done:
                    # Primary is complete: a sibling whose headers never
                    # finish is dropped, not fatal.
                    for st in self._secondary.values():
                        if not st.headers_done:
                            st.dead = True
                    break
                raise Unsupported(
                    "no mappable codec in OGG stream" if page is None
                    else "OGG header phase too long")
            hdr_pages += 1
            if self.mapper is None:
                if not (page.header_type & 0x02) or not page.packets:
                    continue
                try:
                    m = make_mapper(page.packets[0])
                except DecodeError:
                    m = None  # malformed id header: stream unmappable
                if m is None:
                    continue  # skip unmappable BOS streams
                self.mapper = m
                self._serial = page.serial
                for p in page.packets[1:]:
                    if not self._headers_done:
                        if not self.mapper.absorb_header(p, self._metadata):
                            self._headers_done = True
                    else:
                        # Non-spec packing: audio packets on the BOS page
                        # are real packets, not headers (the bulk reader
                        # enqueues them too).
                        self._enqueue_packet(p)
                self._pending = page.partial or b""
                continue
            if page.serial != self._serial:
                self._route_secondary(page)
                continue
            pkts = self._page_packets(page)
            for p in pkts:
                if not self._headers_done:
                    if not self.mapper.absorb_header(p, self._metadata):
                        self._headers_done = True
                else:
                    self._enqueue_packet(p)
            self._after_page(page)
        params = self.mapper.codec_params()
        self._track = Track(
            id=0,
            codec_params=params,
            time_base=TimeBase(1, self.mapper.sample_rate),
            num_frames=None,
            start_ts=getattr(self, "_start_ts", 0),
            delay=self.mapper.delay,
        )

    def _page_packets(self, page: OggPage, st=None) -> List[bytes]:
        st = self if st is None else st
        pkts = list(page.packets)
        if page.continued:
            if st._pending:
                if pkts:
                    pkts[0] = st._pending + pkts[0]
                    st._pending = page.partial or b""
                    return pkts
                st._pending += page.partial or b""
                return []
            # Continuation with no pending data (post-seek): drop the
            # headless span. A page that is entirely the middle of a
            # spanning packet must keep _pending empty — its partial has no
            # head either (the next continued page drops it too).
            if not pkts:
                return []
            pkts = pkts[1:]
        st._pending = page.partial or b""
        return pkts

    def _enqueue_packet(self, data: bytes, st=None) -> None:
        st = self if st is None else st
        dur = st.mapper.packet_dur(data)
        st._queue.append(Packet(track_id=st._track_id, ts=st._ts, dur=dur,
                                data=data))
        st._ts += dur
        self._order.append(st)

    def _after_page(self, page: OggPage, st=None) -> None:
        """Granule anchoring + first/last page trims (logical.rs:330-556)."""
        st = self if st is None else st
        if page.header_type & 0x04:
            st._eos = True
        g = page.granule
        if g < 0:
            return
        if st._first_granule_pending:
            if g == 0 and st._ts == 0 and not st._queue:
                return  # pre-audio header page (granule 0, no packets yet)
            st._first_granule_pending = False
            # Leading trim: decoded duration up to here exceeding the first
            # granule is pre-roll that the encoder expects dropped.
            if 0 <= g < st._ts:
                trim = st._ts - g
                delta = trim
                for pkt in st._queue:
                    t = min(delta, pkt.dur)
                    pkt.trim_start += t
                    pkt.dur -= t
                    delta -= t
                    if delta <= 0:
                        break
                ts = st._queue[0].ts if st._queue else 0
                for pkt in st._queue:
                    pkt.ts = ts
                    ts += pkt.dur
                st._ts = g if not st._queue else ts
            elif g > st._ts:
                # Stream starts at t > 0 (logical.rs:230: start_ts =
                # granule_end - total_dur): Opus granules include pre-skip;
                # mid-stream captures begin late. Shift onto granule time.
                shift = g - st._ts
                for pkt in st._queue:
                    pkt.ts += shift
                st._ts = g
                st._start_ts = shift
                if getattr(st, "_track", None) is not None:
                    st._track.start_ts = shift
        if st._eos and 0 < g < st._ts:
            trim = st._ts - g
            for pkt in reversed(st._queue):
                t = min(trim, pkt.dur)
                pkt.trim_end += t
                pkt.dur -= t
                trim -= t
                if trim <= 0:
                    break
            st._ts = g
        elif st._anchored or not st._first_granule_pending:
            st._ts = g  # re-anchor on every completed-granule page
        st._anchored = True

    def _route_secondary(self, page: OggPage) -> None:
        """A page of a serial other than the primary's: register/feed the
        sibling logical stream of a grouped physical stream
        (demuxer.rs:416-427 exposes every logical stream; the bulk reader
        already does — this is the pipe-side counterpart)."""
        st = self._secondary.get(page.serial)
        if st is None:
            if not (page.header_type & 0x02) or not page.packets:
                return
            try:
                m = make_mapper(page.packets[0])
            except DecodeError:
                m = None
            if m is None:
                return  # unmappable sibling: no track (bulk reader parity)
            st = _SecondaryStream(m, page.serial, 1 + len(self._secondary))
            self._secondary[page.serial] = st
            for p in page.packets[1:]:
                if not st.headers_done:
                    if not m.absorb_header(p, self._metadata):
                        st.finish_headers()
                else:
                    self._enqueue_packet(p, st)
            st._pending = page.partial or b""
            return
        if st.dead:
            return
        pkts = self._page_packets(page, st)
        for p in pkts:
            if not st.headers_done:
                if not st.mapper.absorb_header(p, self._metadata):
                    st.finish_headers()
            else:
                self._enqueue_packet(p, st)
        if st.headers_done:
            self._after_page(page, st)

    def _reset_secondaries_after_seek(self) -> None:
        """A seek invalidates sibling streams' packet spans: drop queued
        packets and re-anchor each on its next completed-granule page."""
        for st in self._secondary.values():
            st._queue.clear()
            st._pending = b""
            st.mapper.reset()
        self._order = [s for s in self._order if s is self]

    # -- FormatReader ----------------------------------------------------------

    def tracks(self) -> List[Track]:
        out = [self._track]
        for serial in self._secondary:
            st = self._secondary[serial]
            if st._track is not None and not st.dead:
                out.append(st._track)
        return out

    def _pop_ready(self) -> Optional[Packet]:
        while self._order:
            st = self._order.pop(0)
            q = st._queue
            if q:
                return q.pop(0)
            # Stale entry (queue cleared by a seek): skip.
        # Fallback: order exhausted but a queue still holds packets (the
        # seek path pops the primary queue without consuming order tokens).
        if self._queue:
            return self._queue.pop(0)
        for st in self._secondary.values():
            if st._queue:
                return st._queue.pop(0)
        return None

    def next_packet(self) -> Optional[Packet]:
        while True:
            pkt = self._pop_ready()
            if pkt is not None:
                return pkt
            page = self._next_page()
            if page is None:
                return None
            if page.header_type & 0x02 and (self._eos
                                            or page.serial != self._serial):
                # New physical stream (chained; the serial may repeat across
                # chains): rebuild the logical stream from this BOS page and
                # signal the caller to recreate its decoders
                # (formats/mod.rs:644). A grouped sibling's BOS was consumed
                # in the header phase, so mid-stream BOS of an unseen serial
                # during primary EOS is a chain boundary.
                if self._eos and page.packets and \
                        _mappable_bos(page.packets[0]):
                    self._reset_logical(page)
                    raise ResetRequired("chained OGG physical stream")
                continue
            if page.serial != self._serial:
                self._route_secondary(page)
                continue
            for p in self._page_packets(page):
                self._enqueue_packet(p)
            self._after_page(page)

    def _reset_logical(self, bos_page: OggPage) -> None:
        """Chained physical stream boundary: rebuild the logical stream
        from this BOS page; the caller raises ResetRequired
        (formats/mod.rs:644)."""
        self._queue.clear()
        self._pending = b""
        self._ts = 0
        self._anchored = False
        self._first_granule_pending = True
        self._eos = False
        # A t>0 first chain's start trim must not leak into the next
        # chain's track.
        self._start_ts = 0
        # A new physical stream has its own logical-stream group.
        self._secondary.clear()
        self._order.clear()
        self._read_headers(bos_page=bos_page)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = self._track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")
        if not self.mss.is_seekable():
            # Forward-only source: seek ahead by reading (the reference can
            # consume pages forward on a pipe); backward is impossible.
            self._reset_secondaries_after_seek()
            first = True
            while True:
                while not self._queue:
                    page = self._next_page()
                    if page is None:
                        raise SeekError("seek target beyond end of stream")
                    if page.header_type & 0x02 and (
                            self._eos or page.serial != self._serial):
                        # Chained physical stream boundary mid-seek: rebuild
                        # and tell the caller to recreate decoders (it can
                        # re-issue the seek afterwards).
                        if self._eos and page.packets and \
                                _mappable_bos(page.packets[0]):
                            self._reset_logical(page)
                            raise ResetRequired(
                                "chained OGG physical stream during seek")
                        continue
                    if page.serial != self._serial:
                        continue
                    for p2 in self._page_packets(page):
                        self._enqueue_packet(p2)
                    self._after_page(page)
                head = self._queue[0]
                if ts < head.ts:
                    if first:
                        # Target precedes everything still readable.
                        raise SeekError(
                            "cannot seek backward on an unseekable source")
                    # Granule gap: the target falls in a timestamp hole —
                    # land on the first packet past it (same as the
                    # bisection path landing at the anchor before the gap).
                    return SeekedTo(0, ts, head.ts)
                first = False
                if head.ts + max(head.dur, 0) > ts or head.ts >= ts:
                    return SeekedTo(0, ts, head.ts)
                self._queue.pop(0)
        total = self.mss.byte_len()

        def first_granule_from(pos: int) -> Optional[int]:
            """Granule of the first completed-granule page of our stream at
            or after byte pos (bounded forward scan)."""
            self.mss.seek(pos)
            for _ in range(64):
                page = self._next_page()
                if page is None:
                    return None
                if page.serial == self._serial and page.granule >= 0:
                    return page.granule
            return None

        # Byte bisection on end-granules (demuxer.rs:163-304).
        lo, hi = self._data_start, total
        while hi - lo > (1 << 16):
            mid = (lo + hi) // 2
            g = first_granule_from(mid)
            if g is None or g >= ts:
                hi = mid
            else:
                lo = mid
        # Linear page walk from lo: start after the last page whose end
        # granule is <= ts (the decoder re-primes on the next packet).
        self.mss.seek(lo)
        start_pos = lo
        anchor = 0 if lo == self._data_start else None
        prime_pkt: Optional[bytes] = None  # last full packet before landing
        last_full: Optional[bytes] = None
        while True:
            pos = self.mss.pos()
            got = self._try_page_here()
            if got is None:
                if not self.mss.read_upto(1):
                    break
                continue
            page, tot = got
            if page.serial == self._serial:
                if page.granule >= 0 and page.granule > ts:
                    break
                full = page.packets[1:] if page.continued else page.packets
                if full:
                    last_full = full[-1]
                if page.granule >= 0:
                    anchor = page.granule
                    start_pos = pos + tot
                    # If the anchor page ends with a spanning packet, that
                    # packet (not the last completed one) precedes the
                    # landing point; its head bytes carry the mode.
                    prime_pkt = page.partial if page.partial else last_full
            self.mss.ignore_bytes(tot)
        if anchor is None:
            # No anchoring page before the window: restart from the top.
            start_pos, anchor, prime_pkt = self._data_start, 0, None
        self.mss.seek(start_pos)
        self._reset_secondaries_after_seek()
        self._queue.clear()
        self._order.clear()
        self._pending = b""
        self._ts = anchor
        self._anchored = True
        # anchor == 0 means we land at (or before) the first audio page:
        # the leading-trim logic must re-run (header pages carry granule 0,
        # so start_pos has usually advanced past them even for ts=0).
        self._first_granule_pending = anchor == 0
        self._eos = False
        self.mapper.reset()
        if prime_pkt is not None:
            # Restore the cross-packet duration state (Vorbis previous
            # block size) so the first post-seek packet's duration — and
            # every timestamp after it — matches the table path exactly.
            self.mapper.prime(prime_pkt)
        return SeekedTo(0, ts, anchor)


def _make_reader(mss, options: Optional[FormatOptions] = None):
    """Probe factory: bulk read-all table for seekable sources (the batch
    path), incremental streaming reader for pipes."""
    if mss.is_seekable():
        return OggReader(mss, options)
    return OggStreamReader(mss, options)


def _score(context: bytes) -> int:
    return 255 if context.startswith(OGG_MARKER) else 0


DESCRIPTOR = Descriptor(
    name="ogg",
    markers=[OGG_MARKER],
    factory=_make_reader,
    score=_score,
)
