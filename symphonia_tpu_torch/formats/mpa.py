"""MPEG audio elementary stream demuxer (MP1/MP2/MP3).

Analog of symphonia-bundle-mp3/src/demuxer.rs (``MpaReader``, demuxer.rs:40):
strict sync (11-bit syncword + next-header confirmation, demuxer.rs:585-656),
Xing/Info/LAME and VBRI tag parsing for duration + gapless trim
(demuxer.rs:735-927: Track delay = enc_delay + 529, padding =
enc_padding - 529), packetization one frame per packet, and sample-accurate
seek over the frame table.

Batch-first: the whole stream is frame-walked once (cheap: header-size hops
with re-sync scan on mismatch) into a frame table that backs next_packet,
packet_table and seek.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..codecs.mpa_common import (
    LAYER1,
    LAYER2,
    LAYER3,
    MpaHeader,
    parse_header,
    try_parse_header,
)
from ..core.codecs import (
    CODEC_ID_MP1,
    CODEC_ID_MP2,
    CODEC_ID_MP3,
    AudioCodecParameters,
)
from ..core.audio import Channels
from ..core.errors import DecodeError, SeekError, Unsupported
from ..core.formats import (
    FormatOptions,
    FormatReader,
    PacketTable,
    SeekMode,
    SeekTo,
    SeekedTo,
    Track,
)
from ..core.meta import MetadataLog
from ..core.packet import Packet
from ..core.probe import Descriptor
from ..core.units import TimeBase

# Output delay of the Layer III synthesis chain (demuxer.rs:852: 528 + 1).
DECODER_DELAY = 529


def _compatible(a: MpaHeader, b: MpaHeader) -> bool:
    return (
        a.version == b.version
        and a.layer == b.layer
        and a.sample_rate == b.sample_rate
    )


class XingInfo:
    def __init__(self):
        self.num_frames: Optional[int] = None
        self.num_bytes: Optional[int] = None
        self.toc: Optional[bytes] = None
        self.is_cbr = False
        self.enc_delay = 0
        self.enc_padding = 0
        self.present = False


def parse_info_tag(frame: bytes, header: MpaHeader) -> XingInfo:
    """Xing/Info/LAME (demuxer.rs:735-927) and VBRI (:1000+) tags."""
    out = XingInfo()
    pos = 4 + header.side_info_len()
    tag = frame[pos : pos + 4]
    if tag in (b"Xing", b"Info"):
        out.present = True
        out.is_cbr = tag == b"Info"
        pos += 4
        flags = int.from_bytes(frame[pos : pos + 4], "big")
        pos += 4
        if flags & 0x1:
            out.num_frames = int.from_bytes(frame[pos : pos + 4], "big")
            pos += 4
        if flags & 0x2:
            out.num_bytes = int.from_bytes(frame[pos : pos + 4], "big")
            pos += 4
        if flags & 0x4:
            out.toc = frame[pos : pos + 100]
            pos += 100
        if flags & 0x8:
            pos += 4  # quality
        # LAME extension (first 24 bytes carry the delay/padding trim).
        if len(frame) - pos >= 24:
            encoder = frame[pos : pos + 9]
            trim = int.from_bytes(frame[pos + 21 : pos + 24], "big")
            if encoder[:4] in (b"LAME", b"Lavf", b"Lavc"):
                out.enc_delay = 528 + 1 + (trim >> 12)
                out.enc_padding = max(0, (trim & 0xFFF) - (528 + 1))
        return out
    # VBRI is located at a fixed 32-byte offset after the header.
    vpos = 4 + 32
    if frame[vpos : vpos + 4] == b"VBRI":
        out.present = True
        out.num_bytes = int.from_bytes(frame[vpos + 10 : vpos + 14], "big")
        out.num_frames = int.from_bytes(frame[vpos + 14 : vpos + 18], "big")
        return out
    return out


class MpaReader(FormatReader):
    """MPEG audio format reader (demuxer.rs:40)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
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

        # Find the first strictly-verified frame (demuxer.rs:585-656).
        first_off, first_hdr = self._find_first_frame(buf)
        self._buf = buf
        self._start = start

        # Probe the first frame for a Xing/Info/VBRI tag.
        info = parse_info_tag(buf[first_off : first_off + first_hdr.frame_size], first_hdr)
        audio_start = first_off + (first_hdr.frame_size if info.present else 0)

        # Walk the frame table.
        offsets: List[int] = []
        sizes: List[int] = []
        pos = audio_start
        n = len(buf)
        while pos + 4 <= n:
            hdr = try_parse_header(buf, pos)
            if hdr is None or not _compatible(hdr, first_hdr):
                # Lost sync: scan forward for the next verified frame.
                nxt = self._resync(buf, pos + 1, first_hdr)
                if nxt is None:
                    break
                pos = nxt
                continue
            if pos + hdr.frame_size > n:
                break  # truncated final frame
            offsets.append(pos)
            sizes.append(hdr.frame_size)
            pos += hdr.frame_size

        self.header = first_hdr
        spf = first_hdr.duration
        self._offsets = np.asarray(offsets, dtype=np.int64)
        self._sizes = np.asarray(sizes, dtype=np.int64)
        self._spf = spf
        self._cursor = 0

        delay = info.enc_delay if self.options.enable_gapless else 0
        padding = info.enc_padding if self.options.enable_gapless else 0
        total = len(offsets) * spf
        self._delay = delay
        self._padding = padding if delay + padding <= total else 0
        # A stream holding only the Xing/LAME tag frame has total == 0 with
        # a nonzero encoder delay; keep the playable count non-negative.
        self._total_out = max(0, total - self._delay - self._padding)

        codec = {LAYER1: CODEC_ID_MP1, LAYER2: CODEC_ID_MP2, LAYER3: CODEC_ID_MP3}[
            first_hdr.layer
        ]
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
            # Sanitized like the per-packet trims: an impossible
            # delay+padding > total (truncated stream vs its LAME tag)
            # zeroes the padding, so batch and packet paths agree.
            padding=self._padding,
        )

    # -- sync ------------------------------------------------------------

    @staticmethod
    def _find_first_frame(buf: bytes):
        off = MpaReader._resync(buf, 0, None)
        if off is None:
            raise Unsupported("no MPEG audio frames found")
        return off, try_parse_header(buf, off)

    @staticmethod
    def _resync(buf: bytes, start: int, ref: Optional[MpaHeader]) -> Optional[int]:
        """Scan for a header whose successor also parses (strict 2-header
        sync, demuxer.rs:610)."""
        a = np.frombuffer(buf, dtype=np.uint8)
        cand = np.nonzero((a[start:-1] == 0xFF) & (a[start + 1 :] & 0xE0 == 0xE0))[0]
        for c in cand:
            pos = start + int(c)
            hdr = try_parse_header(buf, pos)
            if hdr is None or (ref is not None and not _compatible(hdr, ref)):
                continue
            nxt = pos + hdr.frame_size
            if nxt + 4 <= len(buf):
                hdr2 = try_parse_header(buf, nxt)
                if hdr2 is None or not _compatible(hdr2, hdr):
                    continue
            return pos
        return None

    # -- FormatReader ------------------------------------------------------

    def tracks(self) -> List[Track]:
        return [self._track]

    def _packet_at(self, i: int) -> Packet:
        off = int(self._offsets[i])
        size = int(self._sizes[i])
        raw_ts = i * self._spf  # position before gapless trim
        trim_start = min(max(self._delay - raw_ts, 0), self._spf)
        end_limit = len(self._offsets) * self._spf - self._padding
        trim_end = min(max(raw_ts + self._spf - end_limit, 0), self._spf)
        ts = max(raw_ts - self._delay, 0)
        return Packet(
            track_id=0,
            ts=ts,
            dur=self._spf - trim_start - trim_end,
            data=self._buf[off : off + size],
            trim_start=trim_start,
            trim_end=trim_end,
        )

    def next_packet(self) -> Optional[Packet]:
        if self._cursor >= len(self._offsets):
            return None
        pkt = self._packet_at(self._cursor)
        self._cursor += 1
        return pkt

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = self._track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")
        raw = ts + self._delay
        i = max(0, min(len(self._offsets) - 1, raw // self._spf))
        # Accurate mode: the decoder needs preceding frames to refill the
        # bit reservoir; back up by up to 2 frames (demuxer.rs:233-404
        # walks forward decoding; callers discard pre-roll output).
        if mode == SeekMode.ACCURATE:
            i = max(0, i - 2)
        self._cursor = i
        actual = max(i * self._spf - self._delay, 0)
        return SeekedTo(track_id=0, required_ts=ts, actual_ts=actual)

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        n = len(self._offsets)
        pkts = [self._packet_at(i) for i in range(n)]
        return PacketTable(
            track_id=0,
            offsets=self._offsets + self._start,
            sizes=self._sizes.copy(),
            ts=np.asarray([p.ts for p in pkts], dtype=np.int64),
            dur=np.asarray([p.dur for p in pkts], dtype=np.int64),
            trim_start=np.asarray([p.trim_start for p in pkts], dtype=np.int32),
            trim_end=np.asarray([p.trim_end for p in pkts], dtype=np.int32),
            data=[p.data for p in pkts],
        )


def _score(context: bytes) -> int:
    """Probe score: require 4 consecutive consistent headers
    (MpaReader::score, demuxer.rs:51)."""
    hdr = try_parse_header(context, 0)
    if hdr is None:
        return 0
    pos = 0
    for _ in range(3):
        nxt = pos + try_parse_header(context, pos).frame_size
        if nxt + 4 > len(context):
            return 200  # ran out of context; plausible
        h2 = try_parse_header(context, nxt)
        if h2 is None or not _compatible(h2, hdr):
            return 0
        pos = nxt
    return 230  # strong, but below container formats embedding MPEG frames


# Markers: 0xFF followed by a byte with the top 3 sync bits + valid version/
# layer fields. Enumerate all valid second bytes (probe.rs marker model).
_MARKERS = []
for b1 in range(0xE0, 0x100):
    version_bits = (b1 >> 3) & 0x3
    layer_bits = (b1 >> 1) & 0x3
    if version_bits == 0b01 or layer_bits == 0b00:
        continue
    _MARKERS.append(bytes([0xFF, b1]))

class MpaStreamReader(FormatReader):
    """Streaming MPEG audio reader: one strictly-verified frame at a time
    over the MSS window (O(window) memory; demuxer.rs next_packet), for
    unseekable sources. Gapless delay trims apply at the head; the LAME
    padding is applied at EOF through a small hold-back queue."""

    RESYNC_WINDOW = 1 << 16

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        win = mss.peek_bytes(self.RESYNC_WINDOW)
        off, hdr = MpaReader._find_first_frame(win)
        mss.ignore_bytes(off)
        first = mss.peek_bytes(hdr.frame_size)
        info = parse_info_tag(first, hdr)
        if info.present:
            mss.ignore_bytes(hdr.frame_size)
        self.header = hdr
        self._spf = hdr.duration
        self._delay = info.enc_delay if self.options.enable_gapless else 0
        self._padding = info.enc_padding if self.options.enable_gapless else 0
        self._raw_ts = 0
        self._hold: List[Packet] = []
        self._eof = False
        codec = {LAYER1: CODEC_ID_MP1, LAYER2: CODEC_ID_MP2,
                 LAYER3: CODEC_ID_MP3}[hdr.layer]
        params = AudioCodecParameters(
            codec=codec,
            sample_rate=hdr.sample_rate,
            channels=Channels.from_count(hdr.n_channels),
            max_frames_per_packet=self._spf,
        )
        self._track = Track(id=0, codec_params=params,
                            time_base=TimeBase(1, hdr.sample_rate),
                            num_frames=None)

    def tracks(self) -> List[Track]:
        return [self._track]

    def _read_frame(self) -> Optional[Packet]:
        while True:
            head = self.mss.peek_bytes(4)
            if len(head) < 4:
                return None
            h = try_parse_header(head, 0)
            if h is None or not _compatible(h, self.header):
                win = self.mss.peek_bytes(self.RESYNC_WINDOW)
                nxt = MpaReader._resync(win, 1, self.header)
                if nxt is None:
                    skip = max(1, len(win) - 4)
                    if len(win) < 8:
                        return None
                    self.mss.ignore_bytes(skip)
                    continue
                self.mss.ignore_bytes(nxt)
                continue
            data = self.mss.peek_bytes(h.frame_size)
            if len(data) < h.frame_size:
                return None  # truncated final frame
            self.mss.ignore_bytes(h.frame_size)
            raw_ts = self._raw_ts
            self._raw_ts += self._spf
            trim_start = min(max(self._delay - raw_ts, 0), self._spf)
            return Packet(track_id=0, ts=max(raw_ts - self._delay, 0),
                          dur=self._spf - trim_start, data=data,
                          trim_start=trim_start)

    def next_packet(self) -> Optional[Packet]:
        # Hold back enough frames to absorb the trailing padding at EOF.
        hold = (self._padding + self._spf - 1) // self._spf if self._padding else 0
        while not self._eof and len(self._hold) <= hold:
            p = self._read_frame()
            if p is None:
                self._eof = True
                if self._padding and self._hold:
                    # Distribute the padding over the last frames.
                    trim = self._padding
                    for pkt in reversed(self._hold):
                        t = min(trim, pkt.dur)
                        pkt.trim_end += t
                        pkt.dur -= t
                        trim -= t
                        if trim <= 0:
                            break
                break
            self._hold.append(p)
        if not self._hold:
            return None
        return self._hold.pop(0)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        raise SeekError("source is not seekable")


def _make_mpa_reader(mss, options: Optional[FormatOptions] = None):
    if mss.is_seekable():
        return MpaReader(mss, options)
    return MpaStreamReader(mss, options)


DESCRIPTOR = Descriptor(
    name="mpa",
    markers=_MARKERS,
    factory=_make_mpa_reader,
    score=_score,
    tier=2,  # fallback tier: weak marker (common.rs:54 Tier semantics)
)
