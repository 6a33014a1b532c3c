"""Container (demux) contracts: tracks, format readers, seeking.

Analog of symphonia-core/src/formats/mod.rs:

* ``Track`` — formats/mod.rs:234 (id, codec params, timebase, frame counts,
  gapless delay/padding).
* ``FormatReader`` — formats/mod.rs:551-652 (next_packet / seek / tracks /
  metadata / chapters).
* ``SeekIndex`` — formats/mod.rs:687-795 (sorted seek points, binary search).
* ``FormatOptions`` — formats/mod.rs:123-156.

The batch-native extension: ``packet_table()`` returns the *whole* packet
layout of a track in one shot (offsets/sizes/timestamps as numpy arrays) so
the TPU pipeline can gather and pack thousands of frames without a
pull-loop. The default derivation walks ``next_packet`` once and caches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .codecs import AudioCodecParameters
from .errors import EndOfStream, SeekError, Unsupported
from .packet import Packet
from .units import Time, TimeBase


class TrackFlags:
    """Track attribute bitflags (formats/mod.rs:197-216)."""

    DEFAULT = 1 << 0
    FORCED = 1 << 1
    ORIGINAL_LANGUAGE = 1 << 2
    COMMENTARY = 1 << 3
    HEARING_IMPAIRED = 1 << 4
    VISUALLY_IMPAIRED = 1 << 5
    TEXT_DESCRIPTIONS = 1 << 6


@dataclass
class Track:
    """A single media track (formats/mod.rs:234)."""

    id: int
    codec_params: Optional[AudioCodecParameters]
    time_base: Optional[TimeBase] = None
    num_frames: Optional[int] = None  # playable frames (excl. delay/padding)
    duration: Optional[int] = None  # container-declared length, timebase ticks
    start_ts: int = 0
    delay: int = 0  # gapless leading frames to trim (formats/mod.rs:269)
    padding: int = 0  # gapless trailing frames to trim
    language: Optional[str] = None
    flags: int = 0  # TrackFlags bits


@dataclass
class ExternalFormatData:
    """Side-channel data handed to a reader at open (formats/mod.rs:145-156):
    metadata read before the container started (e.g. leading ID3v2 consumed
    by the probe) and/or externally sourced chapters. Readers surface the
    metadata revisions *first* in their log and use the chapters only when
    the container itself carries none."""

    metadata: Optional[object] = None  # MetadataLog
    chapters: Optional[object] = None  # ChapterGroup


@dataclass
class FormatOptions:
    """Demuxer options (formats/mod.rs:123-156).

    prebuild_seek_index / seek_index_fill_rate exist for reference API
    parity but are subsumed by this architecture: every reader a seekable
    source gets materializes an exact per-frame/packet table at open (the
    batch decode path needs it anyway), which is strictly stronger than
    the reference's sparse prebuilt index, and the streaming readers are
    only constructed for unseekable sources, where prebuilding is
    impossible (they seek by bisection/cues/forward-scan when asked).
    """

    prebuild_seek_index: bool = False
    seek_index_fill_rate: int = 20  # seconds between seek points
    enable_gapless: bool = True
    external_data: ExternalFormatData = field(default_factory=ExternalFormatData)


class SeekMode:
    COARSE = "coarse"
    ACCURATE = "accurate"


@dataclass
class SeekTo:
    """Seek target: a Time or a timestamp in track ticks."""

    time: Optional[Time] = None
    ts: Optional[int] = None
    track_id: Optional[int] = None


@dataclass
class SeekedTo:
    track_id: int
    required_ts: int
    actual_ts: int


@dataclass(order=True)
class SeekPoint:
    """A (timestamp, byte offset, frames) seek anchor (formats/mod.rs:687)."""

    ts: int
    byte_offset: int
    num_frames: int = 0


class SeekIndex:
    """Sorted seek point index with binary search (formats/mod.rs:687-795).

    A parallel ``_keys`` list mirrors ``_points[i].ts`` so both ``insert``
    and ``search`` bisect an existing sorted list — no per-call key-list
    rebuild (appends are amortized O(1), out-of-order inserts O(n) for the
    list shift only, searches O(log n)).
    """

    def __init__(self):
        self._points: List[SeekPoint] = []
        self._keys: List[int] = []

    def insert(self, ts: int, byte_offset: int, num_frames: int = 0) -> None:
        pt = SeekPoint(ts, byte_offset, num_frames)
        # Keep sorted; most inserts are appends.
        if not self._points or ts > self._keys[-1]:
            self._points.append(pt)
            self._keys.append(ts)
            return
        import bisect

        i = bisect.bisect_left(self._keys, ts)
        if i < len(self._keys) and self._keys[i] == ts:
            return
        self._points.insert(i, pt)
        self._keys.insert(i, ts)

    def search(self, ts: int) -> Tuple[Optional[SeekPoint], Optional[SeekPoint]]:
        """Return (lower, upper) seek points bracketing ts."""
        import bisect

        i = bisect.bisect_right(self._keys, ts)
        lower = self._points[i - 1] if i > 0 else None
        upper = self._points[i] if i < len(self._points) else None
        return lower, upper

    def is_empty(self) -> bool:
        return not self._points

    def __len__(self) -> int:
        return len(self._points)


@dataclass
class PacketTable:
    """Batch-native packet layout for one track.

    Column arrays describing every packet: absolute byte ``offsets`` and
    ``sizes`` into the source, ``ts``/``dur`` in track ticks, and gapless
    ``trim_start``/``trim_end``. This is what the TPU batch pipeline packs
    into padded tensors (SURVEY.md §7 Phase A).
    """

    track_id: int
    offsets: np.ndarray  # int64 [N] (absolute in source; -1 if data inline)
    sizes: np.ndarray  # int64 [N]
    ts: np.ndarray  # int64 [N]
    dur: np.ndarray  # int64 [N]
    trim_start: np.ndarray  # int32 [N]
    trim_end: np.ndarray  # int32 [N]
    data: Optional[List[bytes]] = None  # inline payloads when offsets == -1

    def __len__(self) -> int:
        return len(self.offsets)


class FormatReader:
    """Demuxer contract (formats/mod.rs:551-652)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        self.mss = mss
        self.options = options or FormatOptions()

    # -- required ----------------------------------------------------------

    def tracks(self) -> List[Track]:
        raise NotImplementedError

    def other_tracks(self) -> List[Track]:
        """Non-audio (video/subtitle) track descriptions, when the container
        carries any. Their ``codec_params`` are the experimental
        VideoCodecParameters / SubtitleCodecParameters (core/video.py,
        core/subtitle.py — reference exp-video/-subtitle surface); no
        decoders ship for them, matching the reference."""
        return []

    def next_packet(self) -> Optional[Packet]:
        """Return the next packet, or None at end of stream
        (formats/mod.rs:646; None replaces the reference's EOF error)."""
        raise NotImplementedError

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        raise SeekError(SeekError.UNSEEKABLE)

    # -- optional ----------------------------------------------------------

    def metadata(self):
        """Current MetadataLog (may be empty). Revisions provided through
        ``FormatOptions.external_data`` come first, the container's own
        after (formats/mod.rs:148-153 — external revisions seed the log)."""
        from .meta import MetadataLog

        own = getattr(self, "_metadata", None)
        ext = getattr(getattr(self, "options", None), "external_data", None)
        ext_log = ext.metadata if ext is not None else None
        if ext_log is None or ext_log.is_empty():
            return own or MetadataLog()
        merged = MetadataLog()
        for rev in ext_log:
            merged.push(rev)
        if own is not None:
            for rev in own:
                merged.push(rev)
        return merged

    def chapters(self):
        own = getattr(self, "_chapters", None)
        if own is not None:
            return own
        ext = getattr(getattr(self, "options", None), "external_data", None)
        return ext.chapters if ext is not None else None

    def attachments(self):
        return getattr(self, "_attachments", []) or []

    def default_track(self) -> Optional[Track]:
        """The DEFAULT-flagged track if any, else the first
        (formats/mod.rs:630-637)."""
        t = self.tracks()
        for tr in t:
            if tr.flags & TrackFlags.DEFAULT:
                return tr
        return t[0] if t else None

    def into_inner(self):
        return self.mss

    # -- batch-native ------------------------------------------------------

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        """Whole-stream packet layout for the batch pipeline.

        Default implementation drains ``next_packet`` (readers with native
        tables — MP4 stts/stsc, CAF pakt, WAV byte math — override this
        with O(1)/O(table) versions).
        """
        if track_id is None:
            track = self.default_track()
            if track is None:
                raise Unsupported("no audio tracks to build a packet table for")
            track_id = track.id
        offs, sizes, ts, dur, t0, t1, payloads = [], [], [], [], [], [], []
        while True:
            pkt = self.next_packet()
            if pkt is None:
                break
            if pkt.track_id != track_id:
                continue
            offs.append(-1)
            sizes.append(len(pkt.data))
            ts.append(pkt.ts)
            dur.append(pkt.dur)
            t0.append(pkt.trim_start)
            t1.append(pkt.trim_end)
            payloads.append(pkt.data)
        return PacketTable(
            track_id=track_id,
            offsets=np.asarray(offs, dtype=np.int64),
            sizes=np.asarray(sizes, dtype=np.int64),
            ts=np.asarray(ts, dtype=np.int64),
            dur=np.asarray(dur, dtype=np.int64),
            trim_start=np.asarray(t0, dtype=np.int32),
            trim_end=np.asarray(t1, dtype=np.int32),
            data=payloads,
        )
