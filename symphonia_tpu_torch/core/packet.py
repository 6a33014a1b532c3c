"""Demuxed packet of codec bitstream data.

Mirrors symphonia-core/src/packet.rs:50: a packet carries one-or-more frames
of compressed data for a single track, with timing and gapless-trim metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(slots=True)
class Packet:
    """A single packet of codec data (packet.rs:50-76).

    Attributes:
        track_id: id of the track this packet belongs to.
        ts: presentation timestamp in TimeBase ticks of the *first* frame.
        dur: duration in ticks.
        data: the raw codec bitstream bytes.
        trim_start: frames to discard from the decoded start (gapless delay).
        trim_end: frames to discard from the decoded end (gapless padding).
        keyframe: True when the packet can be decoded without reference to
            earlier packets. Derives from the container's sync tables
            (MP4 stss / trun sample flags, MKV SimpleBlock keyframe bit or
            BlockGroup-without-ReferenceBlock — lacing.rs keyframe
            handling, atoms/stss.rs); defaults True when the container
            carries no sync info, which is the normal case for audio.
    """

    track_id: int
    ts: int
    dur: int
    data: bytes
    trim_start: int = 0
    trim_end: int = 0
    keyframe: bool = True

    def pts(self) -> int:
        return self.ts

    def duration(self) -> int:
        return self.dur

    def buf(self) -> bytes:
        return self.data

    def block_dur(self) -> int:
        """Duration including trimmed frames (packet.rs block_dur)."""
        return self.dur + self.trim_start + self.trim_end
