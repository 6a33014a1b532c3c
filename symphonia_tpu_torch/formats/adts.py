"""ADTS (AAC elementary stream) demuxer.

Analog of symphonia-codec-aac/src/adts.rs (``AdtsReader``, adts.rs:39):
0xFFF sync + fixed/variable header parse (adts.rs:129-249), fixed
1024-sample packets, seek by packet index (adts.rs:283+).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..common.mpeg import SAMPLE_RATES, AudioSpecificConfig
from ..core.audio import Channels
from ..core.codecs import CODEC_ID_AAC, AudioCodecParameters
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

SAMPLES_PER_FRAME = 1024


def parse_adts_header(buf: bytes, pos: int) -> Optional[Tuple[int, int, int, int, int]]:
    """Returns (frame_len, header_len, profile, sr_idx, channels) or None."""
    if pos + 7 > len(buf):
        return None
    b = buf[pos : pos + 7]
    if b[0] != 0xFF or (b[1] & 0xF6) != 0xF0:
        return None  # sync + layer==0
    protection_absent = b[1] & 0x1
    profile = (b[2] >> 6) & 0x3
    sr_idx = (b[2] >> 2) & 0xF
    if sr_idx >= 13:
        return None
    channels = ((b[2] & 0x1) << 2) | (b[3] >> 6)
    frame_len = ((b[3] & 0x03) << 11) | (b[4] << 3) | (b[5] >> 5)
    header_len = 7 if protection_absent else 9
    if frame_len < header_len:
        return None
    return frame_len, header_len, profile, sr_idx, channels


class AdtsReader(FormatReader):
    """ADTS format reader (adts.rs:39)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        start = mss.pos()
        chunks = []
        while True:
            b = mss.read_upto(1 << 22)
            if not b:
                break
            chunks.append(b)
        buf = b"".join(chunks)

        first = None
        pos = 0
        a = np.frombuffer(buf, dtype=np.uint8)
        # Precomputed sync candidates: re-running nonzero over the remaining
        # buffer per candidate is quadratic on 0xFF-rich garbage.
        sync = np.nonzero(a == 0xFF)[0]
        while pos + 7 <= len(buf):
            hdr = parse_adts_header(buf, pos)
            if hdr is not None:
                # Verify the next frame too (sync confirmation).
                nxt = pos + hdr[0]
                if nxt + 7 > len(buf) or parse_adts_header(buf, nxt) is not None:
                    first = hdr
                    break
            j = int(np.searchsorted(sync, pos + 1))
            if j >= len(sync):
                break
            pos = int(sync[j])
        if first is None:
            raise Unsupported("no ADTS frames found")

        frame_len, header_len, profile, sr_idx, channels = first
        rate = SAMPLE_RATES[sr_idx]
        if channels == 0:
            raise Unsupported("ADTS PCE channel config")

        offsets, sizes, hdr_lens = [], [], []
        expected = pos  # in-sync predictor: end of the last accepted frame
        while pos + 7 <= len(buf):
            hdr = parse_adts_header(buf, pos)
            ok = hdr is not None
            if ok and pos != expected:
                # Re-synced position: random bytes form plausible headers,
                # so require the successor to parse too (or run off the
                # buffer) before trusting this one — a fake frame_len would
                # otherwise skip past real frames.
                nxt = pos + hdr[0]
                ok = nxt + 7 > len(buf) or parse_adts_header(buf, nxt) is not None
            if not ok:
                j = int(np.searchsorted(sync, pos + 1))
                if j >= len(sync):
                    break
                pos = int(sync[j])
                continue
            fl, hl = hdr[0], hdr[1]
            if pos + fl > len(buf):
                break
            offsets.append(pos + hl)
            sizes.append(fl - hl)
            pos += fl
            expected = pos
        self._buf = buf
        self._start = start
        self._offsets = np.asarray(offsets, dtype=np.int64)
        self._sizes = np.asarray(sizes, dtype=np.int64)
        self._cursor = 0

        asc = AudioSpecificConfig.build(profile + 1, rate, channels)
        # `channels` is the raw ADTS channel-configuration index, not a
        # count: config 7 means 8 channels, and configs 4/7 carry
        # non-default speaker layouts (mpeg/audio/mod.rs:201-213).
        from ..common.mpeg import channels_for_config

        params = AudioCodecParameters(
            codec=CODEC_ID_AAC,
            sample_rate=rate,
            channels=channels_for_config(channels)
            or Channels.from_count(channels),
            max_frames_per_packet=SAMPLES_PER_FRAME,
            extra_data=asc,
        )
        self._track = Track(
            id=0,
            codec_params=params,
            time_base=TimeBase(1, rate),
            num_frames=len(offsets) * SAMPLES_PER_FRAME,
        )

    def tracks(self) -> List[Track]:
        return [self._track]

    def next_packet(self) -> Optional[Packet]:
        if self._cursor >= len(self._offsets):
            return None
        i = self._cursor
        self._cursor += 1
        off, size = int(self._offsets[i]), int(self._sizes[i])
        return Packet(track_id=0, ts=i * SAMPLES_PER_FRAME,
                      dur=SAMPLES_PER_FRAME, data=self._buf[off : off + size])

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = self._track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")
        i = max(0, min(len(self._offsets) - 1, ts // SAMPLES_PER_FRAME))
        self._cursor = int(i)
        return SeekedTo(0, ts, int(i) * SAMPLES_PER_FRAME)

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        n = len(self._offsets)
        idx = np.arange(n, dtype=np.int64)
        return PacketTable(
            track_id=0,
            offsets=self._offsets + self._start,
            sizes=self._sizes.copy(),
            ts=idx * SAMPLES_PER_FRAME,
            dur=np.full(n, SAMPLES_PER_FRAME, dtype=np.int64),
            trim_start=np.zeros(n, dtype=np.int32),
            trim_end=np.zeros(n, dtype=np.int32),
            data=[self._buf[int(o) : int(o + s)]
                  for o, s in zip(self._offsets, self._sizes)],
        )


def _score(context: bytes) -> int:
    hdr = parse_adts_header(context, 0)
    if hdr is None:
        return 0
    # Require a consistent successor header.
    nxt = hdr[0]
    h2 = parse_adts_header(context, nxt)
    if h2 is None and nxt + 7 <= len(context):
        return 0
    return 235


_MARKERS = []
for b1 in (0xF0, 0xF1, 0xF8, 0xF9):
    _MARKERS.append(bytes([0xFF, b1]))

DESCRIPTOR = Descriptor(
    name="adts",
    markers=_MARKERS,
    factory=AdtsReader,
    score=_score,
    tier=2,
)
