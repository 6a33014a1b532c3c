"""WAV (RIFF WAVE) demuxer.

Analog of symphonia-format-riff/src/wave/mod.rs (``WavReader``, :331):
walks RIFF chunks (fmt/fact/data/LIST-INFO/ID3), builds the track from the
``fmt `` chunk, packetizes the ``data`` chunk block-aligned, and seeks by
O(1) byte math. Exposes a native O(1) ``packet_table`` for the batch path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.codecs import AudioCodecParameters
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
from ..core.meta import MetadataLog, MetadataRevision, RawTag
from ..core.packet import Packet
from ..core.probe import Descriptor
from ..core.units import TimeBase
from .riff_common import ChunksReader, FormatData, PacketInfo, parse_waveformat

WAV_MARKER = b"RIFF"
WAVE_ID = b"WAVE"


class WavReader(FormatReader):
    """RIFF/WAVE format reader (wave/mod.rs:331)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        hdr = mss.read_bytes(4)
        if hdr not in (WAV_MARKER, b"RF64"):
            raise Unsupported("missing RIFF marker")
        is_rf64 = hdr == b"RF64"
        riff_len = mss.read_u32le()
        if mss.read_bytes(4) != WAVE_ID:
            raise Unsupported("not a WAVE file")
        self._ds64_data_len = None
        self._ds64_frames = None

        self.fd: Optional[FormatData] = None
        self._data_start = None
        self._data_len = None
        self._fact_frames = None
        self._unbounded = False

        chunks = ChunksReader(mss, riff_len - 4 if riff_len >= 4 else None)
        while True:
            ch = chunks.next_chunk()
            if ch is None:
                break
            if ch.id == b"ds64":
                # RF64 64-bit size chunk: riff size, data size, sample count.
                payload = mss.read_bytes(ch.size)
                if len(payload) >= 24:
                    self._ds64_data_len = int.from_bytes(payload[8:16], "little")
                    self._ds64_frames = int.from_bytes(payload[16:24], "little")
                chunks.consume(ch.size)
                chunks.align(ch)
            elif ch.id == b"fmt ":
                self.fd = parse_waveformat(mss.read_bytes(ch.size))
                chunks.consume(ch.size)
                chunks.align(ch)
            elif ch.id == b"fact" and ch.size >= 4:
                self._fact_frames = mss.read_u32le()
                if ch.size > 4:
                    mss.ignore_bytes(ch.size - 4)
                chunks.consume(ch.size)
                chunks.align(ch)
            elif ch.id in (b"id3 ", b"ID3 "):
                payload = mss.read_bytes(ch.size)
                chunks.consume(ch.size)
                chunks.align(ch)
                try:
                    from ..metadata.id3v2 import Id3v2Reader
                    from ..core.io.media_source import BufReader

                    rev2 = Id3v2Reader().read_all(BufReader(payload))
                    if rev2 is not None:
                        self._metadata.push(rev2)
                except Exception:
                    pass
            elif ch.id == b"LIST" and ch.size >= 4:
                list_type = mss.read_bytes(4)
                if list_type == b"INFO":
                    self._read_info(ch.size - 4)
                else:
                    mss.ignore_bytes(ch.size - 4)
                chunks.consume(ch.size)
                chunks.align(ch)
            elif ch.id == b"data":
                self._data_start = mss.pos()
                size = ch.size
                if size == 0xFFFFFFFF and self._ds64_data_len is not None:
                    size = self._ds64_data_len  # RF64 64-bit data size
                # A streaming WAV may declare 0xFFFFFFFF / 0; fall back to
                # the physical remainder when seekable, or stream to EOF
                # on a pipe (the declared length is untrustworthy there).
                total = mss.byte_len()
                if total is not None:
                    size = min(size, total - self._data_start) if size else total - self._data_start
                elif size in (0, 0xFFFFFFFF):
                    size = 1 << 62
                    self._unbounded = True
                self._data_len = size
                break  # data is last parsed chunk; audio follows
            else:
                chunks.skip_chunk(ch)

        if self.fd is None or self._data_start is None:
            raise DecodeError("missing fmt or data chunk")

        self.pinfo = PacketInfo.for_format(self.fd)
        n_blocks = self._data_len // self.fd.block_align
        self._total_frames = n_blocks * self.fd.frames_per_block
        if self._fact_frames is None:
            self._fact_frames = self._ds64_frames
        if self._fact_frames is not None:
            self._total_frames = min(self._total_frames, self._fact_frames)
        self._next_block = 0
        self._n_blocks = n_blocks

        params = AudioCodecParameters(
            codec=self.fd.codec,
            sample_rate=self.fd.sample_rate,
            bits_per_sample=self.fd.bits_per_sample,
            bits_per_coded_sample=self.fd.bits_per_coded_sample,
            channels=self.fd.channels,
            max_frames_per_packet=self.pinfo.packet_frames,
            frames_per_block=self.fd.frames_per_block,
            block_align=self.fd.block_align,
        )
        self._track = Track(
            id=0,
            codec_params=params,
            time_base=TimeBase(1, self.fd.sample_rate),
            num_frames=None if self._unbounded else self._total_frames,
        )

    # -- metadata ----------------------------------------------------------

    def _read_info(self, size: int) -> None:
        """RIFF LIST INFO sub-chunks -> tags (embedded/riff.rs; key map +
        value parsers in metadata/std_tag.py RIFF_MAP)."""
        from ..metadata.std_tag import RIFF_MAP, map_raw

        rev = MetadataRevision()
        end = self.mss.pos() + size
        while self.mss.pos() + 8 <= end:
            cid = self.mss.read_bytes(4)
            clen = self.mss.read_u32le()
            payload = self.mss.read_bytes(min(clen, end - self.mss.pos()))
            if clen & 1 and self.mss.pos() < end:
                self.mss.ignore_bytes(1)
            text = payload.split(b"\x00")[0].decode("latin-1", "replace")
            rev.tags.extend(map_raw(cid.decode("latin-1"), text, RIFF_MAP))
        if rev.tags:
            self._metadata.push(rev)

    # -- FormatReader ------------------------------------------------------

    def tracks(self) -> List[Track]:
        return [self._track]

    def next_packet(self) -> Optional[Packet]:
        if self._next_block >= self._n_blocks:
            return None
        blocks = min(self.pinfo.blocks_per_packet, self._n_blocks - self._next_block)
        nbytes = blocks * self.pinfo.block_size
        pos = self._data_start + self._next_block * self.pinfo.block_size
        if self.mss.pos() != pos:
            self.mss.seek(pos)
        data = self.mss.read_upto(nbytes)
        ts = self._next_block * self.pinfo.frames_per_block
        if len(data) < nbytes:
            # Truncated stream (e.g. a pipe whose data-chunk size lied):
            # deliver what arrived and end the stream; the PCM/ADPCM
            # decoders clip partial trailing blocks themselves.
            self._next_block = self._n_blocks
            if not data:
                return None
            got = -(-len(data) // self.pinfo.block_size)
            return Packet(track_id=0, ts=ts,
                          dur=got * self.pinfo.frames_per_block, data=data)
        dur = blocks * self.pinfo.frames_per_block
        self._next_block += blocks
        return Packet(track_id=0, ts=ts, dur=dur, data=data)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = self._track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")
        ts = max(0, min(ts, self._total_frames))
        block = ts // self.pinfo.frames_per_block
        self._next_block = block
        actual = block * self.pinfo.frames_per_block
        self.mss.seek(self._data_start + block * self.pinfo.block_size)
        return SeekedTo(track_id=0, required_ts=ts, actual_ts=actual)

    # -- batch-native ------------------------------------------------------

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        """O(1) table from byte math (no packet loop)."""
        if self._unbounded:
            raise Unsupported("packet_table requires a bounded data chunk")
        bpp = self.pinfo.blocks_per_packet
        n_pkts = (self._n_blocks + bpp - 1) // bpp
        idx = np.arange(n_pkts, dtype=np.int64)
        blocks = np.minimum(bpp, self._n_blocks - idx * bpp)
        return PacketTable(
            track_id=0,
            offsets=self._data_start + idx * bpp * self.pinfo.block_size,
            sizes=blocks * self.pinfo.block_size,
            ts=idx * bpp * self.pinfo.frames_per_block,
            dur=blocks * self.pinfo.frames_per_block,
            trim_start=np.zeros(n_pkts, dtype=np.int32),
            trim_end=np.zeros(n_pkts, dtype=np.int32),
        )


def _score(context: bytes) -> int:
    if len(context) >= 12 and context[8:12] == WAVE_ID:
        return 255
    return 0


DESCRIPTOR = Descriptor(
    name="wav",
    markers=[WAV_MARKER, b"RF64"],
    factory=WavReader,
    score=_score,
)
