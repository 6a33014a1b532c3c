"""AIFF / AIFF-C demuxer.

Analog of symphonia-format-riff/src/aiff/ (``AiffReader``, aiff/mod.rs:475):
IFF big-endian chunk walk (COMM/SSND + NAME/AUTH/ANNO/(c) text chunks,
aiff/chunks.rs), including AIFC compression types (NONE/twos/sowt/fl32/fl64/
alaw/ulaw/ima4), block-aligned packetization and O(1) byte-math seek.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core import codecs as ccodec
from ..core.audio import Channels
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
from .riff_common import ChunksReader, FormatData, PacketInfo

FORM_MARKER = b"FORM"


def parse_extended_f80(data: bytes) -> float:
    """80-bit IEEE 754 extended float (the COMM sample rate field)."""
    if len(data) != 10:
        raise DecodeError("bad extended float")
    sign_exp = int.from_bytes(data[:2], "big")
    mantissa = int.from_bytes(data[2:], "big")
    exp = sign_exp & 0x7FFF
    sign = -1.0 if sign_exp & 0x8000 else 1.0
    if exp == 0 and mantissa == 0:
        return 0.0
    e = exp - 16383 - 63
    # A crafted exponent must not overflow the f64 pow (Python raises
    # OverflowError from 2.0**e past +-1024): values outside the f64
    # range are never valid sample rates.
    if e > 959:  # float(mantissa) can round up to 2^64; 64+e must stay
        raise DecodeError("bad extended float")  # below 2^1024

    if e < -1140:
        return 0.0
    return sign * mantissa * 2.0 ** e


_TEXT_CHUNKS = {
    b"NAME": "track_title",
    b"AUTH": "artist",
    b"(c) ": "copyright",
    b"ANNO": "comment",
}


class AiffReader(FormatReader):
    """AIFF/AIFF-C format reader (aiff/mod.rs:475)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        if mss.read_bytes(4) != FORM_MARKER:
            raise Unsupported("missing FORM marker")
        form_len = mss.read_u32be()
        form_type = mss.read_bytes(4)
        if form_type not in (b"AIFF", b"AIFC"):
            raise Unsupported("not an AIFF form")
        is_aifc = form_type == b"AIFC"

        self.fd: Optional[FormatData] = None
        self._n_frames = None
        self._data_start = None
        self._data_len = None
        rev = MetadataRevision()
        mark_payload = comt_payload = None

        chunks = ChunksReader(mss, form_len - 4, big_endian=True)
        while True:
            ch = chunks.next_chunk()
            if ch is None:
                break
            if ch.id == b"COMM":
                payload = mss.read_bytes(ch.size)
                chunks.consume(ch.size)
                chunks.align(ch)
                self._parse_comm(payload, is_aifc)
            elif ch.id == b"SSND":
                if ch.size < 8:
                    chunks.skip_chunk(ch)
                    continue
                offset = mss.read_u32be()
                _blk = mss.read_u32be()
                # The alignment offset is attacker-controlled: bound it by
                # the chunk body so a crafted value cannot drive a negative
                # data length (or a silent seek past EOF on seekable
                # sources — ignore_bytes does not validate the target).
                offset = min(offset, ch.size - 8)
                mss.ignore_bytes(offset)
                self._data_start = mss.pos()
                data_len = ch.size - 8 - offset
                total = mss.byte_len()
                if total is not None:
                    data_len = min(data_len, max(0, total - self._data_start))
                self._data_len = data_len
                break  # audio data; stop walking
            elif ch.id == b"ID3 ":
                payload = mss.read_bytes(ch.size)
                chunks.consume(ch.size)
                chunks.align(ch)
                try:
                    from ..core.io.media_source import BufReader
                    from ..metadata.id3v2 import Id3v2Reader

                    rev2 = Id3v2Reader().read_all(BufReader(payload))
                    if rev2 is not None and rev2.tags:
                        rev.tags.extend(rev2.tags)
                        rev.visuals.extend(rev2.visuals)
                except Exception:
                    pass
            elif ch.id in _TEXT_CHUNKS:
                text = mss.read_bytes(ch.size).decode("ascii", "replace").rstrip("\x00")
                chunks.consume(ch.size)
                chunks.align(ch)
                rev.tags.append(RawTag(ch.id.decode(), text, _TEXT_CHUNKS[ch.id]))
            elif ch.id in (b"MARK", b"COMT"):
                payload = mss.read_bytes(ch.size)
                chunks.consume(ch.size)
                chunks.align(ch)
                if ch.id == b"MARK":
                    mark_payload = payload
                else:
                    comt_payload = payload
            else:
                chunks.skip_chunk(ch)

        if self.fd is None or self._data_start is None:
            raise DecodeError("missing COMM or SSND chunk")
        self._process_markers(mark_payload, comt_payload, rev)
        if rev.tags:
            self._metadata.push(rev)

        self.pinfo = PacketInfo.for_format(self.fd)
        n_blocks = self._data_len // self.fd.block_align
        total = min(
            n_blocks * self.fd.frames_per_block,
            self._n_frames if self._n_frames else float("inf"),
        )
        self._n_blocks = n_blocks
        self._total_frames = int(total)
        self._next_block = 0

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
            num_frames=self._total_frames,
        )

    def _process_markers(self, mark: Optional[bytes], comt: Optional[bytes],
                         rev: MetadataRevision) -> None:
        """MARK markers -> chapters; COMT comments attach to their marker's
        chapter or become general tags (aiff/mod.rs:244-317,
        aiff/chunks.rs:339-430). Malformed chunks are ignored."""
        from ..core.meta import Chapter, ChapterGroup

        chapters = []
        index = {}  # marker id -> chapter position
        rate = self.fd.sample_rate
        if mark:
            try:
                n = int.from_bytes(mark[0:2], "big")
                pos = 2
                for _ in range(n):
                    mid = int.from_bytes(mark[pos:pos + 2], "big", signed=True)
                    ts = int.from_bytes(mark[pos + 2:pos + 6], "big")
                    slen = mark[pos + 6]
                    name = mark[pos + 7:pos + 7 + slen].decode("ascii",
                                                               "replace")
                    # Pascal string padded so length byte + text is even.
                    pos += 7 + slen + (0 if (slen + 1) % 2 == 0 else 1)
                    if mid > 0 and mid not in index:
                        index[mid] = len(chapters)
                    ch = Chapter(start_time=ts / rate, title=name or None)
                    ch.tags.append(RawTag("NAME", name))
                    chapters.append(ch)
            except (IndexError, ValueError):
                chapters, index = [], {}
        if comt:
            try:
                n = int.from_bytes(comt[0:2], "big")
                pos = 2
                for _ in range(n):
                    mid = int.from_bytes(comt[pos + 4:pos + 6], "big",
                                         signed=True)
                    tlen = int.from_bytes(comt[pos + 6:pos + 8], "big")
                    text = comt[pos + 8:pos + 8 + tlen].decode("ascii",
                                                               "replace")
                    if len(comt) < pos + 8 + tlen:
                        break
                    pos += 8 + tlen
                    tag = RawTag("COMMENT", text, "comment")
                    if mid == 0:
                        rev.tags.append(tag)
                    elif mid in index:
                        chapters[index[mid]].tags.append(tag)
            except (IndexError, ValueError):
                pass
        if chapters:
            self._chapters = ChapterGroup(items=chapters)

    def _parse_comm(self, payload: bytes, is_aifc: bool) -> None:
        if len(payload) < 18:
            raise DecodeError("COMM chunk too small")
        n_ch, n_frames, bits = struct.unpack(">HIH", payload[:8])
        rate = int(round(parse_extended_f80(payload[8:18])))
        if n_ch == 0 or rate <= 0:
            raise DecodeError("invalid COMM parameters")
        self._n_frames = n_frames
        channels = Channels.from_count(n_ch)
        compression = payload[18:22] if is_aifc and len(payload) >= 22 else b"NONE"

        c = ccodec
        container = ((bits + 7) // 8) * 8
        if compression in (b"NONE", b"none", b"twos", b"TWOS"):
            codec = {8: c.CODEC_ID_PCM_S8, 16: c.CODEC_ID_PCM_S16BE,
                     24: c.CODEC_ID_PCM_S24BE, 32: c.CODEC_ID_PCM_S32BE}.get(container)
            if codec is None:
                raise DecodeError(f"unsupported AIFF bit depth {bits}")
            if compression in (b"twos", b"TWOS") and container != 16:
                # twos is strictly 16-bit in the reference (chunks.rs:153).
                raise DecodeError("AIFC twos requires 16-bit samples")
            block = n_ch * container // 8
            fpb = 1
            out_bits = container
        elif compression in (b"sowt", b"SOWT"):
            if container != 16:
                raise DecodeError("AIFC sowt requires 16-bit samples")
            codec = c.CODEC_ID_PCM_S16LE
            block = n_ch * 2
            fpb = 1
            out_bits = 16
        elif compression in (b"in24", b"IN24"):
            if bits != 24:
                raise DecodeError("AIFC in24 requires 24-bit samples")
            codec = c.CODEC_ID_PCM_S24BE
            block = n_ch * 3
            fpb = 1
            out_bits = 24
        elif compression in (b"in32", b"IN32"):
            if bits != 32:
                raise DecodeError("AIFC in32 requires 32-bit samples")
            codec = c.CODEC_ID_PCM_S32BE
            block = n_ch * 4
            fpb = 1
            out_bits = 32
        elif compression in (b"23ni", b"23NI"):
            # 32-bit little-endian integer (chunks.rs:107-118).
            if bits != 32:
                raise DecodeError("AIFC 23ni requires 32-bit samples")
            codec = c.CODEC_ID_PCM_S32LE
            block = n_ch * 4
            fpb = 1
            out_bits = 32
        elif compression in (b"raw ", b"RAW "):
            if bits != 8:
                raise DecodeError("AIFC raw requires 8-bit samples")
            codec = c.CODEC_ID_PCM_U8
            block = n_ch
            fpb = 1
            out_bits = 8
        elif compression in (b"fl32", b"FL32"):
            codec = c.CODEC_ID_PCM_F32BE
            block = n_ch * 4
            fpb = 1
            out_bits = 32
        elif compression in (b"fl64", b"FL64"):
            codec = c.CODEC_ID_PCM_F64BE
            block = n_ch * 8
            fpb = 1
            out_bits = 64
        elif compression in (b"alaw", b"ALAW"):
            codec = c.CODEC_ID_PCM_ALAW
            block = n_ch
            fpb = 1
            out_bits = 16
        elif compression in (b"ulaw", b"ULAW"):
            codec = c.CODEC_ID_PCM_MULAW
            block = n_ch
            fpb = 1
            out_bits = 16
        elif compression == b"ima4":
            codec = c.CODEC_ID_ADPCM_IMA_QT
            block = 34 * n_ch
            fpb = 64
            out_bits = 16
        else:
            raise Unsupported(f"AIFC compression {compression!r}")
        self.fd = FormatData(codec, out_bits, bits, channels, rate, block, fpb)

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
            # Truncated stream (a pipe whose SSND size lied): deliver the
            # data that arrived and end the stream.
            self._next_block = self._n_blocks
            if not data:
                return None
            got = -(-len(data) // self.pinfo.block_size)
            return Packet(track_id=0, ts=ts,
                          dur=got * self.pinfo.frames_per_block, data=data)
        self._next_block += blocks
        return Packet(track_id=0, ts=ts, dur=blocks * self.pinfo.frames_per_block, data=data)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = self._track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")
        block = max(0, min(ts // self.pinfo.frames_per_block, self._n_blocks))
        self._next_block = block
        return SeekedTo(0, ts, block * self.pinfo.frames_per_block)

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
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
    if len(context) >= 12 and context[8:12] in (b"AIFF", b"AIFC"):
        return 255
    return 0


DESCRIPTOR = Descriptor(
    name="aiff",
    markers=[FORM_MARKER],
    factory=AiffReader,
    score=_score,
)
