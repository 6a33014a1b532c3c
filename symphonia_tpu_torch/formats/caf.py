"""Apple Core Audio Format (CAF) demuxer.

Analog of symphonia-format-caf (``CafReader``, demuxer.rs:42): desc/data/
pakt/chan/info chunk parsing (chunks.rs), CBR byte-math packetization or VBR
``pakt`` packet-table packetization (demuxer.rs:94-165), and seek in both
modes (demuxer.rs:177-309).
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

CAF_MARKER = b"caff"


class CafReader(FormatReader):
    """CAF format reader (caf demuxer.rs:42)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        if mss.read_bytes(4) != CAF_MARKER:
            raise Unsupported("missing caff marker")
        _version = mss.read_u16be()
        _flags = mss.read_u16be()

        self._desc = None
        self._kuki = None
        self._data_start = None
        self._data_len = None
        self._pakt = None  # (sizes list, n_frames, priming, remainder)
        rev = MetadataRevision()

        total = mss.byte_len()
        while True:
            try:
                ctype = mss.read_bytes(4)
            except Exception:
                break
            size = struct.unpack(">q", mss.read_bytes(8))[0]
            if size < 0 and ctype != b"data":
                # Only the final data chunk may use the -1 "rest of file"
                # sentinel; a negative size elsewhere is corruption (and
                # read_bytes(negative) must never be reached).
                raise DecodeError("negative CAF chunk size")
            if ctype == b"desc":
                payload = mss.read_bytes(size)
                self._parse_desc(payload)
            elif ctype == b"data":
                _edit = mss.read_u32be()
                self._data_start = mss.pos()
                if size == -1:  # size unknown: rest of file
                    self._data_len = (total - self._data_start) if total else None
                    break
                # DoS bound: a mutated declared size must not exceed the
                # real bytes (ignore_bytes on a seekable source seeks past
                # EOF without raising, so the declared size would otherwise
                # drive a giant CBR packet-table allocation); nor go
                # negative (np.full(-n) is a raw ValueError).
                self._data_len = max(0, size - 4)
                if total is not None:
                    self._data_len = min(self._data_len,
                                         max(0, total - self._data_start))
                mss.ignore_bytes(self._data_len)
            elif ctype == b"kuki":
                self._kuki = mss.read_bytes(size)
            elif ctype == b"chan":
                payload = mss.read_bytes(size)
                self._parse_chan(payload)
            elif ctype == b"pakt":
                payload = mss.read_bytes(size)
                self._parse_pakt(payload)
            elif ctype == b"info":
                payload = mss.read_bytes(size)
                self._parse_info(payload, rev)
            elif ctype == b"free" or size >= 0:
                mss.ignore_bytes(size)
            else:
                break

        if self._desc is None or self._data_start is None:
            raise DecodeError("missing desc or data chunk")
        if rev.tags:
            self._metadata.push(rev)

        (rate, fmt_id, flags, bytes_per_packet, frames_per_packet, n_ch, bits) = self._desc

        c = ccodec
        codec = None
        if fmt_id == b"lpcm":
            is_float = bool(flags & 0x1)
            is_le = bool(flags & 0x2)
            if is_float:
                codec = {
                    (32, True): c.CODEC_ID_PCM_F32LE, (32, False): c.CODEC_ID_PCM_F32BE,
                    (64, True): c.CODEC_ID_PCM_F64LE, (64, False): c.CODEC_ID_PCM_F64BE,
                }.get((bits, is_le))
            else:
                codec = {
                    (8, True): c.CODEC_ID_PCM_S8, (8, False): c.CODEC_ID_PCM_S8,
                    (16, True): c.CODEC_ID_PCM_S16LE, (16, False): c.CODEC_ID_PCM_S16BE,
                    (24, True): c.CODEC_ID_PCM_S24LE, (24, False): c.CODEC_ID_PCM_S24BE,
                    (32, True): c.CODEC_ID_PCM_S32LE, (32, False): c.CODEC_ID_PCM_S32BE,
                }.get((bits, is_le))
        elif fmt_id == b"ulaw":
            codec = c.CODEC_ID_PCM_MULAW
            bits = 16
        elif fmt_id == b"alaw":
            codec = c.CODEC_ID_PCM_ALAW
            bits = 16
        elif fmt_id == b"ima4":
            codec = c.CODEC_ID_ADPCM_IMA_QT
            bits = 16
        elif fmt_id == b"alac":
            codec = c.CODEC_ID_ALAC
        elif fmt_id == b"aac ":
            codec = c.CODEC_ID_AAC
        elif fmt_id == b".mp1":
            codec = c.CODEC_ID_MP1
        elif fmt_id == b".mp2":
            codec = c.CODEC_ID_MP2
        elif fmt_id == b".mp3":
            codec = c.CODEC_ID_MP3
        elif fmt_id == b"flac":
            codec = c.CODEC_ID_FLAC
        elif fmt_id == b"opus":
            codec = c.CODEC_ID_OPUS
        if codec is None:
            raise Unsupported(f"CAF format {fmt_id!r}")

        self._rate = int(rate)
        self._bpp = bytes_per_packet
        self._fpp = frames_per_packet
        self._cursor = 0

        if self._pakt is not None:
            sizes, pakt_frames, priming, remainder = self._pakt
            self._pkt_sizes = sizes
            self._pkt_offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
            n_frames = pakt_frames
        elif bytes_per_packet and frames_per_packet:
            n_pkts = (self._data_len or 0) // bytes_per_packet
            self._pkt_sizes = np.full(n_pkts, bytes_per_packet, dtype=np.int64)
            self._pkt_offsets = np.arange(n_pkts, dtype=np.int64) * bytes_per_packet
            n_frames = n_pkts * frames_per_packet
        else:
            raise DecodeError("CAF VBR stream requires a pakt chunk")

        params = AudioCodecParameters(
            codec=codec,
            sample_rate=self._rate,
            bits_per_sample=bits or None,
            channels=(Channels.positioned(self._chan_bitmap)
                      if getattr(self, "_chan_bitmap", None)
                      else Channels.from_count(n_ch)),
            max_frames_per_packet=frames_per_packet or None,
            frames_per_block=frames_per_packet or None,
            block_align=bytes_per_packet or None,
            extra_data=self._decoder_extra(codec),
        )
        self._track = Track(
            id=0,
            codec_params=params,
            time_base=TimeBase(1, self._rate),
            num_frames=int(n_frames) if n_frames else None,
        )

    def _decoder_extra(self, codec) -> Optional[bytes]:
        """Decoder extra data from the magic cookie (demuxer.rs:517-542):
        an AAC cookie is an ES descriptor — only its DecoderSpecificInfo
        (the ASC) is the decoder's extra data; every other format takes
        the whole cookie."""
        kuki = self._kuki
        if kuki and codec == ccodec.CODEC_ID_AAC:
            from .isomp4 import _parse_esds

            # _parse_esds expects the 4 version/flags bytes an esds atom
            # carries before the descriptor; the cookie starts at tag 0x03.
            _oti, asc = _parse_esds(b"\x00\x00\x00\x00" + kuki)
            if asc:
                return asc
        return kuki

    def _parse_chan(self, payload: bytes) -> None:
        """Audio channel layout chunk (chunks.rs ChannelLayout): layout tag
        or a channel bitmap; stored for the track's channel map."""
        if len(payload) < 12:
            return
        tag, bitmap, _ndesc = struct.unpack(">III", payload[:12])
        self._chan_bitmap = None
        if tag == 0x10000:  # kCAFChannelLayoutTag_UseChannelBitmap
            # CoreAudio bitmap bit order matches the WAVE/Position order.
            self._chan_bitmap = bitmap

    def _parse_desc(self, payload: bytes) -> None:
        if len(payload) < 32:
            raise DecodeError("desc chunk too small")
        rate = struct.unpack(">d", payload[:8])[0]
        fmt_id = payload[8:12]
        flags, bpp, fpp, n_ch, bits = struct.unpack(">IIIII", payload[12:32])
        # int(rate) is the value actually used: a crafted 0 < rate < 1
        # truncates to a zero TimeBase, and NaN raises on int() — both
        # must be DecodeError, not raw ValueError.
        import math

        if not math.isfinite(rate) or int(rate) <= 0 or n_ch == 0:
            raise DecodeError("invalid desc parameters")
        self._desc = (rate, fmt_id, flags, bpp, fpp, n_ch, bits)

    def _parse_pakt(self, payload: bytes) -> None:
        if len(payload) < 24:
            raise DecodeError("pakt chunk too small")
        n_pkts, n_frames, priming, remainder = struct.unpack(">qqii", payload[:24])
        # DoS bound: every packet entry is at least one varint byte, so the
        # chunk's own size caps a crafted count (a mutated count must not
        # drive a giant allocation or walk).
        if n_pkts < 0 or n_pkts > len(payload) - 24:
            raise DecodeError("pakt count exceeds chunk")
        sizes = np.zeros(n_pkts, dtype=np.int64)
        pos = 24
        for i in range(n_pkts):
            v = 0
            while True:
                if pos >= len(payload):
                    raise DecodeError("truncated pakt table")
                b = payload[pos]
                pos += 1
                v = (v << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            sizes[i] = v
        self._pakt = (sizes, n_frames, priming, remainder)

    _INFO_KEYS = {
        "title": "track_title", "artist": "artist", "album": "album",
        "genre": "genre", "year": "date", "composer": "composer",
        "comments": "comment", "copyright": "copyright",
        "track number": "track_number",
    }

    def _parse_info(self, payload: bytes, rev: MetadataRevision) -> None:
        try:
            (count,) = struct.unpack(">I", payload[:4])
            strings = payload[4:].split(b"\x00")
            for i in range(count):
                if 2 * i + 1 >= len(strings):
                    break
                key = strings[2 * i].decode("utf-8", "replace")
                val = strings[2 * i + 1].decode("utf-8", "replace")
                rev.tags.append(RawTag(key, val, self._INFO_KEYS.get(key.lower())))
        except struct.error:
            pass

    # -- FormatReader ------------------------------------------------------

    def tracks(self) -> List[Track]:
        return [self._track]

    def next_packet(self) -> Optional[Packet]:
        if self._cursor >= len(self._pkt_sizes):
            return None
        i = self._cursor
        self._cursor += 1
        off = self._data_start + int(self._pkt_offsets[i])
        size = int(self._pkt_sizes[i])
        self.mss.seek(off)
        data = self.mss.read_bytes(size)
        fpp = self._fpp or 0
        return Packet(track_id=0, ts=i * fpp, dur=fpp, data=data)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = self._track.time_base.calc_timestamp(to.time)
        else:
            raise SeekError("no seek target")
        fpp = self._fpp or 1
        i = max(0, min(len(self._pkt_sizes) - 1, ts // fpp))
        self._cursor = int(i)
        return SeekedTo(0, ts, int(i) * fpp)

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        n = len(self._pkt_sizes)
        fpp = self._fpp or 0
        idx = np.arange(n, dtype=np.int64)
        return PacketTable(
            track_id=0,
            offsets=self._data_start + self._pkt_offsets,
            sizes=self._pkt_sizes.copy(),
            ts=idx * fpp,
            dur=np.full(n, fpp, dtype=np.int64),
            trim_start=np.zeros(n, dtype=np.int32),
            trim_end=np.zeros(n, dtype=np.int32),
        )


def _score(context: bytes) -> int:
    return 255 if context.startswith(CAF_MARKER) else 0


DESCRIPTOR = Descriptor(
    name="caf",
    markers=[CAF_MARKER],
    factory=CafReader,
    score=_score,
)
