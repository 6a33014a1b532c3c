"""Matroska / WebM demuxer.

Analog of symphonia-format-mkv (``MkvReader``, demuxer.rs:52): generic EBML
vint/element parsing (ebml.rs), segment/info/tracks/cluster walk
(segment.rs), SimpleBlock/BlockGroup frame extraction with Xiph/fixed/EBML
lacing (lacing.rs:139), Matroska codec-id -> codec parameter mapping
(codecs.rs), and Tags -> metadata (tags.rs).

Batch-first: clusters are walked once into a packet table.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.audio import Channels
from ..core.codecs import AudioCodecParameters
from ..core.errors import DecodeError, SeekError, Unsupported
from ..core.formats import (
    FormatOptions,
    FormatReader,
    PacketTable,
    SeekTo,
    SeekedTo,
    Track,
    TrackFlags,
)
from ..core.meta import MetadataLog, MetadataRevision, RawTag
from ..core.packet import Packet
from ..core.probe import Descriptor
from ..core.units import TimeBase

EBML_MAGIC = b"\x1a\x45\xdf\xa3"

# Element IDs (Matroska spec).
ID_SEGMENT = 0x18538067
ID_INFO = 0x1549A966
ID_TIMESTAMP_SCALE = 0x2AD7B1
ID_TITLE = 0x7BA9
ID_TRACKS = 0x1654AE6B
ID_TRACK_ENTRY = 0xAE
ID_TRACK_NUMBER = 0xD7
ID_TRACK_TYPE = 0x83
ID_CODEC_ID = 0x86
ID_CODEC_PRIVATE = 0x63A2
ID_AUDIO = 0xE1
ID_VIDEO = 0xE0
ID_PIXEL_WIDTH = 0xB0
ID_PIXEL_HEIGHT = 0xBA
ID_SAMPLING_FREQ = 0xB5
ID_OUT_SAMPLING_FREQ = 0x78B5
ID_CHANNELS = 0x9F
ID_BIT_DEPTH = 0x6264
ID_CLUSTER = 0x1F43B675
ID_CLUSTER_TIMESTAMP = 0xE7
ID_SIMPLE_BLOCK = 0xA3
ID_BLOCK_GROUP = 0xA0
ID_BLOCK = 0xA1
ID_TAGS = 0x1254C367
ID_TAG = 0x7373
ID_SIMPLE_TAG = 0x67C8
ID_TAG_NAME = 0x45A3
ID_TAG_STRING = 0x4487
ID_TARGETS = 0x63C0
ID_TARGET_TYPE_VALUE = 0x68CA
ID_TARGET_TYPE = 0x63CA
ID_TAG_TRACK_UID = 0x63C5
ID_TAG_EDITION_UID = 0x63C9
ID_TAG_CHAPTER_UID = 0x63C4
ID_TAG_ATTACHMENT_UID = 0x63C6
ID_TRACK_UID = 0x73C5
ID_CHAPTER_UID = 0x73C4
ID_LANGUAGE = 0x22B59C
ID_TRACK_LANGUAGE = 0x22B59C  # TrackEntry Language (ISO 639-2)
ID_TRACK_LANGUAGE_BCP47 = 0x22B59D  # overrides Language when present
ID_SEG_DURATION = 0x4489  # Info Duration (float, timescale units)
ID_CHAPTERS = 0x1043A770
ID_EDITION_ENTRY = 0x45B9
ID_CHAPTER_ATOM = 0xB6
ID_CHAPTER_TIME_START = 0x91
ID_CHAPTER_TIME_END = 0x92
ID_CHAPTER_DISPLAY = 0x80
ID_CHAP_STRING = 0x85
ID_ATTACHMENTS = 0x1941A469
ID_ATTACHED_FILE = 0x61A7
ID_FILE_NAME = 0x466E
ID_FILE_MIME = 0x4660
ID_FILE_DATA = 0x465C
ID_FILE_DESCRIPTION = 0x467E
ID_BLOCK_DURATION = 0x9B
ID_REFERENCE_BLOCK = 0xFB
ID_DEFAULT_DURATION = 0x23E383
ID_CUES = 0x1C53BB6B
ID_CUE_POINT = 0xBB
ID_CUE_TIME = 0xB3
ID_CUE_TRACK_POSITIONS = 0xB7
ID_CUE_TRACK = 0xF7
ID_CUE_CLUSTER_POSITION = 0xF1
ID_SEEK_HEAD = 0x114D9B74
ID_SEEK = 0x4DBB
ID_SEEK_ID = 0x53AB
ID_SEEK_POSITION = 0x53AC

# Top-level segment children: an unknown-size cluster ends at the next one.
_TOP_LEVEL_IDS = {ID_SEGMENT, ID_INFO, ID_TRACKS, ID_CLUSTER, ID_CUES,
                  ID_TAGS, ID_CHAPTERS, ID_ATTACHMENTS, ID_SEEK_HEAD}


def read_vint(buf: bytes, pos: int, keep_marker: bool) -> Tuple[int, int]:
    """Read an EBML variable-size integer; returns (value, next_pos)."""
    if pos >= len(buf):
        raise DecodeError("EBML vint at EOF")
    b0 = buf[pos]
    if b0 == 0:
        raise DecodeError("invalid EBML vint")
    length = 8 - b0.bit_length() + 1
    if pos + length > len(buf):
        raise DecodeError("truncated EBML vint")
    val = b0 if keep_marker else b0 & ((1 << (8 - length)) - 1)
    for i in range(1, length):
        val = (val << 8) | buf[pos + i]
    return val, pos + length


def read_element_header_ex(buf: bytes, pos: int) -> Tuple[int, int, int, bool]:
    """Returns (element_id, data_size, data_start, unknown_size).

    "Unknown size" is a size vint whose data bits are ALL ones at ANY coded
    length (a 1-byte 0xFF means unknown, not 127)."""
    eid, p1 = read_vint(buf, pos, keep_marker=True)
    size, p2 = read_vint(buf, p1, keep_marker=False)
    length = p2 - p1
    unknown = size == (1 << (7 * length)) - 1
    return eid, size, p2, unknown


def read_element_header(buf: bytes, pos: int) -> Tuple[int, int, int]:
    """Returns (element_id, data_size, data_start)."""
    eid, size, body, _ = read_element_header_ex(buf, pos)
    return eid, size, body


def iter_elements(buf: bytes, start: int, end: int):
    pos = start
    while pos < end:
        try:
            eid, size, body, unknown = read_element_header_ex(buf, pos)
        except DecodeError:
            return
        # "Unknown size" extends to end of parent (callers that can contain
        # unknown-size CLUSTERS must walk manually and bound them at the
        # next top-level id).
        if unknown or body + size > end:
            size = end - body
        yield eid, body, body + size
        pos = body + size


def _uint(buf, b, e) -> int:
    return int.from_bytes(buf[b:e], "big")


def _float(buf, b, e) -> float:
    """EBML float body -> value; 0.0 for invalid lengths AND non-finite
    payloads (NaN/inf would raise raw ValueError/OverflowError out of the
    int(round(...)) call sites — the CAF NaN-rate taxonomy class)."""
    n = e - b
    if n == 4:
        v = struct.unpack(">f", buf[b:e])[0]
    elif n == 8:
        v = struct.unpack(">d", buf[b:e])[0]
    else:
        return 0.0
    return v if math.isfinite(v) else 0.0


@dataclass
class MkvTrack:
    number: int = 0
    uid: int = 0  # TrackUID (tag Targets reference it)
    codec_id: str = ""
    codec_private: Optional[bytes] = None
    sample_rate: float = 8000.0
    out_sample_rate: Optional[float] = None  # SBR OutputSamplingFrequency
    channels: int = 1
    bit_depth: Optional[int] = None
    default_duration_ns: Optional[int] = None
    codec: Optional[str] = None
    params: Optional[AudioCodecParameters] = None
    width: Optional[int] = None
    height: Optional[int] = None
    language: Optional[str] = None
    flags: int = 0  # core TrackFlags bits


# TrackEntry flag elements -> TrackFlags bits (segment.rs:466-507). The
# value element carries 0/1; FlagDefault's schema default is 1 (set), so
# its bit is pre-set on MkvTrack construction and cleared on explicit 0.
_FLAG_ELEMENTS = {
    0x88: TrackFlags.DEFAULT,  # FlagDefault
    0x55AA: TrackFlags.FORCED,
    0x55AB: TrackFlags.HEARING_IMPAIRED,
    0x55AC: TrackFlags.VISUALLY_IMPAIRED,
    0x55AD: TrackFlags.TEXT_DESCRIPTIONS,
    0x55AE: TrackFlags.ORIGINAL_LANGUAGE,
    0x55AF: TrackFlags.COMMENTARY,
}


def _parse_track_entry(buf: bytes, b: int, e: int) -> Tuple["MkvTrack", int]:
    """Parse one TrackEntry master element; returns (track, track_type)."""
    t = MkvTrack()
    t.flags = TrackFlags.DEFAULT  # FlagDefault schema default is 1
    ttype = 0
    for eid3, b3, e3 in iter_elements(buf, b, e):
        if eid3 == ID_TRACK_NUMBER:
            t.number = _uint(buf, b3, e3)
        elif eid3 == ID_TRACK_UID:
            t.uid = _uint(buf, b3, e3)
        elif eid3 == ID_TRACK_TYPE:
            ttype = _uint(buf, b3, e3)
        elif eid3 == ID_DEFAULT_DURATION:
            t.default_duration_ns = _uint(buf, b3, e3)
        elif eid3 == ID_CODEC_ID:
            t.codec_id = buf[b3:e3].decode("ascii", "replace")
        elif eid3 == ID_CODEC_PRIVATE:
            t.codec_private = buf[b3:e3]
        elif eid3 in (ID_TRACK_LANGUAGE, ID_TRACK_LANGUAGE_BCP47):
            # BCP47 (0x22B59D) overrides the legacy ISO 639-2 element.
            lang = buf[b3:e3].split(b"\x00")[0].decode("ascii", "replace")
            if eid3 == ID_TRACK_LANGUAGE_BCP47 or t.language is None:
                t.language = lang or t.language
        elif eid3 in _FLAG_ELEMENTS:
            if _uint(buf, b3, e3):
                t.flags |= _FLAG_ELEMENTS[eid3]
            else:
                t.flags &= ~_FLAG_ELEMENTS[eid3]
        elif eid3 == ID_AUDIO:
            for eid4, b4, e4 in iter_elements(buf, b3, e3):
                if eid4 == ID_SAMPLING_FREQ:
                    f = _float(buf, b4, e4)
                    if f > 0:  # garbage keeps the 8000 Hz spec default
                        t.sample_rate = f
                elif eid4 == ID_OUT_SAMPLING_FREQ:
                    # SBR output rate; preferred over the internal rate
                    # when present (audio.rs).
                    f = _float(buf, b4, e4)
                    if f > 0:
                        t.out_sample_rate = f
                elif eid4 == ID_CHANNELS:
                    t.channels = _uint(buf, b4, e4)
                elif eid4 == ID_BIT_DEPTH:
                    t.bit_depth = _uint(buf, b4, e4)
        elif eid3 == ID_VIDEO:
            for eid4, b4, e4 in iter_elements(buf, b3, e3):
                if eid4 == ID_PIXEL_WIDTH:
                    t.width = _uint(buf, b4, e4)
                elif eid4 == ID_PIXEL_HEIGHT:
                    t.height = _uint(buf, b4, e4)
    return t, ttype


_MKV_DESCRIBED_ONLY = {
    "A_MPC": "musepack",
    "A_AC3": "ac3", "A_AC3/BSID9": "ac3", "A_AC3/BSID10": "ac3",
    "A_EAC3": "eac3",
    "A_TRUEHD": "truehd",
    "A_DTS": "dca",
    "A_TTA1": "tta",
    "A_WAVPACK4": "wavpack",
    "A_ATRAC/AT1": "atrac1",
    "A_REAL/ATRC": "atrac3",
    "A_REAL/14_4": "ra10", "A_REAL/28_8": "ra20",
    "A_REAL/COOK": "cook", "A_REAL/SIPR": "sipr", "A_REAL/RALF": "ralf",
}


def _map_codec(t: MkvTrack) -> None:
    """Matroska codec id -> codec parameters (codecs.rs:392)."""
    cid = t.codec_id
    rate = int(round(t.out_sample_rate or t.sample_rate))
    ch = Channels.from_count(t.channels)
    extra = t.codec_private
    c, bits = None, t.bit_depth
    if cid == "A_FLAC":
        c = "flac"
        if extra and extra[:4] == b"fLaC":
            # Strip marker + block header to the STREAMINFO payload.
            extra = extra[8 : 8 + 34]
    elif cid == "A_VORBIS":
        c = "vorbis"
    elif cid == "A_OPUS":
        c = "opus"
    elif cid.startswith("A_AAC"):
        c = "aac"
        if not extra:
            from ..common.mpeg import AudioSpecificConfig

            try:
                extra = AudioSpecificConfig.build(2, rate, t.channels)
            except (ValueError, OverflowError):
                extra = None  # non-ISO rate / absurd channel count
    elif cid == "A_MPEG/L3":
        c = "mp3"
    elif cid == "A_MPEG/L2":
        c = "mp2"
    elif cid == "A_MPEG/L1":
        c = "mp1"
    elif cid == "A_ALAC":
        c = "alac"
    elif cid == "A_PCM/INT/LIT":
        c = {8: "pcm_s8", 16: "pcm_s16le", 24: "pcm_s24le", 32: "pcm_s32le"}.get(bits or 16)
    elif cid == "A_PCM/INT/BIG":
        c = {8: "pcm_s8", 16: "pcm_s16be", 24: "pcm_s24be", 32: "pcm_s32be"}.get(bits or 16)
    elif cid == "A_PCM/FLOAT/IEEE":
        c = {32: "pcm_f32le", 64: "pcm_f64le"}.get(bits or 32)
    else:
        # Described-only ids (codecs.rs:264-280): the reference maps these
        # to well-known codec IDs but ships no decoder — the track
        # surfaces and demuxes; make_audio_decoder raises Unsupported.
        c = _MKV_DESCRIBED_ONLY.get(cid)
    if c is None:
        return
    t.codec = c
    t.params = AudioCodecParameters(
        codec=c, sample_rate=rate, channels=ch, bits_per_sample=bits,
        extra_data=extra,
    )


# Matroska video/subtitle codec ids -> experimental codec parameters
# (codecs.rs:304-336). Exposed as track DESCRIPTIONS via
# FormatReader.other_tracks(); no decoder ships for them, matching the
# reference's exp-video/-subtitle surface.
_MKV_VIDEO_IDS = {
    "V_MJPEG": "mjpeg", "V_MPEG4/MS/V3": "msmpeg4v3", "V_MPEG1": "mpeg1video",
    "V_MPEG2": "mpeg2video", "V_MPEG4/ISO/SP": "mpeg4video",
    "V_MPEG4/ISO/ASP": "mpeg4video", "V_MPEG4/ISO/AVC": "h264",
    "V_MPEG4/ISO/AP": "h264", "V_MPEGH/ISO/HEVC": "hevc",
    "V_REAL/RV10": "rv10", "V_REAL/RV20": "rv20", "V_REAL/RV30": "rv30",
    "V_REAL/RV40": "rv40", "V_THEORA": "theora", "V_VP8": "vp8",
    "V_VP9": "vp9", "V_AV1": "av1", "V_AVS2": "avs2", "V_AVS3": "avs3",
}
_MKV_SUBTITLE_IDS = {
    "S_TEXT/UTF8": "text_utf8", "S_TEXT/SSA": "ssa", "S_TEXT/ASS": "ass",
    "S_TEXT/WEBVTT": "webvtt", "S_IMAGE/BMP": "bmp_subtitle",
    "S_VOBSUB": "vobsub", "S_DVBSUB": "dvbsub", "S_HDMV/PGS": "hdmv_pgs",
    "S_KATE": "kate",
}


def _map_other_codec(t: MkvTrack, ttype: int):
    """Video/subtitle codec parameters for a non-audio track, or None."""
    if ttype == 1 and t.codec_id in _MKV_VIDEO_IDS:
        from ..core.video import VideoCodecParameters, VideoExtraData

        extra = ([VideoExtraData(data=bytes(t.codec_private))]
                 if t.codec_private else [])
        return VideoCodecParameters(codec=_MKV_VIDEO_IDS[t.codec_id],
                                    width=t.width, height=t.height,
                                    extra_data=extra)
    if ttype == 0x11 and t.codec_id in _MKV_SUBTITLE_IDS:
        from ..core.subtitle import SubtitleCodecParameters

        return SubtitleCodecParameters(
            codec=_MKV_SUBTITLE_IDS[t.codec_id],
            extra_data=bytes(t.codec_private) if t.codec_private else None)
    return None


def unlace(buf: bytes) -> List[bytes]:
    """Split a (Simple)Block payload's frames by its lacing mode
    (lacing.rs:139). ``buf`` starts at the flags byte's lacing field."""
    flags = buf[0]
    lacing = (flags >> 1) & 0x3
    data = buf[1:]
    if lacing == 0:
        return [data]
    n_frames = data[0] + 1
    pos = 1
    if lacing == 2:  # fixed
        body = data[pos:]
        size = len(body) // n_frames
        return [body[i * size : (i + 1) * size] for i in range(n_frames)]
    sizes = []
    if lacing == 1:  # Xiph
        for _ in range(n_frames - 1):
            v = 0
            while True:
                b = data[pos]
                pos += 1
                v += b
                if b != 255:
                    break
            sizes.append(v)
    else:  # EBML lacing
        first, pos = read_vint(data, pos, keep_marker=False)
        sizes.append(first)
        prev = first
        for _ in range(n_frames - 2):
            raw, pos2 = read_vint(data, pos, keep_marker=False)
            length = pos2 - pos
            # Signed vint: subtract the midpoint bias.
            delta = raw - ((1 << (7 * length - 1)) - 1)
            pos = pos2
            prev += delta
            if prev < 0:
                # A negative frame size is malformed (lacing.rs rejects it);
                # accepting it would walk the split offset backwards and
                # emit overlapping garbage frames.
                raise DecodeError("mkv: negative EBML lace size")
            sizes.append(prev)
    out = []
    body = data[pos:]
    off = 0
    for s in sizes:
        out.append(body[off : off + s])
        off += s
    out.append(body[off:])
    return out


def parse_block(buf, bb: int, be: int):
    """(Simple)Block payload -> (track_no, rel_ts, frames, keyframe) or
    None on a truncated/foreign body (malformed input must not crash).

    ``keyframe`` is the SimpleBlock flags-byte keyframe bit (0x80,
    lacing.rs); for a BlockGroup Block the bit is reserved-zero and the
    caller overrides it from ReferenceBlock presence."""
    try:
        track_no, p2 = read_vint(buf, bb, keep_marker=False)
    except DecodeError:
        return None
    if p2 + 3 > be:
        return None  # too short for rel_ts + flags
    rel_ts = struct.unpack(">h", buf[p2 : p2 + 2])[0]
    keyframe = bool(buf[p2 + 2] & 0x80)
    try:
        frames = unlace(buf[p2 + 2 : be])
    except (IndexError, DecodeError):
        return None
    return track_no, rel_ts, frames, keyframe


def _expand_blocks(
    blocks: List[Tuple[int, int, List[bytes], Optional[int], bool]],
    tracks: Dict[int, "MkvTrack"],
    timescale_ns: int,
) -> List[Tuple[int, int, int, bytes, bool]]:
    """Blocks -> per-frame (track_no, ts, dur, data, keyframe) packets.

    Block duration precedence (demuxer.rs / segment.rs): explicit
    BlockDuration, else the gap to the track's next block, else the track's
    DefaultDuration; laced frames split the block duration evenly and get
    consecutive timestamps (all laced frames share the block's keyframe
    flag — lacing.rs extracts frames, the flag is per block).
    """
    # Next-block gap per track.
    idx_by_track: Dict[int, List[int]] = {}
    for i, (no, ts, _f, _d, _k) in enumerate(blocks):
        idx_by_track.setdefault(no, []).append(i)
    gaps: List[Optional[int]] = [None] * len(blocks)
    for no, idxs in idx_by_track.items():
        for j, i in enumerate(idxs):
            if j + 1 < len(idxs):
                g = blocks[idxs[j + 1]][1] - blocks[i][1]
                gaps[i] = g if g > 0 else None
    out: List[Tuple[int, int, int, bytes, bool]] = []
    for i, (no, ts, frames, bdur, key) in enumerate(blocks):
        t = tracks.get(no)
        if bdur is None:
            bdur = gaps[i]
        if bdur is None and t is not None and t.default_duration_ns:
            bdur = max(1, round(t.default_duration_ns * len(frames)
                                / timescale_ns))
        if bdur is None:
            bdur = 0
        fdur = bdur // len(frames)
        for k, f in enumerate(frames):
            out.append((no, ts + k * fdur, fdur, f, key))
    return out


def parse_mkv_chapters(buf, b, e):
    """Chapters element -> (ChapterGroup or None, ChapterUID -> Chapter
    map for tag Targets routing) (demuxer.rs:583-590, segment.rs)."""
    from ..core.meta import Chapter, ChapterGroup

    group = ChapterGroup()
    uid_map = {}
    for eid, b2, e2 in iter_elements(buf, b, e):
        if eid != ID_EDITION_ENTRY:
            continue
        for eid2, b3, e3 in iter_elements(buf, b2, e2):
            if eid2 != ID_CHAPTER_ATOM:
                continue
            start_ns = 0
            end_ns = None
            title = None
            uid = 0
            for eid3, b4, e4 in iter_elements(buf, b3, e3):
                if eid3 == ID_CHAPTER_TIME_START:
                    start_ns = _uint(buf, b4, e4)
                elif eid3 == ID_CHAPTER_TIME_END:
                    end_ns = _uint(buf, b4, e4)
                elif eid3 == ID_CHAPTER_UID:
                    uid = _uint(buf, b4, e4)
                elif eid3 == ID_CHAPTER_DISPLAY:
                    for eid4, b5, e5 in iter_elements(buf, b4, e4):
                        if eid4 == ID_CHAP_STRING:
                            title = buf[b5:e5].decode("utf-8", "replace")
            ch = Chapter(start_time=start_ns / 1e9,
                         end_time=end_ns / 1e9 if end_ns is not None else None,
                         title=title)
            group.items.append(ch)
            if uid:
                uid_map[uid] = ch
    return (group if group.items else None), uid_map


def parse_mkv_attachments(buf, b, e):
    """Attachments element -> Attachment list (demuxer.rs:583-590)."""
    from ..core.meta import Attachment

    out = []
    for eid, b2, e2 in iter_elements(buf, b, e):
        if eid != ID_ATTACHED_FILE:
            continue
        name = mime = desc = None
        data = b""
        for eid2, b3, e3 in iter_elements(buf, b2, e2):
            if eid2 == ID_FILE_NAME:
                name = buf[b3:e3].decode("utf-8", "replace")
            elif eid2 == ID_FILE_MIME:
                mime = buf[b3:e3].decode("ascii", "replace")
            elif eid2 == ID_FILE_DATA:
                data = buf[b3:e3]
            elif eid2 == ID_FILE_DESCRIPTION:
                desc = buf[b3:e3].decode("utf-8", "replace")
        out.append(Attachment(name=name, media_type=mime, data=data,
                              description=desc))
    return out


def _parse_simple_tag(buf, b, e, depth=0):
    """One SimpleTag element -> (name, value, nested sub-tags)."""
    name = val = None
    subs = []
    for eid, b2, e2 in iter_elements(buf, b, e):
        if eid == ID_TAG_NAME:
            name = buf[b2:e2].decode("utf-8", "replace")
        elif eid == ID_TAG_STRING:
            val = buf[b2:e2].decode("utf-8", "replace")
        elif eid == ID_SIMPLE_TAG and depth < 4:  # nesting DoS bound
            subs.append(_parse_simple_tag(buf, b2, e2, depth + 1))
    return name, val, subs


def parse_mkv_tags(buf, b, e, rev: MetadataRevision, is_video=False,
                   track_uid_map=None, chapter_uid_map=None) -> None:
    """Tags element -> RawTags appended to ``rev`` with target scoping.

    Mirrors format-mkv tags.rs:16-177 + segment.rs TargetsElement /
    into_metadata: every Tag element's Targets assigns its SimpleTags a
    target level (TargetTypeValue, default 50), an optional explicit type
    name, and optional track/edition/chapter/attachment UID lists (UID 0
    = all of that kind). Raw keys carry the effective target name as a
    '<NAME>@' prefix; the level-aware standard mapping lives in
    metadata/std_tag.py map_mkv_tag. Tag elements are processed in
    ascending target-level order so a TOTAL_PARTS tag can resolve against
    the next-lower level's target name (tags.rs:347-402).

    Scoping: track-UID-targeted tags land in ``rev.track_tags`` keyed by
    the reader's track id (``track_uid_map``: TrackUID -> track number;
    the reference keys its per-track metadata by UID, but the repo's
    public surface identifies tracks by number). Chapter-UID-targeted
    tags attach to the matching Chapter's tag list; edition/attachment
    targets with unknown UIDs are dropped, as the reference drops tags
    for UIDs it never saw."""
    from ..metadata.std_tag import map_mkv_tag, mkv_target_name

    track_uid_map = track_uid_map or {}
    entries = []
    for eid, b2, e2 in iter_elements(buf, b, e):
        if eid != ID_TAG:
            continue
        level = tname = None
        uids = {"track": [], "edition": [], "chapter": [], "attachment": []}
        simple = []
        for eid2, b3, e3 in iter_elements(buf, b2, e2):
            if eid2 == ID_SIMPLE_TAG:
                st = _parse_simple_tag(buf, b3, e3)
                if st[0]:
                    simple.append(st)
            elif eid2 == ID_TARGETS:
                level = 50  # TargetTypeValue schema default
                for eid3, b4, e4 in iter_elements(buf, b3, e3):
                    if eid3 == ID_TARGET_TYPE_VALUE:
                        level = _uint(buf, b4, e4)
                    elif eid3 == ID_TARGET_TYPE:
                        tname = buf[b4:e4].decode("utf-8", "replace") or None
                    elif eid3 == ID_TAG_TRACK_UID:
                        uids["track"].append(_uint(buf, b4, e4))
                    elif eid3 == ID_TAG_EDITION_UID:
                        uids["edition"].append(_uint(buf, b4, e4))
                    elif eid3 == ID_TAG_CHAPTER_UID:
                        uids["chapter"].append(_uint(buf, b4, e4))
                    elif eid3 == ID_TAG_ATTACHMENT_UID:
                        uids["attachment"].append(_uint(buf, b4, e4))
        entries.append((level, tname, uids, simple))
    # Ascending target level, untargeted last; Python's sort is stable so
    # same-level elements keep file order (into_metadata's sort).
    entries.sort(key=lambda t: t[0] if t[0] is not None else 1 << 62)

    def emit(simple, label, lower, out_list):
        prefix = label + "@" if label else ""
        for name, val, subs in simple:
            nu = name.upper()
            if nu in ("ORIGINAL", "SAMPLE"):
                # Parent tags: flatten to <TARGET>@ORIGINAL/<SUB>.
                for sn, sv, _ in subs:
                    if sn and sv is not None:
                        key = nu + "/" + sn
                        out_list.extend(map_mkv_tag(prefix + key, key, sv,
                                                    label, lower))
            elif nu == "COUNTRY":
                for sn, sv, _ in subs:
                    if sn and sv is not None:
                        out_list.extend(map_mkv_tag(prefix + sn, sn, sv,
                                                    label, lower))
            else:
                if val is not None:
                    out_list.extend(map_mkv_tag(prefix + name, name, val,
                                                label, lower))
                for sn, sv, _ in subs:
                    if sn and sn.upper() == "SORT_WITH" and sv is not None:
                        key = name + "/SORT_WITH"
                        out_list.extend(map_mkv_tag(prefix + key, key, sv,
                                                    label, lower))

    lower_media = None
    lower_track = {}
    for level, tname, uids, simple in entries:
        if level is None:
            label = ""
        else:
            label = (tname or mkv_target_name(level, is_video)
                     or "#%d" % level)
        if level is not None and any(uids.values()):
            tuids = (list(track_uid_map) if 0 in uids["track"]
                     else [u for u in uids["track"] if u in track_uid_map])
            for u in tuids:
                tid = track_uid_map[u]
                lst = rev.track_tags.setdefault(tid, [])
                emit(simple, label, lower_track.get(u), lst)
                lower_track[u] = label
            if chapter_uid_map:
                cuids = (list(chapter_uid_map) if 0 in uids["chapter"]
                         else [u for u in uids["chapter"]
                               if u in chapter_uid_map])
                for u in cuids:
                    emit(simple, label, None, chapter_uid_map[u].tags)
        else:
            emit(simple, label, lower_media, rev.tags)
            lower_media = label if level is not None else None


def mkv_tag_scope(mkv_tracks, other_tracks):
    """``(is_video, track_uid_map)`` for :func:`parse_mkv_tags`.

    tags.rs:328-507 keys its target-level name table off whether the
    segment carries video, and scopes TrackUID-targeted tags to tracks.
    Both readers must compute these identically (a past bug had the stream
    reader resolving video-MKV targets with the audio name table)."""
    from ..core.video import VideoCodecParameters as _VCP

    is_video = any(isinstance(tr.codec_params, _VCP) for tr in other_tracks)
    uid_map = {t.uid: no for no, t in mkv_tracks.items() if t.uid}
    return is_video, uid_map


class MkvReader(FormatReader):
    """Matroska format reader (mkv demuxer.rs:52)."""

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        self._other_tracks: List[Track] = []
        chunks = []
        while True:
            b = mss.read_upto(1 << 22)
            if not b:
                break
            chunks.append(b)
        buf = b"".join(chunks)
        if not buf.startswith(EBML_MAGIC):
            raise Unsupported("not an EBML stream")

        # Skip the EBML header element.
        eid, size, body = read_element_header(buf, 0)
        pos = body + size

        segment = None
        for eid, b, e in iter_elements(buf, pos, len(buf)):
            if eid == ID_SEGMENT:
                segment = (b, e)
                break
        if segment is None:
            raise Unsupported("missing Matroska segment")

        timescale_ns = 1_000_000
        seg_duration: Optional[int] = None  # Info Duration, timescale ticks
        self._mkv_tracks: Dict[int, MkvTrack] = {}
        self._other_mkv_tracks: Dict[int, MkvTrack] = {}
        # Blocks: (track_no, ts_ticks, [frames], block_dur_ticks|None, key)
        blocks: List[Tuple[int, int, List[bytes], Optional[int], bool]] = []
        self._cues: List[Tuple[int, int]] = []  # (time_ticks, cluster_pos)
        self._segment_start = segment[0]
        rev = MetadataRevision()
        tags_spans: List[Tuple[int, int]] = []
        chapter_uids: Dict[int, object] = {}

        # Manual segment walk: unknown-size CLUSTERS (live captures saved to
        # disk) end at the next top-level element, which iter_elements can't
        # express.
        seg_b, seg_e = segment
        seg_children = []
        pos = seg_b
        while pos < seg_e:
            try:
                eid, size, body, unknown = read_element_header_ex(buf, pos)
            except DecodeError:
                break
            if eid == ID_CLUSTER and unknown:
                p2 = body
                end2 = p2
                while p2 < seg_e:
                    try:
                        eid2, size2, body2, unk2 = read_element_header_ex(buf, p2)
                    except DecodeError:
                        break
                    if eid2 in _TOP_LEVEL_IDS or unk2:
                        break
                    p2 = min(seg_e, body2 + size2)
                    end2 = p2
                seg_children.append((eid, body, end2))
                pos = end2
                continue
            if unknown or body + size > seg_e:
                size = seg_e - body
            seg_children.append((eid, body, body + size))
            pos = body + size

        for eid, b, e in seg_children:
            if eid == ID_INFO:
                for eid2, b2, e2 in iter_elements(buf, b, e):
                    if eid2 == ID_TIMESTAMP_SCALE:
                        # 0 is invalid (and would build a 0/denominator
                        # TimeBase); keep the spec default.
                        timescale_ns = _uint(buf, b2, e2) or timescale_ns
                    elif eid2 == ID_SEG_DURATION:
                        d = _float(buf, b2, e2)
                        if d and d > 0:
                            seg_duration = int(round(d))
                    elif eid2 == ID_TITLE:
                        rev.tags.append(RawTag("title",
                                               buf[b2:e2].decode("utf-8", "replace"),
                                               "track_title"))
            elif eid == ID_TRACKS:
                for eid2, b2, e2 in iter_elements(buf, b, e):
                    if eid2 != ID_TRACK_ENTRY:
                        continue
                    t, ttype = _parse_track_entry(buf, b2, e2)
                    if ttype == 2:  # audio
                        _map_codec(t)
                        if t.codec is not None:
                            self._mkv_tracks[t.number] = t
                    else:
                        op = _map_other_codec(t, ttype)
                        if op is not None:
                            self._other_mkv_tracks[t.number] = t
                            self._other_tracks.append(
                                Track(id=t.number, codec_params=op,
                                      language=t.language, flags=t.flags))
            elif eid == ID_CLUSTER:
                cluster_ts = 0
                for eid2, b2, e2 in iter_elements(buf, b, e):
                    if eid2 == ID_CLUSTER_TIMESTAMP:
                        cluster_ts = _uint(buf, b2, e2)
                    elif eid2 in (ID_SIMPLE_BLOCK, ID_BLOCK_GROUP):
                        block = None
                        bdur = None
                        has_ref = None  # BlockGroup: ReferenceBlock seen
                        if eid2 == ID_SIMPLE_BLOCK:
                            block = (b2, e2)
                        else:
                            has_ref = False
                            for eid3, b3, e3 in iter_elements(buf, b2, e2):
                                if eid3 == ID_BLOCK:
                                    block = (b3, e3)
                                elif eid3 == ID_BLOCK_DURATION:
                                    bdur = _uint(buf, b3, e3)
                                elif eid3 == ID_REFERENCE_BLOCK:
                                    has_ref = True
                        if block is None:
                            continue
                        parsed = parse_block(buf, *block)
                        if parsed is None:
                            continue
                        track_no, rel_ts, frames, key = parsed
                        if has_ref is not None:
                            # Block in a BlockGroup: keyframe iff no
                            # ReferenceBlock (lacing.rs keyframe handling).
                            key = not has_ref
                        if (track_no not in self._mkv_tracks
                                and track_no not in self._other_mkv_tracks):
                            continue
                        if frames:
                            blocks.append((track_no, cluster_ts + rel_ts,
                                           frames, bdur, key))
            elif eid == ID_CUES:
                self._parse_cues(buf, b, e)
            elif eid == ID_TAGS:
                # Defer: tag Targets reference track/chapter UIDs that may
                # be declared after this element.
                tags_spans.append((b, e))
            elif eid == ID_CHAPTERS:
                group, chapter_uids = parse_mkv_chapters(buf, b, e)
                if group:
                    self._chapters = group
            elif eid == ID_ATTACHMENTS:
                att = parse_mkv_attachments(buf, b, e)
                if att:
                    self._attachments = att

        if not self._mkv_tracks and not self._other_mkv_tracks:
            raise Unsupported("no supported tracks in Matroska")
        all_mkv_tracks = {**self._mkv_tracks, **self._other_mkv_tracks}
        is_video, track_uid_map = mkv_tag_scope(all_mkv_tracks,
                                                self._other_tracks)
        for tb, te in tags_spans:
            parse_mkv_tags(buf, tb, te, rev, is_video=is_video,
                           track_uid_map=track_uid_map,
                           chapter_uid_map=chapter_uids)
        if rev.tags or rev.track_tags:
            self._metadata.push(rev)

        self._timescale_ns = timescale_ns
        self._packets = _expand_blocks(blocks, all_mkv_tracks, timescale_ns)
        self._cursor = 0
        self._track_objs = []
        for no, t in sorted(self._mkv_tracks.items()):
            self._track_objs.append(
                Track(
                    id=no,
                    codec_params=t.params,
                    time_base=TimeBase(timescale_ns, 1_000_000_000),
                    duration=seg_duration,
                    language=t.language,
                    flags=t.flags,
                )
            )
        for tr in self._other_tracks:
            tr.time_base = TimeBase(timescale_ns, 1_000_000_000)
            tr.duration = seg_duration

    def _parse_cues(self, buf, b, e) -> None:
        """Cues element -> (time_ticks, cluster_pos) list (segment.rs)."""
        for eid, b2, e2 in iter_elements(buf, b, e):
            if eid != ID_CUE_POINT:
                continue
            cue_time = None
            cluster_pos = None
            for eid2, b3, e3 in iter_elements(buf, b2, e2):
                if eid2 == ID_CUE_TIME:
                    cue_time = _uint(buf, b3, e3)
                elif eid2 == ID_CUE_TRACK_POSITIONS:
                    for eid3, b4, e4 in iter_elements(buf, b3, e3):
                        if eid3 == ID_CUE_CLUSTER_POSITION:
                            cluster_pos = _uint(buf, b4, e4)
            if cue_time is not None and cluster_pos is not None:
                self._cues.append((cue_time, cluster_pos))




    # -- FormatReader ------------------------------------------------------

    def tracks(self) -> List[Track]:
        return self._track_objs

    def other_tracks(self) -> List[Track]:
        return self._other_tracks

    def next_packet(self) -> Optional[Packet]:
        if self._cursor >= len(self._packets):
            return None
        no, ts, dur, data, key = self._packets[self._cursor]
        self._cursor += 1
        return Packet(track_id=no, ts=ts, dur=dur, data=data, keyframe=key)

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = int(to.time.to_seconds() * 1_000_000_000 / self._timescale_ns)
        else:
            raise SeekError("no seek target")
        first = self._track_objs or self._other_tracks
        tid = first[0].id
        if to.track_id is not None and any(
                t.id == to.track_id for t in
                list(self._track_objs) + list(self._other_tracks)):
            tid = to.track_id
        # Bisect over the SEEK TRACK's packets only: the merged list is
        # cluster-ordered, and interleaved tracks (now including video)
        # make its global ts sequence non-monotonic — a global bisect on
        # an unsorted list lands arbitrarily.
        idxs = [i for i, p in enumerate(self._packets) if p[0] == tid]
        if not idxs:
            self._cursor = 0
            return SeekedTo(tid, ts, 0)
        keys = [self._packets[i][1] for i in idxs]
        import bisect

        j = max(0, bisect.bisect_right(keys, ts) - 1)
        self._cursor = idxs[j]
        return SeekedTo(tid, ts, keys[j])

    def cues(self) -> List[Tuple[int, int]]:
        """(time_ticks, cluster_pos) Cues entries (empty if none)."""
        return self._cues

    def packet_table(self, track_id: Optional[int] = None) -> PacketTable:
        if track_id is None:
            track_id = (self._track_objs or self._other_tracks)[0].id
        sel = [(ts, dur, d) for no, ts, dur, d, _k in self._packets
               if no == track_id]
        n = len(sel)
        return PacketTable(
            track_id=track_id,
            offsets=np.full(n, -1, dtype=np.int64),
            sizes=np.asarray([len(d) for _, _, d in sel], dtype=np.int64),
            ts=np.asarray([ts for ts, _, _ in sel], dtype=np.int64),
            dur=np.asarray([dur for _, dur, _ in sel], dtype=np.int64),
            trim_start=np.zeros(n, np.int32),
            trim_end=np.zeros(n, np.int32),
            data=[d for _, _, d in sel],
        )


_UNKNOWN_SIZE = object()


class MkvStreamReader(FormatReader):
    """Streamed Matroska reader: incremental EBML walk over the MSS window
    (segment.rs streamed / no-cues mode), O(window) memory, Cues-based seek
    when a SeekHead reveals them (demuxer.rs:345-462), forward cluster scan
    otherwise. Handles unknown-size segments/clusters (live streams)."""

    # Any single buffered element is bounded: a mutated size vint must
    # not make read_bytes buffer the whole remaining pipe (O(window)
    # promise). Real header/metadata elements and blocks sit far below
    # this; clusters/segments are walked, never buffered.
    _ELEM_CAP = 64 << 20

    def _read_body(self, size: int) -> bytes:
        if size > self._ELEM_CAP:
            raise DecodeError("mkv: element size exceeds stream bound")
        return self.mss.read_bytes(size)

    def __init__(self, mss, options: Optional[FormatOptions] = None):
        super().__init__(mss, options)
        self._metadata = MetadataLog()
        self._other_tracks: List[Track] = []
        self._other_mkv_tracks: Dict[int, MkvTrack] = {}
        self._queue: List[Packet] = []
        # One pending block per track for next-gap durations:
        # (ts, frames, block_dur|None, keyframe).
        self._pending: Dict[int, Tuple[int, List[bytes], Optional[int], bool]] = {}
        magic = mss.read_bytes(4)
        if magic != EBML_MAGIC:
            raise Unsupported("not an EBML stream")
        # Skip the EBML header body (its size is always coded).
        size, _ = self._read_vint_header()
        if size is _UNKNOWN_SIZE:
            raise Unsupported("unknown-size EBML header")
        mss.ignore_bytes(size)

        # Find the Segment element.
        eid, size = self._read_element()
        while eid is not None and eid != ID_SEGMENT:
            if size is _UNKNOWN_SIZE:
                raise Unsupported("unknown-size non-segment element")
            mss.ignore_bytes(size)
            eid, size = self._read_element()
        if eid is None:
            raise Unsupported("missing Matroska segment")
        self._segment_start = mss.pos()
        self._segment_end = (None if size is _UNKNOWN_SIZE
                             else self._segment_start + size)

        self._timescale_ns = 1_000_000
        self._seg_duration: Optional[int] = None  # Info Duration, ticks
        self._mkv_tracks: Dict[int, MkvTrack] = {}
        self._cues: List[Tuple[int, int]] = []
        cues_pos: Optional[int] = None
        self._first_cluster_pos: Optional[int] = None
        self._chapter_uids: Dict[int, object] = {}
        header_tag_bodies: List[bytes] = []
        info_title: Optional[str] = None

        # Header phase: walk top-level children until the first cluster.
        while True:
            pos = mss.pos()
            eid, size = self._read_element()
            if eid is None:
                break
            if eid == ID_CLUSTER:
                self._first_cluster_pos = pos
                self._cluster_end = (None if size is _UNKNOWN_SIZE
                                     else mss.pos() + size)
                self._cluster_ts = 0
                break
            if size is _UNKNOWN_SIZE:
                raise Unsupported("unknown-size header element")
            body = self._read_body(size)
            if eid == ID_INFO:
                for eid2, b2, e2 in iter_elements(body, 0, len(body)):
                    if eid2 == ID_TIMESTAMP_SCALE:
                        self._timescale_ns = (_uint(body, b2, e2)
                                              or self._timescale_ns)
                    elif eid2 == ID_SEG_DURATION:
                        d = _float(body, b2, e2)
                        if d and d > 0:
                            self._seg_duration = int(round(d))
                    elif eid2 == ID_TITLE:
                        info_title = body[b2:e2].decode("utf-8", "replace")
            elif eid == ID_TRACKS:
                self._parse_tracks(body)
            elif eid == ID_SEEK_HEAD:
                for eid2, b2, e2 in iter_elements(body, 0, len(body)):
                    if eid2 != ID_SEEK:
                        continue
                    sid = spos = None
                    for eid3, b3, e3 in iter_elements(body, b2, e2):
                        if eid3 == ID_SEEK_ID:
                            sid = _uint(body, b3, e3)
                        elif eid3 == ID_SEEK_POSITION:
                            spos = _uint(body, b3, e3)
                    if sid == ID_CUES and spos is not None:
                        cues_pos = self._segment_start + spos
            elif eid == ID_CUES:
                self._parse_cues_body(body)
            elif eid == ID_TAGS:
                # Defer past the header walk: Targets reference track /
                # chapter UIDs that may be declared later in the header.
                header_tag_bodies.append(body)
            elif eid == ID_CHAPTERS:
                group, self._chapter_uids = parse_mkv_chapters(
                    body, 0, len(body))
                if group:
                    self._chapters = group
            elif eid == ID_ATTACHMENTS:
                att = parse_mkv_attachments(body, 0, len(body))
                if att:
                    self._attachments = att
        if not self._mkv_tracks and not self._other_mkv_tracks:
            raise Unsupported("no supported tracks in Matroska")
        if header_tag_bodies or info_title:
            rev = MetadataRevision()
            if info_title:  # segment Title (bulk-reader parity)
                rev.tags.append(RawTag("title", info_title, "track_title"))
            is_video, uid_map = mkv_tag_scope(
                {**self._mkv_tracks, **self._other_mkv_tracks},
                self._other_tracks)
            for body in header_tag_bodies:
                parse_mkv_tags(body, 0, len(body), rev,
                               is_video=is_video,
                               track_uid_map=uid_map,
                               chapter_uid_map=self._chapter_uids)
            if rev.tags or rev.track_tags:
                self._metadata.push(rev)

        # Load Cues from the SeekHead pointer (seekable sources only).
        if cues_pos is not None and not self._cues and mss.is_seekable():
            back = mss.pos()
            try:
                mss.seek(cues_pos)
                eid, size = self._read_element()
                if eid == ID_CUES and size is not _UNKNOWN_SIZE:
                    self._parse_cues_body(self._read_body(size))
            except Exception:
                self._cues = []
            mss.seek(back)

        self._track_objs = [
            Track(id=no, codec_params=t.params,
                  time_base=TimeBase(self._timescale_ns, 1_000_000_000),
                  duration=self._seg_duration,
                  language=t.language, flags=t.flags)
            for no, t in sorted(self._mkv_tracks.items())
        ]
        for tr in self._other_tracks:
            tr.time_base = TimeBase(self._timescale_ns, 1_000_000_000)
            tr.duration = self._seg_duration

    # -- EBML over MSS -------------------------------------------------------

    def _read_vint_header(self):
        """Read a size vint from the MSS; returns (value|_UNKNOWN_SIZE, n)."""
        head = self.mss.peek_bytes(1)
        if not head or head[0] == 0:
            raise DecodeError("invalid EBML vint")
        length = 8 - head[0].bit_length() + 1
        raw = self.mss.read_bytes(length)
        val = raw[0] & ((1 << (8 - length)) - 1)
        for i in range(1, length):
            val = (val << 8) | raw[i]
        if val == (1 << (7 * length)) - 1:
            return _UNKNOWN_SIZE, length
        return val, length

    def _read_element(self):
        """Read (element_id, size|_UNKNOWN_SIZE) or (None, None) at EOF."""
        head = self.mss.peek_bytes(1)
        if not head:
            return None, None
        if head[0] == 0:
            raise DecodeError("invalid EBML element id")
        length = 8 - head[0].bit_length() + 1
        raw = self.mss.peek_bytes(length)
        if len(raw) < length:
            return None, None
        eid = 0
        for b in raw:
            eid = (eid << 8) | b
        self.mss.ignore_bytes(length)
        size, _ = self._read_vint_header()
        return eid, size

    def _parse_tracks(self, body: bytes) -> None:
        for eid2, b2, e2 in iter_elements(body, 0, len(body)):
            if eid2 != ID_TRACK_ENTRY:
                continue
            t, ttype = _parse_track_entry(body, b2, e2)
            if ttype == 2:
                _map_codec(t)
                if t.codec is not None:
                    self._mkv_tracks[t.number] = t
            else:
                op = _map_other_codec(t, ttype)
                if op is not None:
                    self._other_mkv_tracks[t.number] = t
                    self._other_tracks.append(
                        Track(id=t.number, codec_params=op,
                              language=t.language, flags=t.flags))

    def _parse_cues_body(self, body: bytes) -> None:
        for eid, b2, e2 in iter_elements(body, 0, len(body)):
            if eid != ID_CUE_POINT:
                continue
            cue_time = cluster_pos = None
            for eid2, b3, e3 in iter_elements(body, b2, e2):
                if eid2 == ID_CUE_TIME:
                    cue_time = _uint(body, b3, e3)
                elif eid2 == ID_CUE_TRACK_POSITIONS:
                    for eid3, b4, e4 in iter_elements(body, b3, e3):
                        if eid3 == ID_CUE_CLUSTER_POSITION:
                            cluster_pos = _uint(body, b4, e4)
            if cue_time is not None and cluster_pos is not None:
                self._cues.append((cue_time, cluster_pos))

    # -- cluster walk --------------------------------------------------------

    def _flush_pending(self, no: int, next_ts: Optional[int]) -> None:
        """Emit a track's held-back block; its duration is the gap to the
        next block (or BlockDuration / DefaultDuration)."""
        held = self._pending.pop(no, None)
        if held is None:
            return
        ts, frames, bdur, key = held
        if bdur is None and next_ts is not None and next_ts > ts:
            bdur = next_ts - ts
        t = self._mkv_tracks.get(no) or self._other_mkv_tracks.get(no)
        if bdur is None and t is not None and t.default_duration_ns:
            bdur = max(1, round(t.default_duration_ns * len(frames)
                                / self._timescale_ns))
        if bdur is None:
            bdur = 0
        fdur = bdur // len(frames)
        for k, f in enumerate(frames):
            self._queue.append(Packet(track_id=no, ts=ts + k * fdur,
                                      dur=fdur, data=f, keyframe=key))

    def _absorb_block(self, raw: bytes, bdur: Optional[int],
                      has_ref: Optional[bool] = None) -> None:
        parsed = parse_block(raw, 0, len(raw))
        if parsed is None:
            return  # truncated/malformed block
        track_no, rel_ts, frames, key = parsed
        if has_ref is not None:
            key = not has_ref  # BlockGroup: keyframe iff no ReferenceBlock
        if (track_no not in self._mkv_tracks
                and track_no not in self._other_mkv_tracks):
            return
        if not frames:
            return
        ts = self._cluster_ts + rel_ts
        self._flush_pending(track_no, ts)
        self._pending[track_no] = (ts, frames, bdur, key)

    def _advance(self) -> bool:
        """Read one element of the current cluster (or enter the next
        cluster). False at end of stream."""
        if self._first_cluster_pos is None:
            return False
        pos = self.mss.pos()
        if self._segment_end is not None and pos >= self._segment_end:
            return False
        if self._cluster_end is not None and pos >= self._cluster_end:
            self._cluster_end = None  # expect a new top-level element
        from ..core.errors import EndOfStream

        try:
            eid, size = self._read_element()
            if eid is None:
                return False
            if eid == ID_CLUSTER:
                self._cluster_end = (None if size is _UNKNOWN_SIZE
                                     else self.mss.pos() + size)
                self._cluster_ts = 0
                return True
            if size is _UNKNOWN_SIZE:
                return False
            if eid == ID_CLUSTER_TIMESTAMP:
                self._cluster_ts = _uint(self._read_body(size), 0, size)
                return True
            if eid == ID_SIMPLE_BLOCK:
                self._absorb_block(self._read_body(size), None)
                return True
            if eid == ID_BLOCK_GROUP:
                body = self._read_body(size)
                block = bdur = None
                has_ref = False
                for eid2, b2, e2 in iter_elements(body, 0, len(body)):
                    if eid2 == ID_BLOCK:
                        block = body[b2:e2]
                    elif eid2 == ID_BLOCK_DURATION:
                        bdur = _uint(body, b2, e2)
                    elif eid2 == ID_REFERENCE_BLOCK:
                        has_ref = True
                if block is not None:
                    self._absorb_block(block, bdur, has_ref)
                return True
            if eid in (ID_TAGS, ID_CHAPTERS, ID_ATTACHMENTS):
                # Trailing metadata in streamed mode: parse in place (the
                # bulk reader's element parsers only need a body buffer).
                body = self._read_body(size)
                if eid == ID_TAGS:
                    rev = MetadataRevision()
                    is_video, uid_map = mkv_tag_scope(
                        {**self._mkv_tracks, **self._other_mkv_tracks},
                        self._other_tracks)
                    parse_mkv_tags(
                        body, 0, len(body), rev,
                        is_video=is_video, track_uid_map=uid_map,
                        chapter_uid_map=getattr(self, "_chapter_uids", None))
                    if rev.tags or rev.track_tags:
                        self._metadata.push(rev)
                elif eid == ID_CHAPTERS:
                    group, self._chapter_uids = parse_mkv_chapters(
                        body, 0, len(body))
                    if group:
                        self._chapters = group
                else:
                    att = parse_mkv_attachments(body, 0, len(body))
                    if att:
                        self._attachments = att
                return True
            # Any other element (incl. a trailing Cues): skip its body.
            self.mss.ignore_bytes(size)
            return True
        except (DecodeError, EndOfStream):
            # Truncated element: treat as end of stream (the reference's
            # streamed mode ends at the last complete block).
            return False

    # -- FormatReader ----------------------------------------------------------

    def tracks(self) -> List[Track]:
        return self._track_objs

    def other_tracks(self) -> List[Track]:
        return self._other_tracks

    def next_packet(self) -> Optional[Packet]:
        while not self._queue:
            if not self._advance():
                # EOS: flush held-back blocks (durations fall back to
                # DefaultDuration).
                for no in list(self._pending):
                    self._flush_pending(no, None)
                if not self._queue:
                    return None
                break
        return self._queue.pop(0)

    def cues(self) -> List[Tuple[int, int]]:
        return self._cues

    def seek(self, mode: str, to: SeekTo) -> SeekedTo:
        if to.ts is not None:
            ts = to.ts
        elif to.time is not None:
            ts = int(to.time.to_seconds() * 1_000_000_000 / self._timescale_ns)
        else:
            raise SeekError("no seek target")
        if not self.mss.is_seekable():
            raise SeekError("source is not seekable")
        if self._first_cluster_pos is None:
            raise SeekError("no clusters")
        # Cues: jump to the last cue point at or before the target.
        target_pos = self._first_cluster_pos
        actual = 0
        if self._cues:
            import bisect

            times = [c[0] for c in self._cues]
            i = max(0, bisect.bisect_right(times, ts) - 1)
            target_pos = self._segment_start + self._cues[i][1]
            actual = self._cues[i][0]
        self.mss.seek(target_pos)
        self._queue.clear()
        self._pending.clear()
        self._cluster_end = None
        self._cluster_ts = 0
        # Forward scan within/after the landing cluster up to the target.
        # (No-cues mode degenerates to a forward scan from the first
        # cluster, demuxer.rs:345-462.)
        while True:
            while not self._queue:
                if not self._advance():
                    break
            if not self._queue:
                break
            p = self._queue[0]
            if p.ts + max(p.dur, 0) > ts or p.ts >= ts:
                break
            self._queue.pop(0)
        first = self._track_objs or self._other_tracks
        return SeekedTo(first[0].id, ts,
                        self._queue[0].ts if self._queue else actual)


def _make_mkv_reader(mss, options: Optional[FormatOptions] = None):
    """Probe factory: read-all table for seekable sources, incremental
    streamed reader for pipes."""
    if mss.is_seekable():
        return MkvReader(mss, options)
    return MkvStreamReader(mss, options)


def _score(context: bytes) -> int:
    return 255 if context.startswith(EBML_MAGIC) else 0


DESCRIPTOR = Descriptor(
    name="mkv",
    markers=[EBML_MAGIC],
    factory=_make_mkv_reader,
    score=_score,
)
