"""ID3v2.2/2.3/2.4 metadata reader.

Analog of symphonia-metadata/src/id3v2/ (id3v2/mod.rs:703: header/extended
header/unsynchronisation (unsync.rs), frames.rs + frames/readers.rs frame
parsing incl. TXXX/COMM/APIC/USLT/POPM/CHAP, v2.2 3-char frame ids).
Registered as a probeable metadata reader so leading ID3v2 tags are consumed
before container probing (probe.rs:475).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from ..core.errors import DecodeError
from ..core.meta import (
    Chapter,
    MetadataOptions,
    MetadataReader,
    MetadataRevision,
    RawTag,
    StandardTagKey as K,
    Visual,
)
from ..core.probe import Descriptor

ID3V2_MARKER = b"ID3"

# v2.3/2.4 frame id -> standard key + value parsers: the full frames.rs
# readers map now lives in std_tag.py (ID3V2_MAP / ID3V2_TXXX_MAP).
from .std_tag import ID3V2_MAP, ID3V2_TXXX_MAP, map_raw  # noqa: E402

# TIPL/TMCL involved-people roles -> standard keys (readers.rs TIPL map).
_IPL_ROLES = {
    "arranger": K.ARRANGER, "engineer": K.ENGINEER, "dj-mix": K.MIX_DJ,
    "mix": K.MIX_ENGINEER, "producer": K.PRODUCER,
}

# v2.2 three-char frame id -> v2.3 equivalent.
FRAME_MAP_V2 = {
    "TAL": "TALB", "TBP": "TBPM", "TCM": "TCOM", "TCO": "TCON",
    "TCR": "TCOP", "TDA": "TDAT", "TEN": "TENC", "TT1": "TIT1",
    "TT2": "TIT2", "TT3": "TIT3", "TLA": "TLAN", "TOA": "TOPE",
    "TP1": "TPE1", "TP2": "TPE2", "TP3": "TPE3", "TP4": "TPE4",
    "TPA": "TPOS", "TPB": "TPUB", "TRK": "TRCK", "TYE": "TYER",
    "TXT": "TEXT", "TSS": "TSSE", "TOT": "TOAL", "TOR": "TORY",
    "COM": "COMM", "PIC": "APIC", "ULT": "USLT", "TXX": "TXXX",
    "POP": "POPM",
}


def read_syncsafe_u32(data: bytes, pos: int) -> int:
    """28-bit syncsafe integer (id3v2/mod.rs header size coding)."""
    b = data[pos : pos + 4]
    if any(x & 0x80 for x in b):
        raise DecodeError("invalid syncsafe integer")
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def unsynchronise(data: bytes) -> bytes:
    """Reverse unsynchronisation: FF 00 -> FF (unsync.rs:210)."""
    return data.replace(b"\xff\x00", b"\xff")


def decode_text(encoding: int, data: bytes) -> str:
    try:
        if encoding == 0:
            return data.decode("latin-1")
        if encoding == 1:
            return data.decode("utf-16")
        if encoding == 2:
            return data.decode("utf-16-be")
        return data.decode("utf-8")
    except UnicodeDecodeError:
        return data.decode("latin-1", "replace")


def split_terminated(encoding: int, data: bytes) -> Tuple[bytes, bytes]:
    """Split at the encoding-appropriate null terminator."""
    if encoding in (1, 2):
        for i in range(0, len(data) - 1, 2):
            if data[i] == 0 and data[i + 1] == 0:
                return data[:i], data[i + 2 :]
        return data, b""
    i = data.find(b"\x00")
    if i < 0:
        return data, b""
    return data[:i], data[i + 1 :]


def _parse_genre(text: str) -> str:
    """Resolve '(NN)' genre references via the ID3v1 genre list."""
    from .id3v1 import GENRES

    t = text.strip()
    if t.startswith("(") and ")" in t:
        try:
            n = int(t[1 : t.index(")")])
            if n < len(GENRES):
                return GENRES[n]
        except ValueError:
            pass
    if t.isdigit() and int(t) < len(GENRES):
        return GENRES[int(t)]
    return text


class Id3v2Reader(MetadataReader):
    """ID3v2 tag reader (id3v2/mod.rs)."""

    def read_all(self, reader) -> Optional[MetadataRevision]:
        header = reader.read_bytes(10)
        if header[:3] != ID3V2_MARKER:
            raise DecodeError("not an ID3v2 tag")
        major, _minor = header[3], header[4]
        flags = header[5]
        size = read_syncsafe_u32(header, 6)
        if major not in (2, 3, 4):
            reader.ignore_bytes(size)
            return None
        body = reader.read_bytes(size)
        if flags & 0x10:  # footer present (v2.4)
            reader.ignore_bytes(10)

        whole_unsync = bool(flags & 0x80) and major <= 3
        if whole_unsync:
            body = unsynchronise(body)

        pos = 0
        # Extended header.
        if flags & 0x40:
            if major == 3:
                ext = struct.unpack(">I", body[0:4])[0]
                pos = 4 + ext
            else:
                pos = read_syncsafe_u32(body, 0)

        rev = MetadataRevision()
        while pos + (6 if major == 2 else 10) <= len(body):
            if major == 2:
                fid = body[pos : pos + 3]
                if fid == b"\x00\x00\x00":
                    break
                fsize = int.from_bytes(body[pos + 3 : pos + 6], "big")
                fflags = 0
                pos += 6
            else:
                fid = body[pos : pos + 4]
                if fid == b"\x00\x00\x00\x00":
                    break
                if major == 4:
                    fsize = read_syncsafe_u32(body, pos + 4)
                else:
                    fsize = struct.unpack(">I", body[pos + 4 : pos + 8])[0]
                fflags = struct.unpack(">H", body[pos + 8 : pos + 10])[0]
                pos += 10
            if fsize > len(body) - pos:
                # Oversized declared frame: a framing error (frames.rs
                # read_boxed_slice_exact failure). Stop rather than slice
                # short and keep parsing from a desynced offset.
                break
            payload = body[pos : pos + fsize]
            pos += fsize
            # v2.3/v2.4 frame-flag machinery (frames.rs:511-560 / :594-718):
            # compressed/encrypted/grouped/data-length-indicator fields
            # precede the body; compressed frames are skipped (no DEFLATE,
            # like the reference), encrypted frames surface as binary tags,
            # and group/encryption ids become tag sub-fields.
            group_id = enc_id = None
            encrypted = False
            if major == 3 and fflags:
                if fflags & 0x1F1F:
                    break  # unused flag bits set: framing error
                comp = fflags & 0x80
                encrypted = bool(fflags & 0x40)
                grouped = fflags & 0x20
                need = ((4 if comp else 0) + (1 if encrypted else 0)
                        + (1 if grouped else 0))
                if fsize < need:
                    break  # frame too small for its extended header
                off = 4 if comp else 0  # decompressed size (unused)
                if encrypted:
                    enc_id = payload[off]
                    off += 1
                if grouped:
                    group_id = payload[off]
                    off += 1
                payload = payload[off:]
                if comp:
                    continue  # skip-with-warning semantics
            elif major == 4 and fflags:
                if fflags & 0x8FB0:
                    break  # unused flag bits set: framing error
                grouped = fflags & 0x40
                comp = fflags & 0x08
                encrypted = bool(fflags & 0x04)
                frame_unsync = fflags & 0x02
                has_dli = fflags & 0x01
                if comp and not has_dli:
                    break  # compressed frames require a DLI
                need = ((1 if grouped else 0) + (1 if encrypted else 0)
                        + (4 if has_dli else 0))
                if fsize < need:
                    break
                off = 0
                if grouped:
                    group_id = payload[off]
                    off += 1
                if encrypted:
                    enc_id = payload[off]
                    off += 1
                if has_dli:
                    off += 4  # original size (unused)
                payload = payload[off:]
                if comp:
                    continue
                if frame_unsync:
                    # Per-frame unsync applies to the body only, after the
                    # extended flag fields.
                    payload = unsynchronise(payload)
            n_tags = len(rev.tags)
            try:
                if encrypted:
                    # Encryption is vendor-specific: surface the frame as
                    # an opaque binary tag (frames.rs null_frame_reader).
                    if payload:
                        rev.tags.append(RawTag(fid.decode("latin-1"),
                                               payload))
                else:
                    self._parse_frame(
                        fid.decode("latin-1"), payload, major, rev
                    )
            except (DecodeError, IndexError, struct.error, UnicodeError):
                continue
            if group_id is not None or enc_id is not None:
                for t in rev.tags[n_tags:]:
                    sf = dict(t.sub_fields or {})
                    if group_id is not None:
                        sf["group_id"] = group_id
                    if enc_id is not None:
                        sf["encryption_method_id"] = enc_id
                    t.sub_fields = sf
        return rev

    def _parse_frame(self, fid: str, payload: bytes, major: int, rev: MetadataRevision) -> None:
        if major == 2:
            fid = FRAME_MAP_V2.get(fid, fid)
        if not payload:
            return
        if fid == "TXXX":
            enc = payload[0]
            desc, rest = split_terminated(enc, payload[1:])
            desc_text = decode_text(enc, desc)
            mapped = map_raw(desc_text, decode_text(enc, rest), ID3V2_TXXX_MAP)
            for t in mapped:
                t.key = "TXXX:" + desc_text
            rev.tags.extend(mapped)
        elif fid in ("TIPL", "TMCL", "IPLS"):
            # Involved-people / musician-credits pairs (readers.rs TIPL):
            # null-separated (role, person) pairs; known TIPL roles map to
            # standard keys, TMCL roles are instruments -> performer.
            enc = payload[0]
            text = decode_text(enc, payload[1:]).rstrip("\x00")
            parts = text.split("\x00")
            for i in range(0, len(parts) - 1, 2):
                role, person = parts[i], parts[i + 1]
                if not person:
                    continue
                std = (K.PERFORMER if fid == "TMCL"
                       else _IPL_ROLES.get(role.lower()))
                rev.tags.append(RawTag(f"{fid}:{role}", person, std))
        elif fid.startswith("T"):
            enc = payload[0]
            # v2.4 allows multiple null-separated values; join with '/'.
            text = decode_text(enc, payload[1:]).rstrip("\x00")
            text = "/".join(v for v in text.split("\x00") if v) or text
            if fid == "TCON":
                text = _parse_genre(text)
            rev.tags.extend(map_raw(fid, text, ID3V2_MAP))
        elif fid == "UFID":
            # Unique file identifier (readers.rs UFID): owner URL + binary
            # id; the MusicBrainz owner carries the recording id as text.
            owner, ident = split_terminated(0, payload)
            owner_text = owner.decode("latin-1", "replace")
            if "musicbrainz.org" in owner_text:
                rev.tags.append(RawTag("UFID:" + owner_text,
                                       ident.decode("utf-8", "replace"),
                                       K.MUSICBRAINZ_RECORDING_ID))
            else:
                rev.tags.append(RawTag("UFID:" + owner_text, ident))
        elif fid == "MCDI":
            rev.tags.append(RawTag("MCDI", payload, K.CD_TOC))
        elif fid == "PCNT":
            n = int.from_bytes(payload, "big")
            rev.tags.append(RawTag("PCNT", n, K.PLAY_COUNTER))
        elif fid == "PRIV":
            owner, data = split_terminated(0, payload)
            rev.tags.append(
                RawTag("PRIV:" + owner.decode("latin-1", "replace"), data))
        elif fid == "GEOB":
            # General encapsulated object: mime, filename, description,
            # then the object bytes (readers.rs GEOB).
            enc = payload[0]
            mime, rest = split_terminated(0, payload[1:])
            fname, rest = split_terminated(enc, rest)
            desc, data = split_terminated(enc, rest)
            rev.tags.append(
                RawTag("GEOB:" + decode_text(enc, desc), data))
        elif fid == "RVA2":
            # Relative volume adjustment v2: identification string, then
            # (channel, s16 adjustment in 1/512 dB, peak) records.
            ident, rest = split_terminated(0, payload)
            if len(rest) >= 3:
                adj = struct.unpack(">h", rest[1:3])[0] / 512.0
                rev.tags.append(
                    RawTag("RVA2:" + ident.decode("latin-1", "replace"),
                           f"{adj:+.2f} dB"))
        elif fid == "SYLT":
            # Synchronized lyrics (frames/readers.rs SYLT): text chunks each
            # followed by a 32-bit timestamp; joined in time order.
            enc = payload[0]
            _lang = payload[1:4]
            _fmt, _ctype = payload[4], payload[5]
            _desc, rest = split_terminated(enc, payload[6:])
            parts = []
            while rest:
                text, rest = split_terminated(enc, rest)
                if len(rest) < 4:
                    break
                ts = struct.unpack(">I", rest[:4])[0]
                rest = rest[4:]
                parts.append((ts, decode_text(enc, text)))
            if parts:
                rev.tags.append(
                    RawTag("SYLT",
                           "\n".join(t for _, t in sorted(parts)), K.LYRICS)
                )
        elif fid == "COMM" or fid == "USLT":
            enc = payload[0]
            _lang = payload[1:4]
            desc, rest = split_terminated(enc, payload[4:])
            std = K.COMMENT if fid == "COMM" else K.LYRICS
            rev.tags.append(RawTag(fid, decode_text(enc, rest), std))
        elif fid == "APIC":
            enc = payload[0]
            if major == 2:
                mime = payload[1:4].decode("latin-1")
                pic_type = payload[4]
                desc, data = split_terminated(enc, payload[5:])
            else:
                mime_b, rest = split_terminated(0, payload[1:])
                mime = mime_b.decode("latin-1")
                pic_type = rest[0]
                desc, data = split_terminated(enc, rest[1:])
            usage = {3: "front_cover", 4: "back_cover"}.get(pic_type)
            if not mime:
                from ..core.meta import sniff_image

                mime = sniff_image(data)
            rev.visuals.append(
                Visual(media_type=mime or None, data=data, usage=usage)
            )
        elif fid == "CHAP":
            # Chapter frame (id3v2/mod.rs:415): element id, start/end ms,
            # byte offsets, then embedded sub-frames (e.g. TIT2 title).
            elem, rest = split_terminated(0, payload)
            if len(rest) >= 16:
                start_ms = struct.unpack(">I", rest[0:4])[0]
                end_ms = struct.unpack(">I", rest[4:8])[0]
                title = None
                sub = rest[16:]
                pos2 = 0
                while pos2 + 10 <= len(sub):
                    sid = sub[pos2 : pos2 + 4]
                    if major == 4:
                        ssize = read_syncsafe_u32(sub, pos2 + 4)
                    else:
                        ssize = struct.unpack(">I", sub[pos2 + 4 : pos2 + 8])[0]
                    body2 = sub[pos2 + 10 : pos2 + 10 + ssize]
                    if sid == b"TIT2" and body2:
                        title = decode_text(body2[0], body2[1:]).rstrip("\x00")
                    pos2 += 10 + ssize
                elem_id = elem.decode("latin-1", "replace")
                rev.tags.append(RawTag("CHAP", elem_id))
                chapters = getattr(rev, "_chapters", None)
                if chapters is None:
                    chapters = []
                    setattr(rev, "_chapters", chapters)
                ch = Chapter(start_time=start_ms / 1000.0,
                             end_time=end_ms / 1000.0 if end_ms != 0xFFFFFFFF else None,
                             title=title)
                ch.tags.append(RawTag("element_id", elem_id))
                chapters.append(ch)
        elif fid == "CTOC":
            # Table-of-contents frame: element id, flags, child element ids
            # (id3v2/mod.rs:415). Reorders CHAP chapters to TOC order.
            elem, rest = split_terminated(0, payload)
            if len(rest) >= 2:
                count = rest[1]
                ids = []
                p2 = 2
                for _ in range(count):
                    cid, tail = split_terminated(0, rest[p2:])
                    ids.append(cid.decode("latin-1", "replace"))
                    p2 = len(rest) - len(tail)
                rev.tags.append(
                    RawTag("CTOC", "/".join(ids))
                )
                setattr(rev, "_toc_order", ids)
                chapters = getattr(rev, "_chapters", None)
                if chapters:
                    by_id = {
                        t.value: c for c in chapters
                        for t in c.tags if t.key == "element_id"
                    }
                    if all(i in by_id for i in ids):
                        chapters[:] = [by_id[i] for i in ids]
        elif fid == "POPM":
            email, rest = split_terminated(0, payload)
            if rest:
                rev.tags.append(RawTag("POPM", str(rest[0]), K.RATING))
        elif fid == "WXXX":
            enc = payload[0]
            desc, rest = split_terminated(enc, payload[1:])
            rev.tags.append(RawTag("WXXX", rest.decode("latin-1", "replace"), K.URL))
        elif fid.startswith("W"):
            url = payload.split(b"\x00")[0].decode("latin-1", "replace")
            mapped = map_raw(fid, url, ID3V2_MAP)
            if mapped[0].std_key is None:
                mapped[0].std_key = K.URL
            rev.tags.extend(mapped)
        else:
            rev.tags.append(RawTag(fid, payload))


DESCRIPTOR = Descriptor(
    name="id3v2",
    markers=[ID3V2_MARKER],
    factory=Id3v2Reader,
    is_metadata=True,
)
