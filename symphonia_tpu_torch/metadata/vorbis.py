"""Vorbis comment metadata parsing.

Analog of symphonia-metadata/src/embedded/vorbis.rs: vendor + KEY=VALUE user
comments with standard-tag mapping (utils/std_tag.rs) and the base64
METADATA_BLOCK_PICTURE -> Visual path. Shared by FLAC (VORBIS_COMMENT
metadata block) and OGG Vorbis/FLAC/Opus identification headers.
"""

from __future__ import annotations

import base64
import struct
from typing import Optional

from ..core.meta import MetadataRevision, RawTag, StandardTagKey as K, Visual

# Vorbis comment key -> standard tag mapping now lives in std_tag.py
# (utils/std_tag.rs full map + value parsers).
from .std_tag import VORBIS_MAP, map_raw  # noqa: E402


def parse_flac_picture(data: bytes) -> Optional[Visual]:
    """FLAC PICTURE block (embedded/flac.rs Picture; also the payload of
    METADATA_BLOCK_PICTURE vorbis comments). All fields big-endian."""
    try:
        pos = 0
        (pic_type,) = struct.unpack_from(">I", data, pos)
        pos += 4
        (mlen,) = struct.unpack_from(">I", data, pos)
        pos += 4
        mime = data[pos : pos + mlen].decode("utf-8", "replace")
        pos += mlen
        (dlen,) = struct.unpack_from(">I", data, pos)
        pos += 4
        desc = data[pos : pos + dlen].decode("utf-8", "replace")
        pos += dlen
        width, height, _depth, _colors, plen = struct.unpack_from(">IIIII", data, pos)
        pos += 20
        payload = data[pos : pos + plen]
        usage = "front_cover" if pic_type == 3 else ("back_cover" if pic_type == 4 else None)
        tags = [RawTag("description", desc)] if desc else []
        return Visual(
            media_type=mime or None,
            data=payload,
            usage=usage,
            dimensions=(width, height) if width and height else None,
            tags=tags,
        )
    except (struct.error, IndexError):
        return None


def parse_vorbis_comment(data: bytes, framing_bit: bool = False) -> MetadataRevision:
    """Parse a Vorbis comment block (embedded/vorbis.rs). Truncated or
    length-corrupted blocks raise DecodeError (never struct.error)."""
    from ..core.errors import DecodeError

    rev = MetadataRevision()
    pos = 0
    if len(data) < 4:
        raise DecodeError("truncated vorbis comment")
    (vlen,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if pos + vlen + 4 > len(data):
        raise DecodeError("vorbis comment vendor length exceeds block")
    rev.vendor = data[pos : pos + vlen].decode("utf-8", "replace")
    pos += vlen
    (count,) = struct.unpack_from("<I", data, pos)
    pos += 4
    for _ in range(count):
        if pos + 4 > len(data):
            break
        (clen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        comment = data[pos : pos + clen]
        pos += clen
        eq = comment.find(b"=")
        if eq < 0:
            continue
        key = comment[:eq].decode("utf-8", "replace")
        val_raw = comment[eq + 1 :]
        lk = key.lower()
        if lk == "metadata_block_picture":
            try:
                vis = parse_flac_picture(base64.b64decode(val_raw))
                if vis is not None:
                    rev.visuals.append(vis)
                continue
            except Exception:
                pass
        val = val_raw.decode("utf-8", "replace")
        rev.tags.extend(map_raw(key, val, VORBIS_MAP))
    return rev
