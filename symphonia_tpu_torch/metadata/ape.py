"""APEv1/v2 metadata reader.

Analog of symphonia-metadata/src/ape.rs (534 LoC): the 32-byte
``APETAGEX`` footer anchored at EOF-32 (or EOF-160 when an ID3v1 tag
follows), item list of (size, flags, key\\0, value) entries with text or
binary (cover art) values.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..core.errors import DecodeError
from ..core.meta import MetadataReader, MetadataRevision, RawTag, Visual
from ..core.probe import Descriptor
from .std_tag import APE_MAP, map_raw

APE_MARKER = b"APETAGEX"

class ApeReader(MetadataReader):
    """APE tag reader (ape.rs). ``read_all`` expects the stream positioned
    at the tag footer (as arranged by the probe's trailing anchor)."""

    def read_all(self, reader) -> Optional[MetadataRevision]:
        footer = reader.read_bytes(32)
        if footer[:8] != APE_MARKER:
            raise DecodeError("not an APE tag footer")
        version, tag_size, item_count, flags = struct.unpack("<IIII", footer[8:24])
        if version not in (1000, 2000):
            raise DecodeError(f"unsupported APE version {version}")
        # tag_size covers items + footer (not the optional header).
        # Seek back to the first item.
        if tag_size < 32:
            raise DecodeError("APE tag size too small")
        pos = reader.pos() - 32
        items_start = pos + 32 - tag_size
        if items_start < 0:
            raise DecodeError("APE tag size exceeds stream")
        reader.seek(items_start)
        body = reader.read_bytes(tag_size - 32)

        rev = MetadataRevision()
        off = 0
        for _ in range(item_count):
            if off + 8 > len(body):
                break
            vsize, iflags = struct.unpack_from("<II", body, off)
            off += 8
            end = body.find(b"\x00", off)
            if end < 0:
                break
            key = body[off : end].decode("utf-8", "replace")
            off = end + 1
            value = body[off : off + vsize]
            off += vsize
            kind = (iflags >> 1) & 0x3
            lk = key.lower()
            if kind == 1 or lk.startswith("cover art"):
                # Binary: cover art is "filename\0imagedata".
                z = value.find(b"\x00")
                img = value[z + 1 :] if z >= 0 else value
                rev.visuals.append(Visual(media_type=None, data=img,
                                          usage="front_cover" if "front" in lk else None))
            else:
                text = value.decode("utf-8", "replace")
                rev.tags.extend(map_raw(key, text, APE_MAP))
        return rev


DESCRIPTOR = Descriptor(
    name="ape",
    markers=[APE_MARKER],
    factory=ApeReader,
    is_metadata=True,
    trailing_anchor=(-32, APE_MARKER),
)

# A second anchor for APE preceding an ID3v1 tag (probe.rs:90-102 checks
# multiple end anchors).
DESCRIPTOR_BEFORE_ID3V1 = Descriptor(
    name="ape@-160",
    markers=[APE_MARKER],
    factory=ApeReader,
    is_metadata=True,
    trailing_anchor=(-160, APE_MARKER),
)
