"""A minimal EBML (Matroska) muxer for decoder tests: ``vint_size``,
``elem``, ``uint_elem``, ``float_elem``, ``simple_block``, ``build_mkv``,
the tag elements ``targets_elem``, ``simple_tag``, ``tag_elem`` and
``tags_elem``, and the blocks ``_sb_flags`` (a SimpleBlock with its flags
byte) and ``_block_group`` of ``tests/test_mkv.py``, copied."""

import struct


def vint_size(v: int) -> bytes:
    """Encode an EBML data size."""
    for length in range(1, 9):
        if v < (1 << (7 * length)) - 1:
            out = v | (1 << (7 * length))
            return out.to_bytes(length, "big")
    raise ValueError


def elem(eid: int, payload: bytes) -> bytes:
    eid_bytes = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    return eid_bytes + vint_size(len(payload)) + payload


def uint_elem(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return elem(eid, v.to_bytes(n, "big"))


def float_elem(eid: int, v: float) -> bytes:
    return elem(eid, struct.pack(">d", v))


def simple_block(track: int, rel_ts: int, frames, lacing=0) -> bytes:
    body = bytes([0x80 | track]) + struct.pack(">h", rel_ts)
    if lacing == 0:
        assert len(frames) == 1
        body += bytes([0x00]) + frames[0]
    elif lacing == 1:  # Xiph
        body += bytes([0x02, len(frames) - 1])
        for f in frames[:-1]:
            n = len(f)
            while n >= 255:
                body += bytes([255])
                n -= 255
            body += bytes([n])
        body += b"".join(frames)
    elif lacing == 2:  # fixed
        body += bytes([0x04, len(frames) - 1]) + b"".join(frames)
    return elem(0xA3, body)


def build_mkv(codec_id: str, private: bytes, blocks, rate=44100, ch=1,
              bit_depth=None, tags=None, extra_segment=b"",
              timescale=1_000_000, track_extra=b"", info_extra=b"") -> bytes:
    ebml_hdr = elem(0x1A45DFA3,
                    elem(0x4282, b"matroska") + uint_elem(0x4287, 4))
    track_entry = (
        uint_elem(0xD7, 1) + uint_elem(0x83, 2)
        + elem(0x86, codec_id.encode())
        + (elem(0x63A2, private) if private else b"")
        + elem(0xE1, float_elem(0xB5, float(rate)) + uint_elem(0x9F, ch)
               + (uint_elem(0x6264, bit_depth) if bit_depth else b""))
        + track_extra
    )
    tracks = elem(0x1654AE6B, elem(0xAE, track_entry))
    info = elem(0x1549A966, uint_elem(0x2AD7B1, timescale) + info_extra)
    clusters = b""
    for cluster_ts, cluster_blocks in blocks:
        body = uint_elem(0xE7, cluster_ts)
        for blk in cluster_blocks:
            body += blk
        clusters += elem(0x1F43B675, body)
    tags_data = b""
    if tags:
        simple_tags = b""
        for k, v in tags.items():
            simple_tags += elem(0x67C8, elem(0x45A3, k.encode()) + elem(0x4487, v.encode()))
        tags_data = elem(0x1254C367, elem(0x7373, simple_tags))
    segment = elem(0x18538067, info + tracks + clusters + tags_data
                   + extra_segment)
    return ebml_hdr + segment


def targets_elem(level=None, name=None, track_uids=(), chapter_uids=()):
    body = b""
    if level is not None:
        body += uint_elem(0x68CA, level)
    if name:
        body += elem(0x63CA, name.encode())
    for u in track_uids:
        body += uint_elem(0x63C5, u)
    for u in chapter_uids:
        body += uint_elem(0x63C4, u)
    return elem(0x63C0, body)


def simple_tag(name, value=None, subs=b""):
    body = elem(0x45A3, name.encode())
    if value is not None:
        body += elem(0x4487, value.encode())
    return elem(0x67C8, body + subs)


def tag_elem(simple_tags, targets=b""):
    return elem(0x7373, targets + b"".join(simple_tags))


def tags_elem(*tag_elems):
    return elem(0x1254C367, b"".join(tag_elems))


def _sb_flags(track: int, rel_ts: int, frame: bytes, flags: int) -> bytes:
    """SimpleBlock with an explicit flags byte (0x80 = keyframe)."""
    body = bytes([0x80 | track]) + struct.pack(">h", rel_ts) \
        + bytes([flags]) + frame
    return elem(0xA3, body)


def _block_group(track: int, rel_ts: int, frame: bytes, bdur=None,
                 ref=None) -> bytes:
    """BlockGroup: Block (+ BlockDuration, + ReferenceBlock)."""
    blk = bytes([0x80 | track]) + struct.pack(">h", rel_ts) + b"\x00" + frame
    payload = elem(0xA1, blk)
    if bdur is not None:
        payload += uint_elem(0x9B, bdur)
    if ref is not None:
        payload += elem(0xFB, struct.pack(">b", ref))
    return elem(0xA0, payload)
