"""An ID3v2 tag writer for decoder tests: ``syncsafe``, ``build_id3v2`` and
``text_frame`` of ``tests/test_metadata.py``, copied."""

import struct


def syncsafe(n: int) -> bytes:
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])


def build_id3v2(frames, major=4, unsync=False) -> bytes:
    body = b""
    for entry in frames:
        fid, payload = entry[0], entry[1]
        fflags = entry[2] if len(entry) > 2 else 0
        if major == 2:
            body += fid.encode() + len(payload).to_bytes(3, "big") + payload
        else:
            size = syncsafe(len(payload)) if major == 4 else struct.pack(">I", len(payload))
            body += fid.encode() + size + struct.pack(">H", fflags) + payload
    flags = 0x80 if unsync else 0
    if unsync:
        body = body.replace(b"\xff", b"\xff\x00")
    return b"ID3" + bytes([major, 0, flags]) + syncsafe(len(body)) + body


def text_frame(text: str, enc=3) -> bytes:
    encodings = {0: "latin-1", 1: "utf-16", 3: "utf-8"}
    return bytes([enc]) + text.encode(encodings[enc])
