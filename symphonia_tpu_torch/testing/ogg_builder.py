"""Ogg page builder for decoder tests: ``_ogg_page`` of
``tests/test_vorbis_ogg.py``, copied."""


def _ogg_page(serial, seqno, granule, packets, header_type=0):
    """Build one OGG page (page.rs:144-331); each packet must be <255*255."""
    from ..core.checksum import crc32_buf

    lacing = b""
    body = b""
    for p in packets:
        n = len(p)
        while n >= 255:
            lacing += bytes([255])
            n -= 255
        lacing += bytes([n])
        body += p
    head = (b"OggS\x00" + bytes([header_type])
            + granule.to_bytes(8, "little", signed=True)
            + serial.to_bytes(4, "little") + seqno.to_bytes(4, "little")
            + b"\x00" * 4 + bytes([len(lacing)]) + lacing)
    blob = bytearray(head + body)
    blob[22:26] = crc32_buf(bytes(blob)).to_bytes(4, "little")
    return bytes(blob)
