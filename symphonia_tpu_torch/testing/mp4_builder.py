"""Minimal MP4 muxers for decoder tests: ``atom``, ``full_atom``,
``build_m4a`` (AAC in a plain M4A), ``build_pcm_m4a`` (QuickTime
uncompressed audio), ``build_fmp4`` (fragmented AAC), ``build_av_mp4``
(PCM audio beside an avc1 video track) and ``build_fmp4_video``
(fragmented video) of ``tests/test_mp4.py``, copied."""

import struct

import numpy as np


def atom(atype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + atype + payload


def full_atom(atype: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return atom(atype, bytes([version]) + flags.to_bytes(3, "big") + payload)


def build_pcm_m4a(pcm, fourcc=b"sowt", rate=22050, frames_per_chunk=400,
                  extra_traks=b"") -> bytes:
    """QuickTime uncompressed-audio M4A: interleaved PCM in chunks.

    ``pcm`` is int16 [channels, frames]. v0 sample entries for
    sowt/twos; a version-2 ``lpcm`` entry when fourcc == b"lpcm".
    ``extra_traks`` appends prebuilt trak atoms (video/subtitle tests).
    """
    n_ch, n_frames = pcm.shape
    le = fourcc != b"twos"
    inter = np.ascontiguousarray(pcm.T.astype("<i2" if le else ">i2"))
    payload = inter.tobytes()
    fb = 2 * n_ch

    common = (b"\x00" * 6 + struct.pack(">H", 1)          # dref index
              + struct.pack(">H", 2 if fourcc == b"lpcm" else 0)  # version
              + b"\x00" * 6                                # revision+vendor
              + struct.pack(">HH", n_ch, 16)
              + b"\x00" * 4
              + struct.pack(">I", rate << 16))
    if fourcc == b"lpcm":
        body = (common[:20] + struct.pack(">HH", 3, 16) + common[24:]
                + struct.pack(">I", 0)                    # sizeof ext
                + struct.pack(">d", float(rate))
                + struct.pack(">I", n_ch)
                + struct.pack(">I", 0x7F000000)
                + struct.pack(">IIII", 16, 0x4,           # s16, signed LE
                              frames_per_chunk * fb, frames_per_chunk))
        entry = atom(b"lpcm", body)
    else:
        entry = atom(fourcc, common)
    stsd = full_atom(b"stsd", struct.pack(">I", 1) + entry)

    n_chunks = (n_frames + frames_per_chunk - 1) // frames_per_chunk
    if fourcc == b"lpcm":
        # v2: each MP4 sample is one multi-frame packet.
        stts_rows = [(n_chunks - 1, frames_per_chunk)] if n_chunks > 1 else []
        last = n_frames - (n_chunks - 1) * frames_per_chunk
        stts_rows.append((1, last))
        stts = full_atom(b"stts", struct.pack(">I", len(stts_rows))
                         + b"".join(struct.pack(">II", c, d)
                                    for c, d in stts_rows))
        stsc = full_atom(b"stsc", struct.pack(">IIII", 1, 1, 1, 1))
        sz = [frames_per_chunk * fb] * (n_chunks - 1) + [last * fb]
        stsz = full_atom(b"stsz", struct.pack(">II", 0, n_chunks)
                         + b"".join(struct.pack(">I", s) for s in sz))
    else:
        # v0: each MP4 sample is one PCM frame.
        stts = full_atom(b"stts", struct.pack(">III", 1, n_frames, 1))
        stsc = full_atom(b"stsc",
                         struct.pack(">IIII", 1, 1, frames_per_chunk, 1))
        stsz = full_atom(b"stsz", struct.pack(">III", fb, n_frames, 0)[:12])

    def build(mdat_offset):
        offs = [mdat_offset + i * frames_per_chunk * fb
                for i in range(n_chunks)]
        stco = full_atom(b"stco", struct.pack(">I", n_chunks)
                         + b"".join(struct.pack(">I", o) for o in offs))
        stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = atom(b"minf", stbl)
        mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate,
                                              n_frames, 0x55C4, 0))
        mdia = atom(b"mdia", mdhd + minf)
        tkhd = full_atom(b"tkhd",
                         struct.pack(">IIII", 0, 0, 1, 0) + b"\x00" * 72)
        trak = atom(b"trak", tkhd + mdia)
        mvhd = full_atom(b"mvhd",
                         struct.pack(">III", 0, 0, rate) + b"\x00" * 88)
        return atom(b"moov", mvhd + trak + extra_traks)

    ftyp = atom(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42isom")
    moov = build(0)
    moov = build(len(ftyp) + len(moov) + 8)
    return ftyp + moov + atom(b"mdat", payload)


def build_m4a(frames, rate=44100, n_ch=1, tags=None) -> bytes:
    """Minimal non-fragmented M4A muxer for tests."""
    # ASC for AAC-LC.
    from ..common.mpeg import AudioSpecificConfig

    asc = AudioSpecificConfig.build(2, rate, n_ch)
    # esds: ES(3){ESID(2)+flags(1) DecoderConfig(4){13 bytes DecSpecific(5){asc}} SLConfig(6){02}}
    dsi = bytes([0x05, len(asc)]) + asc
    dcd = bytes([0x04, 13 + len(dsi), 0x40, 0x15]) + b"\x00" * 11 + dsi
    slc = bytes([0x06, 0x01, 0x02])
    es = bytes([0x03, 3 + len(dcd) + len(slc)]) + b"\x00\x00\x00" + dcd + slc
    esds = full_atom(b"esds", es)

    mp4a = atom(
        b"mp4a",
        b"\x00" * 6 + struct.pack(">H", 1)
        + b"\x00" * 8
        + struct.pack(">HH", n_ch, 16)
        + b"\x00" * 4
        + struct.pack(">I", rate << 16)
        + esds,
    )
    stsd = full_atom(b"stsd", struct.pack(">I", 1) + mp4a)
    n = len(frames)
    stts = full_atom(b"stts", struct.pack(">III", 1, n, 1024))
    stsc = full_atom(b"stsc", struct.pack(">IIII", 1, 1, n, 1))
    sizes = b"".join(struct.pack(">I", len(f)) for f in frames)
    stsz = full_atom(b"stsz", struct.pack(">II", 0, n) + sizes)

    # We need the absolute mdat payload offset; compute sizes iteratively.
    def build(mdat_offset):
        stco = full_atom(b"stco", struct.pack(">II", 1, mdat_offset))
        stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = atom(b"minf", stbl)
        mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate, n * 1024, 0x55C4, 0))
        mdia = atom(b"mdia", mdhd + minf)
        tkhd = full_atom(b"tkhd", struct.pack(">IIII", 0, 0, 1, 0) + b"\x00" * 72)
        trak = atom(b"trak", tkhd + mdia)
        udta = b""
        if tags:
            ilst_items = b""
            for key, val in tags.items():
                data = full_atom(b"data", b"\x00\x00\x00\x00" + val.encode(), version=0, flags=1)
                ilst_items += atom(key, data)
            ilst = atom(b"ilst", ilst_items)
            meta = atom(b"meta", b"\x00\x00\x00\x00" + ilst)
            udta = atom(b"udta", meta)
        mvhd = full_atom(b"mvhd", struct.pack(">III", 0, 0, rate) + b"\x00" * 88)
        moov = atom(b"moov", mvhd + trak + udta)
        return moov

    ftyp = atom(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42isom")
    payload = b"".join(frames)
    # Two passes to fix up the chunk offset.
    moov = build(0)
    mdat_offset = len(ftyp) + len(moov) + 8
    moov = build(mdat_offset)
    mdat = atom(b"mdat", payload)
    return ftyp + moov + mdat


def build_fmp4(frames, rate=44100, n_ch=1, frag_size=4,
               with_sidx=False, sizes_in_trex=False) -> bytes:
    """Minimal fragmented MP4: moov with empty sample tables + mvex, then
    one moof/mdat pair per ``frag_size`` frames; with_sidx inserts a
    segment index referencing each moof+mdat subsegment."""
    from ..common.mpeg import AudioSpecificConfig

    asc = AudioSpecificConfig.build(2, rate, n_ch)
    dsi = bytes([0x05, len(asc)]) + asc
    dcd = bytes([0x04, 13 + len(dsi), 0x40, 0x15]) + b"\x00" * 11 + dsi
    slc = bytes([0x06, 0x01, 0x02])
    es = bytes([0x03, 3 + len(dcd) + len(slc)]) + b"\x00\x00\x00" + dcd + slc
    esds = full_atom(b"esds", es)
    mp4a = atom(
        b"mp4a",
        b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 8
        + struct.pack(">HH", n_ch, 16) + b"\x00" * 4
        + struct.pack(">I", rate << 16) + esds,
    )
    stsd = full_atom(b"stsd", struct.pack(">I", 1) + mp4a)
    stts = full_atom(b"stts", struct.pack(">I", 0))
    stsc = full_atom(b"stsc", struct.pack(">I", 0))
    stsz = full_atom(b"stsz", struct.pack(">II", 0, 0))
    stco = full_atom(b"stco", struct.pack(">I", 0))
    stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco)
    minf = atom(b"minf", stbl)
    mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate, 0, 0x55C4, 0))
    mdia = atom(b"mdia", mdhd + minf)
    tkhd = full_atom(b"tkhd", struct.pack(">IIII", 0, 0, 1, 0) + b"\x00" * 72)
    trak = atom(b"trak", tkhd + mdia)
    # sizes_in_trex: carry duration AND size only in trex (tfhd/trun bare)
    # — requires uniform frame sizes.
    trex_size = len(frames[0]) if sizes_in_trex else 0
    if sizes_in_trex:
        assert all(len(f) == trex_size for f in frames)
    trex = full_atom(b"trex", struct.pack(">IIIII", 1, 1, 1024, trex_size, 0))
    mvex = atom(b"mvex", trex)
    mvhd = full_atom(b"mvhd", struct.pack(">III", 0, 0, rate) + b"\x00" * 88)
    moov = atom(b"moov", mvhd + trak + mvex)
    ftyp = atom(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42isom")

    out = ftyp + moov
    segments = []
    seq = 1
    for i in range(0, len(frames), frag_size):
        grp = frames[i : i + frag_size]
        mfhd = full_atom(b"mfhd", struct.pack(">I", seq))
        seq += 1
        if sizes_in_trex:
            # tfhd: track_id only; trun: data-offset only — duration and
            # size both resolve through the trex defaults.
            tfhd = full_atom(b"tfhd", struct.pack(">I", 1), flags=0)
            trun_payload = struct.pack(">I", len(grp)) + struct.pack(">i", 0)
            trun = full_atom(b"trun", trun_payload, flags=0x1)
        else:
            # tfhd: default-sample-duration present (0x8)
            tfhd = full_atom(b"tfhd", struct.pack(">II", 1, 1024), flags=0x8)
            # trun: data-offset (0x1) + sample-size (0x200)
            sizes = b"".join(struct.pack(">I", len(f)) for f in grp)
            trun_payload = struct.pack(">I", len(grp)) + struct.pack(">i", 0) + sizes
            trun = full_atom(b"trun", trun_payload, flags=0x201)
        traf = atom(b"traf", tfhd + trun)
        moof = atom(b"moof", mfhd + traf)
        # Patch the trun data offset: moof start + moof size + mdat header.
        data_offset = len(moof) + 8
        moof = bytearray(moof)
        # find trun payload: last 4*len(grp) + 8 bytes before end... locate
        idx = moof.find(b"trun") + 4 + 4 + 4  # type + ver/flags + count
        struct.pack_into(">i", moof, idx, data_offset)
        segments.append((bytes(moof) + atom(b"mdat", b"".join(grp)),
                         len(grp) * 1024))
    if with_sidx:
        payload = struct.pack(">IIIIHH", 1, rate, 0, 0, 0, len(segments))
        for blob, dur in segments:
            payload += struct.pack(">III", len(blob), dur, 0x90000000)
        out += full_atom(b"sidx", payload)
    out += b"".join(blob for blob, _ in segments)
    return out


def build_av_mp4(pcm, vframes, v_dur=100, ctts_offs=None, sync=None,
                 ctts_version=0, rate=8000, v_timescale=1000,
                 a_ctts_offs=None, subs=None, s_dur=500) -> bytes:
    """Two-track MP4: sowt PCM audio (track 1, one chunk) + an avc1 video
    track (track 2) whose samples carry stts durations, optional ctts
    composition offsets and an optional stss sync-sample table; ``subs``
    adds a tx3g subtitle track (track 3) with one sample per cue."""
    n_ch, n_frames = pcm.shape
    audio_payload = np.ascontiguousarray(pcm.T.astype("<i2")).tobytes()
    video_payload = b"".join(vframes)
    subs_payload = b"".join(subs) if subs else b""
    nv = len(vframes)
    fb = 2 * n_ch

    def audio_trak(mdat_off):
        common = (b"\x00" * 6 + struct.pack(">H", 1) + struct.pack(">H", 0)
                  + b"\x00" * 6 + struct.pack(">HH", n_ch, 16)
                  + b"\x00" * 4 + struct.pack(">I", rate << 16))
        stsd = full_atom(b"stsd", struct.pack(">I", 1)
                         + atom(b"sowt", common))
        stts = full_atom(b"stts", struct.pack(">III", 1, n_frames, 1))
        stsc = full_atom(b"stsc", struct.pack(">IIII", 1, 1, n_frames, 1))
        stsz = full_atom(b"stsz", struct.pack(">III", fb, n_frames, 0)[:12])
        stco = full_atom(b"stco", struct.pack(">II", 1, mdat_off))
        extra = b""
        if a_ctts_offs is not None:
            extra = full_atom(
                b"ctts", struct.pack(">I", len(a_ctts_offs))
                + b"".join(struct.pack(">II", 1, o) for o in a_ctts_offs))
        stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco + extra)
        mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate,
                                              n_frames, 0x55C4, 0))
        mdia = atom(b"mdia", mdhd + atom(b"minf", stbl))
        tkhd = full_atom(b"tkhd",
                         struct.pack(">IIII", 0, 0, 1, 0) + b"\x00" * 72)
        return atom(b"trak", tkhd + mdia)

    def video_trak(mdat_off):
        visual = (b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 16
                  + struct.pack(">HH", 320, 180)
                  + struct.pack(">II", 0x480000, 0x480000)
                  + b"\x00" * 4 + struct.pack(">H", 1) + b"\x00" * 32
                  + struct.pack(">Hh", 24, -1)
                  + atom(b"avcC", b"\x01\x64\x00\x1f\xff"))
        stsd = full_atom(b"stsd", struct.pack(">I", 1)
                         + atom(b"avc1", visual))
        stts = full_atom(b"stts", struct.pack(">III", 1, nv, v_dur))
        stsc = full_atom(b"stsc", struct.pack(">IIII", 1, 1, nv, 1))
        stsz = full_atom(b"stsz", struct.pack(">II", 0, nv)
                         + b"".join(struct.pack(">I", len(f))
                                    for f in vframes))
        voff = mdat_off + len(audio_payload)
        stco = full_atom(b"stco", struct.pack(">II", 1, voff))
        extra = b""
        if ctts_offs is not None:
            extra += full_atom(
                b"ctts", struct.pack(">I", len(ctts_offs))
                + b"".join(struct.pack(">Ii" if ctts_version else ">II",
                                       1, o) for o in ctts_offs),
                version=ctts_version)
        if sync is not None:
            extra += full_atom(b"stss", struct.pack(">I", len(sync))
                               + b"".join(struct.pack(">I", s)
                                          for s in sync))
        stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco + extra)
        mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, v_timescale,
                                              nv * v_dur, 0x55C4, 0))
        mdia = atom(b"mdia", mdhd + atom(b"minf", stbl))
        tkhd = full_atom(b"tkhd",
                         struct.pack(">IIII", 0, 0, 2, 0) + b"\x00" * 72)
        return atom(b"trak", tkhd + mdia)

    def subs_trak(mdat_off):
        ns = len(subs)
        stsd = full_atom(b"stsd", struct.pack(">I", 1)
                         + atom(b"tx3g", b"\x00" * 8))
        stts = full_atom(b"stts", struct.pack(">III", 1, ns, s_dur))
        stsc = full_atom(b"stsc", struct.pack(">IIII", 1, 1, ns, 1))
        stsz = full_atom(b"stsz", struct.pack(">II", 0, ns)
                         + b"".join(struct.pack(">I", len(s)) for s in subs))
        soff = mdat_off + len(audio_payload) + len(video_payload)
        stco = full_atom(b"stco", struct.pack(">II", 1, soff))
        stbl = atom(b"stbl", stsd + stts + stsc + stsz + stco)
        mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, 1000,
                                              ns * s_dur, 0x55C4, 0))
        mdia = atom(b"mdia", mdhd + atom(b"minf", stbl))
        tkhd = full_atom(b"tkhd",
                         struct.pack(">IIII", 0, 0, 3, 0) + b"\x00" * 72)
        return atom(b"trak", tkhd + mdia)

    def build(mdat_off):
        mvhd = full_atom(b"mvhd",
                         struct.pack(">III", 0, 0, rate) + b"\x00" * 88)
        return atom(b"moov", mvhd + audio_trak(mdat_off)
                    + video_trak(mdat_off)
                    + (subs_trak(mdat_off) if subs else b""))

    ftyp = atom(b"ftyp", b"isom\x00\x00\x00\x00isommp42")
    moov = build(0)
    moov = build(len(ftyp) + len(moov) + 8)
    return ftyp + moov + atom(b"mdat", audio_payload + video_payload
                              + subs_payload)


def build_fmp4_video(vframes, v_dur=100, timescale=1000, sample_flags=None,
                     cts=None, first_flags=None, tfhd_flags=None,
                     trex_flags=0, trun_version=1,
                     largesize_moof=False) -> bytes:
    """Fragmented MP4 with a single avc1 video track (one moof/mdat pair):
    trun carries per-sample sizes, plus optional per-sample flags (0x400),
    composition offsets (0x800) and first-sample-flags (0x4); sample-flag
    resolution order is trun > tfhd > trex."""
    visual = (b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 16
              + struct.pack(">HH", 320, 180)
              + struct.pack(">II", 0x480000, 0x480000)
              + b"\x00" * 4 + struct.pack(">H", 1) + b"\x00" * 32
              + struct.pack(">Hh", 24, -1)
              + atom(b"avcC", b"\x01\x64\x00\x1f\xff"))
    stsd = full_atom(b"stsd", struct.pack(">I", 1) + atom(b"avc1", visual))
    stbl = atom(b"stbl", stsd + full_atom(b"stts", struct.pack(">I", 0))
                + full_atom(b"stsc", struct.pack(">I", 0))
                + full_atom(b"stsz", struct.pack(">II", 0, 0))
                + full_atom(b"stco", struct.pack(">I", 0)))
    mdhd = full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, 0,
                                          0x55C4, 0))
    mdia = atom(b"mdia", mdhd + atom(b"minf", stbl))
    tkhd = full_atom(b"tkhd", struct.pack(">IIII", 0, 0, 1, 0) + b"\x00" * 72)
    trex = full_atom(b"trex", struct.pack(">IIIII", 1, 1, v_dur, 0,
                                          trex_flags))
    mvhd = full_atom(b"mvhd", struct.pack(">III", 0, 0, timescale)
                     + b"\x00" * 88)
    moov = atom(b"moov", mvhd + atom(b"trak", tkhd + mdia)
                + atom(b"mvex", trex))
    ftyp = atom(b"ftyp", b"isom\x00\x00\x00\x00isommp42")

    n = len(vframes)
    mfhd = full_atom(b"mfhd", struct.pack(">I", 1))
    if tfhd_flags is None:
        tfhd = full_atom(b"tfhd", struct.pack(">I", 1), flags=0)
    else:
        tfhd = full_atom(b"tfhd", struct.pack(">II", 1, tfhd_flags),
                         flags=0x20)  # default-sample-flags present
    tr_flags = 0x1 | 0x200  # data offset + per-sample sizes
    if first_flags is not None:
        tr_flags |= 0x4
    if sample_flags is not None:
        tr_flags |= 0x400
    if cts is not None:
        tr_flags |= 0x800
    payload = struct.pack(">I", n) + struct.pack(">i", 0)
    if first_flags is not None:
        payload += struct.pack(">I", first_flags)
    for k, f in enumerate(vframes):
        payload += struct.pack(">I", len(f))
        if sample_flags is not None:
            payload += struct.pack(">I", sample_flags[k])
        if cts is not None:
            payload += struct.pack(">i" if trun_version else ">I", cts[k])
    trun = full_atom(b"trun", payload, flags=tr_flags,
                     version=trun_version)
    body = mfhd + atom(b"traf", tfhd + trun)
    if largesize_moof:
        # 64-bit atom header: size==1 + largesize (16-byte header).
        moof = bytearray(struct.pack(">I", 1) + b"moof"
                         + struct.pack(">Q", 16 + len(body)) + body)
    else:
        moof = bytearray(atom(b"moof", body))
    data_offset = len(moof) + 8
    idx = moof.find(b"trun") + 4 + 4 + 4  # type + ver/flags + count
    struct.pack_into(">i", moof, idx, data_offset)
    return ftyp + moov + bytes(moof) + atom(b"mdat", b"".join(vframes))
