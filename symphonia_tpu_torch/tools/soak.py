"""Randomized mutation soak over the port's full decode surface.

Port of ``tools/soak.py``: build valid streams with every test encoder of
:mod:`symphonia_tpu_torch.testing`, apply random mutations (byte flips,
truncations, splices, duplications, prefix garbage), and push them through
probe -> demux -> batch/per-packet decode on the card. Any exception that
is not part of the error taxonomy, any native crash and any CUDA error
fails the soak: nothing here catches ``RuntimeError``.

Each round builds one stream, mutates it twice and runs four passes over
the three variants: the merged ``batch.decode_many``, ``batch.decode_bytes``
on each, the forward-only pipe (one mutated variant) and the seek pass
(the other). Where the reference reads a Vorbis file from an installed
package, :func:`builders`' ``ogg`` writes a short Vorbis stream from the
soak's own random generator.

    python -m symphonia_tpu_torch.tools.soak [seconds] [seed]
"""

import os
import sys
import tempfile
import time

import numpy as np

from .. import batch
from ..core.errors import (DecodeError, IoError, LimitError, ResetRequired,
                           SeekError, Unsupported)

# Strict taxonomy: raw ValueError/IndexError/etc escaping the decode surface
# on malformed input is a bug (the reference maps everything to its error
# enum).
OK_ERRORS = (DecodeError, IoError, LimitError, ResetRequired, SeekError,
             Unsupported, EOFError)


def builders(rng):
    from ..testing.aac_builder import build_adts, build_raw_block
    from ..testing.flac_builder import build_flac_file, random_walk
    from ..testing.mp3_builder import build_mpeg1_l3_stream

    def flac():
        block = int(rng.choice([256, 1024, 4096]))
        # whole blocks only: the mirror encoder needs >= order samples in
        # the final partial block
        n = block * int(rng.integers(2, 9))
        ch = random_walk(n, 16, seed=int(rng.integers(1 << 16)), ch=2)
        return build_flac_file(ch, block_size=block,
                               stereo_mode=str(rng.choice(
                                   ["independent", "left_side", "mid_side"])),
                               kind="fixed", order=int(rng.integers(0, 5)),
                               partition_order=int(rng.integers(0, 3)))

    def mp3():
        return build_mpeg1_l3_stream(int(rng.integers(3, 10)), n_ch=2,
                                     seed=int(rng.integers(1 << 16)))

    def aac():
        frames = []
        for f in range(int(rng.integers(3, 14))):
            seq = int(rng.choice([0, 1, 2, 3]))
            nch = 2
            specs = []
            for _ in range(nch):
                q = np.zeros(1024, np.int64)
                n = int(rng.integers(10, 400))
                idx = rng.choice(1000, size=n, replace=False)
                q[idx] = rng.integers(-200, 201, size=n)
                specs.append(q)
            frames.append(build_raw_block(specs, [seq] * nch, 12, 140, 44100,
                                          common_window=bool(rng.integers(2))))
        return build_adts(frames, 44100, 2)

    def wav():
        from ..testing.wav_builder import make_wav

        n = int(rng.integers(500, 8000))
        fr = rng.integers(-30000, 30000, size=(n, 2))
        return make_wav(fr, rate=int(rng.choice([8000, 44100])),
                        bits=int(rng.choice([8, 16, 24])))

    def mkv():
        from ..testing.mkv_builder import build_mkv, simple_block

        pcm = (rng.integers(-3000, 3000,
                            size=int(rng.integers(64, 2048)))
               .astype("<i2").tobytes())
        blocks = [(0, [simple_block(1, 0, [pcm])])]
        return build_mkv("A_PCM/INT/LIT", b"", blocks, rate=8000, ch=1,
                         bit_depth=16)

    def m4a():
        from ..testing.mp4_builder import build_m4a, build_pcm_m4a

        if rng.integers(4) == 0:  # QuickTime uncompressed-audio flavor
            pcm = rng.integers(-30000, 30000,
                               size=(int(rng.integers(1, 3)),
                                     int(rng.integers(200, 3000)))
                               ).astype(np.int16)
            fourcc = [b"sowt", b"twos", b"lpcm"][int(rng.integers(3))]
            return build_pcm_m4a(pcm, fourcc,
                                 frames_per_chunk=int(rng.integers(50, 800)))
        frames = []
        for _ in range(int(rng.integers(2, 8))):
            q = np.zeros(1024, np.int64)
            idx = rng.choice(1000, size=100, replace=False)
            q[idx] = rng.integers(-60, 61, size=100)
            frames.append(build_raw_block([q], [0], 12, 140, 44100))
        return build_m4a(frames, rate=44100, n_ch=1)

    def ogg():
        # A short stereo Vorbis stream (floor 0, residue 2, long and short
        # blocks) from this generator; mutations of it stress the page and
        # packet reassembly.
        from ..testing.vorbis_stream import build_vorbis

        e0, e1 = [(6, 9), (8, 11), (9, 12)][int(rng.integers(3))]
        return build_vorbis(int(rng.choice([44100, 48000])), e0, e1,
                            float(rng.uniform(0.1, 0.8)),
                            int(rng.integers(1 << 16)))

    def adpcm():
        from ..testing.adpcm_builder import make_adpcm_wav

        if bool(rng.integers(2)):  # MS ADPCM: 7-byte/ch header blocks
            ba = int(rng.choice([128, 512, 1024]))
            n_blocks = int(rng.integers(2, 8))
            payload = rng.integers(0, 256, size=ba * n_blocks,
                                   dtype=np.uint8).tobytes()
            fpb = (ba - 7) * 2 + 2
            return make_adpcm_wav(payload, 0x02, ba, fpb, fpb * n_blocks)
        ba = int(rng.choice([256, 1024, 2048]))
        n_blocks = int(rng.integers(2, 8))
        payload = rng.integers(0, 256, size=ba * n_blocks,
                               dtype=np.uint8).tobytes()
        fpb = (ba - 4) * 2 + 1
        return make_adpcm_wav(payload, 0x11, ba, fpb, fpb * n_blocks)

    def aiff():
        from ..testing.aiff_caf_builder import make_aiff

        n = int(rng.integers(400, 6000))
        fr = rng.integers(-30000, 30000, size=(n, 2))
        aifc = bool(rng.integers(2))
        comp = bytes(rng.choice([b"NONE", b"sowt"])) if aifc else b"NONE"
        bits = 16 if comp == b"sowt" else int(rng.choice([8, 16, 24]))
        return make_aiff(fr, rate=int(rng.choice([8000, 44100])),
                         bits=bits, aifc=aifc, comp=comp)

    def caf():
        from ..testing.aiff_caf_builder import make_caf

        n = int(rng.integers(400, 6000))
        fr = rng.integers(-30000, 30000, size=(n, 2))
        le = bool(rng.integers(2))
        return make_caf(fr, rate=int(rng.choice([8000, 44100])),
                        flags=0x2 if le else 0x0)

    def fmp4():
        from ..testing.mp4_builder import build_fmp4

        frames = []
        for _ in range(int(rng.integers(4, 14))):
            q = np.zeros(1024, np.int64)
            idx = rng.choice(1000, size=100, replace=False)
            q[idx] = rng.integers(-60, 61, size=100)
            frames.append(build_raw_block([q], [0], 12, 140, 44100))
        return build_fmp4(frames, rate=44100, n_ch=1,
                          frag_size=int(rng.choice([2, 4, 7])),
                          with_sidx=bool(rng.integers(2)))

    # -- metadata-targeted families: the tag parsers (id3v2 flagged frames
    # / CHAP/CTOC / APE / FLAC vorbis-comment + picture / MP4 ilst / MKV
    # Targets) under the same strict taxonomy.

    def id3_mp3():
        from ..testing.metadata_builder import build_id3v2, text_frame

        frames = []
        names = [b"TIT2", b"TPE1", b"TALB", b"TCON", b"TRCK", b"TXXX",
                 b"COMM", b"APIC", b"GEOB", b"SYLT", b"PRIV", b"UFID",
                 b"RVA2", b"POPM", b"WXXX", b"CHAP", b"CTOC", b"TIPL"]
        major = int(rng.choice([2, 3, 4]))
        for _ in range(int(rng.integers(2, 10))):
            fid = bytes(rng.choice(names)).decode()
            if major == 2:
                fid = fid[:3]
            body = bytes(rng.integers(0, 256,
                                      size=int(rng.integers(1, 200)),
                                      dtype=np.uint8))
            if rng.integers(2):  # half the frames: plausible text
                body = text_frame("x" * int(rng.integers(0, 40)),
                                  enc=int(rng.choice([0, 1, 3])))
            fflags = 0
            if major == 3 and rng.integers(3) == 0:
                fflags = int(rng.choice([0x20, 0x40, 0x80, 0xE0]))
            elif major == 4 and rng.integers(3) == 0:
                fflags = int(rng.choice([0x40, 0x04, 0x02, 0x01, 0x47]))
            frames.append((fid, body, fflags))
        tag = build_id3v2(frames, major=major)
        v1 = b"TAG" + bytes(125)  # trailing ID3v1
        return tag + build_mpeg1_l3_stream(2, n_ch=1) + v1

    def ape_mp3():
        import struct as _s

        body = b""
        n = int(rng.integers(1, 8))
        for i in range(n):
            val = bytes(rng.integers(0, 256, size=int(rng.integers(0, 60)),
                                     dtype=np.uint8))
            key = f"Key{i}".encode()
            body += _s.pack("<II", len(val),
                            int(rng.choice([0, 2]))) + key + b"\x00" + val
        tag_size = len(body) + 32
        footer = (b"APETAGEX" + _s.pack("<IIII", 2000, tag_size, n, 0)
                  + bytes(8))
        return build_mpeg1_l3_stream(2, n_ch=1) + body + footer

    def flac_meta():
        import struct as _s

        ch = random_walk(512, 16, seed=int(rng.integers(1 << 16)))
        vendor = b"soak"
        payload = _s.pack("<I", len(vendor)) + vendor
        n = int(rng.integers(0, 6))
        payload += _s.pack("<I", n)
        for i in range(n):
            c = (f"K{i}=" + "v" * int(rng.integers(0, 50))).encode()
            payload += _s.pack("<I", len(c)) + c
        blocks = [bytes([4]) + payload]
        if rng.integers(2):  # PICTURE block (type 6)
            img = bytes(rng.integers(0, 256, size=int(rng.integers(4, 64)),
                                     dtype=np.uint8))
            mime = b"image/png"
            pic = (_s.pack(">I", 3) + _s.pack(">I", len(mime)) + mime
                   + _s.pack(">I", 0) + _s.pack(">IIII", 8, 8, 24, 0)
                   + _s.pack(">I", len(img)) + img)
            blocks.append(bytes([6]) + pic)
        return build_flac_file(ch, kind="fixed", order=1,
                               extra_metadata_blocks=blocks)

    def m4a_ilst():
        from ..testing.mp4_builder import build_m4a

        q = np.zeros(1024, np.int64)
        q[rng.choice(1000, size=60, replace=False)] = rng.integers(
            -60, 61, size=60)
        frames = [build_raw_block([q], [0], 12, 140, 44100)
                  for _ in range(3)]
        tags = {}
        for key in (b"\xa9nam", b"\xa9ART", b"trkn", b"covr", b"gnre"):
            if rng.integers(2):
                tags[key] = "".join(
                    chr(c) for c in rng.integers(32, 127, size=int(
                        rng.integers(0, 30))))
        return build_m4a(frames, 44100, 1, tags=tags or None)

    def mkv_targets():
        from ..testing.mkv_builder import (build_mkv, simple_block,
                                           simple_tag, tag_elem, tags_elem,
                                           targets_elem)

        tag_elems = []
        for _ in range(int(rng.integers(1, 5))):
            level = (None if rng.integers(3) == 0
                     else int(rng.choice([10, 20, 30, 40, 50, 60, 70, 45])))
            sts = [simple_tag(
                str(rng.choice(["TITLE", "ARTIST", "TOTAL_PARTS",
                                "PART_NUMBER", "ORIGINAL", "COMMENT"])),
                "v" * int(rng.integers(0, 20)))
                for _ in range(int(rng.integers(1, 4)))]
            tgt = (targets_elem(level,
                                track_uids=[int(rng.choice([0, 1, 777]))]
                                if rng.integers(2) else ())
                   if level is not None else b"")
            tag_elems.append(tag_elem(sts, tgt))
        sig = (np.sin(np.arange(300) * 0.1) * 9000).astype("<i2").tobytes()
        return build_mkv("A_PCM/INT/LIT", b"",
                         [(0, [simple_block(1, 0, [sig])])],
                         rate=8000, ch=1, bit_depth=16,
                         extra_segment=tags_elem(*tag_elems))

    # -- muxed A/V families: video/subtitle packet demux paths (MKV cluster
    # walk with non-audio blocks, MP4 ctts/stss) under the same strict
    # taxonomy.

    def mkv_av():
        from ..testing.mkv_builder import (_block_group, _sb_flags, elem,
                                           float_elem, uint_elem)

        ebml_hdr = elem(0x1A45DFA3,
                        elem(0x4282, b"matroska") + uint_elem(0x4287, 4))
        audio_entry = (
            uint_elem(0xD7, 1) + uint_elem(0x83, 2)
            + elem(0x86, b"A_PCM/INT/LIT")
            + elem(0xE1, float_elem(0xB5, 8000.0) + uint_elem(0x9F, 1)
                   + uint_elem(0x6264, 16)))
        video_entry = (
            uint_elem(0xD7, 2) + uint_elem(0x83, 1)
            + elem(0x86, bytes(rng.choice([b"V_VP9", b"V_MPEG4/ISO/AVC"])))
            + uint_elem(0x23E383, 40_000_000)
            + elem(0xE0, uint_elem(0xB0, 320) + uint_elem(0xBA, 180)))
        sub_entry = (uint_elem(0xD7, 3) + uint_elem(0x83, 0x11)
                     + elem(0x86, b"S_TEXT/UTF8"))
        tracks = elem(0x1654AE6B, elem(0xAE, audio_entry)
                      + elem(0xAE, video_entry) + elem(0xAE, sub_entry))
        info = elem(0x1549A966, uint_elem(0x2AD7B1, 1_000_000))
        body = uint_elem(0xE7, 0)
        ts = 0
        for _ in range(int(rng.integers(2, 8))):
            pcm = rng.integers(-20000, 20000,
                               size=int(rng.integers(8, 64))
                               ).astype("<i2").tobytes()
            vf = bytes(rng.integers(0, 256,
                                    size=int(rng.integers(1, 80)),
                                    dtype=np.uint8))
            body += _sb_flags(1, ts, pcm, 0x80)
            body += _sb_flags(2, ts, vf, 0x80 if rng.integers(2) else 0)
            if rng.integers(2):
                body += _block_group(3, ts, b"sub" * int(rng.integers(1, 9)),
                                     bdur=int(rng.integers(1, 900)),
                                     ref=(-40 if rng.integers(2) else None))
            ts += int(rng.integers(1, 80))
        cluster = elem(0x1F43B675, body)
        return ebml_hdr + elem(0x18538067, info + tracks + cluster)

    def mp4_av():
        from ..testing.mp4_builder import build_av_mp4

        n = int(rng.integers(40, 300))
        pcm = rng.integers(-20000, 20000, size=(1, n)).astype(np.int16)
        nv = int(rng.integers(1, 8))
        vframes = [bytes(rng.integers(0, 256,
                                      size=int(rng.integers(1, 120)),
                                      dtype=np.uint8)) for _ in range(nv)]
        ver = int(rng.integers(2))
        ctts = ([int(rng.integers(-200 if ver else 0, 400))
                 for _ in range(nv)] if rng.integers(2) else None)
        sync = (sorted(set(int(x) for x in
                           rng.integers(1, nv + 1,
                                        size=int(rng.integers(1, nv + 1)))))
                if rng.integers(2) else None)
        return build_av_mp4(pcm, vframes, ctts_offs=ctts, sync=sync,
                            ctts_version=ver)

    def fmp4_video():
        # Fragmented video: trun per-sample flags / signed cts /
        # first-sample-flags / tfhd+trex default resolution under mutation.
        from ..testing.mp4_builder import build_fmp4_video

        nv = int(rng.integers(1, 10))
        vframes = [bytes(rng.integers(0, 256,
                                      size=int(rng.integers(1, 100)),
                                      dtype=np.uint8)) for _ in range(nv)]
        ver = int(rng.integers(2))
        flags = ([int(rng.integers(0, 2)) << 16 for _ in range(nv)]
                 if rng.integers(2) else None)
        cts = ([int(rng.integers(-300 if ver else 0, 500))
                for _ in range(nv)] if rng.integers(2) else None)
        first = int(rng.integers(0, 2)) << 16 if rng.integers(2) else None
        tfhd = int(rng.integers(0, 2)) << 16 if rng.integers(2) else None
        return build_fmp4_video(vframes, sample_flags=flags, cts=cts,
                                first_flags=first, tfhd_flags=tfhd,
                                trex_flags=int(rng.integers(0, 2)) << 16,
                                trun_version=ver)

    return [flac, mp3, aac, wav, mkv, m4a, ogg, adpcm, aiff, caf, fmp4,
            id3_mp3, ape_mp3, flac_meta, m4a_ilst, mkv_targets,
            mkv_av, mp4_av, fmp4_video]


def mutate(data: bytes, rng) -> bytes:
    b = bytearray(data)
    kind = rng.integers(0, 5)
    if kind == 0 and len(b) > 4:  # byte flips
        for _ in range(int(rng.integers(1, 24))):
            b[int(rng.integers(len(b)))] ^= int(rng.integers(1, 256))
    elif kind == 1 and len(b) > 8:  # truncate
        b = b[: int(rng.integers(4, len(b)))]
    elif kind == 2 and len(b) > 16:  # splice a chunk out
        i = int(rng.integers(0, len(b) - 8))
        j = int(rng.integers(i + 1, min(i + 4096, len(b))))
        del b[i:j]
    elif kind == 3:  # duplicate a chunk
        i = int(rng.integers(0, max(1, len(b) - 8)))
        j = int(rng.integers(i + 1, min(i + 2048, len(b))))
        b[i:i] = b[i:j]
    else:  # random prefix garbage (probe scan stress)
        b[0:0] = bytes(rng.integers(0, 256, size=int(rng.integers(1, 512)),
                                    dtype=np.uint8))
    return bytes(b)


class _Pipe:
    """Forward-only wrapper: routes the input through the streaming
    readers (Ogg/MPA/FLAC/MKV/Mp4StreamReader) + per-packet decode."""

    def __init__(self, b):
        self.b = b
        self.i = 0

    def readable(self):
        return True

    def seekable(self):
        return False

    def read(self, n_=-1):
        if n_ is None or n_ < 0:
            n_ = len(self.b) - self.i
        out = self.b[self.i : self.i + n_]
        self.i += len(out)
        return out


def seek_pass(data: bytes, rng) -> None:
    """Randomized seek + short redecode on a seekable source. Seeks on
    mutated containers stress index math / re-sync; only taxonomy errors
    are acceptable."""
    import symphonia_tpu_torch as sym

    fmt = sym.get_probe().probe(sym.MediaSourceStream(data)).format
    tr = fmt.default_track()
    if tr is None or tr.codec_params is None:
        # Non-audio container: still stress seek + packet walk.
        for _ in range(4):
            try:
                fmt.seek("accurate",
                         sym.SeekTo(ts=int(rng.integers(0, 200000))))
            except OK_ERRORS:
                continue
            for _ in range(3):
                if fmt.next_packet() is None:
                    break
        return
    dec = sym.get_codecs().make_audio_decoder(tr.codec_params)
    span = tr.num_frames or 200000
    for _ in range(4):
        ts = int(rng.integers(0, max(1, int(span * 1.1))))
        try:
            fmt.seek("accurate", sym.SeekTo(ts=ts))
        except OK_ERRORS:
            continue
        dec.reset()
        for _ in range(3):
            pkt = fmt.next_packet()
            if pkt is None:
                break
            try:
                dec.decode(pkt)
            except OK_ERRORS:
                break


def decode_pipe(data: bytes) -> int:
    import symphonia_tpu_torch as sym

    fmt = sym.get_probe().probe(sym.MediaSourceStream(_Pipe(data))).format
    tr = fmt.default_track()
    if tr is None or tr.codec_params is None:
        while fmt.next_packet() is not None:  # still walk the packets
            pass
        return 0  # non-audio-only container
    dec = sym.get_codecs().make_audio_decoder(tr.codec_params)
    total = 0
    while True:
        pkt = fmt.next_packet()
        if pkt is None:
            return total
        if pkt.track_id != tr.id:
            continue
        try:
            total += dec.decode(pkt).frames
        except OK_ERRORS:
            continue  # per-packet errors: skip like the players do


def main(seconds: float = 120.0, seed=None, *, device="cuda",
         max_inputs=None, keep: int = 0) -> dict:
    """Soak for ``seconds`` (and at most ``max_inputs`` inputs, whole
    rounds of three) from ``seed`` (default: the clock) on ``device``.

    Returns ``inputs``, ``decoded`` (inputs whose ``decode_bytes`` gave
    samples), ``rounds``, ``seconds``, ``slow`` (inputs over 10 s, each
    saved under the temporary directory) and ``kept``: the first ``keep``
    decoded inputs as (builder, round, variant, bytes, samples) for a
    comparison on another device."""
    dev = batch.resolve_device(device)
    seed = int(time.time()) if seed is None else int(seed)
    rng = np.random.default_rng(seed)
    print(f"[soak] seed={seed} budget={seconds:.0f}s device={dev}",
          flush=True)
    bs = builders(rng)

    t0 = time.time()
    n = decoded = rounds = 0
    slow, kept = [], []
    while time.time() - t0 < seconds and (max_inputs is None
                                          or n < max_inputs):
        build = bs[int(rng.integers(len(bs)))]
        base = build()
        variants = (base, mutate(base, rng), mutate(base, rng))
        # The merged serving path (cross-file device dispatch) sees the
        # same batch: merge-specific escapes surface here.
        try:
            batch.decode_many(list(variants), device=dev)
        except OK_ERRORS:
            pass
        for k, variant in enumerate(variants):
            n += 1
            t1 = time.time()
            try:
                out = batch.decode_bytes(variant, device=dev)
                if out.samples.size:
                    decoded += 1
                    if len(kept) < keep:
                        kept.append((build.__name__, rounds, k, variant,
                                     out.samples))
            except OK_ERRORS:
                pass  # taxonomy errors are the contract for malformed input
            if k == 1:  # one mutated variant also runs the pipe surface
                try:
                    decode_pipe(variant)
                except OK_ERRORS:
                    pass
            if k == 2:  # the other mutated variant runs the seek surface
                try:
                    seek_pass(variant, rng)
                except OK_ERRORS:
                    pass
            if time.time() - t1 > 10.0:
                # Pathologically slow input = DoS-adjacent; surface it.
                path = os.path.join(tempfile.gettempdir(),
                                    f"soak_slow_{seed}_{n}.bin")
                with open(path, "wb") as f:
                    f.write(variant)
                slow.append(path)
                print(f"[soak] SLOW input ({time.time()-t1:.1f}s, "
                      f"{len(variant)} bytes) saved to {path}", flush=True)
        rounds += 1
    wall = time.time() - t0
    print(f"[soak] {n} inputs ({decoded} decoded) in {wall:.0f}s — "
          f"no crashes, no non-taxonomy exceptions", flush=True)
    return {"seed": seed, "inputs": n, "decoded": decoded, "rounds": rounds,
            "seconds": wall, "slow": slow, "kept": kept}


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 120.0,
         int(sys.argv[2]) if len(sys.argv) > 2 else None)
