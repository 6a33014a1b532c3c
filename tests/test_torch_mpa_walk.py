"""The compiled frame-table walk of ``symphonia_tpu_torch.mpa_walk`` against
the verbatim ``formats.mpa.MpaReader``: field by field (frame table, first
header, gapless fields, track, packet table, packets, seeks) on the test
encoders' streams (LAME-style FMA and speech clips, MPEG-1/2/2.5 Layer III,
Layer I and II, CRC, VBRI, an Info frame alone) and on seeded corruptions
(junk and false syncs, frames of another rate or layer, truncation, a
last sync byte, no frame at all), every header word, the fallback to the
verbatim walk and its counters, the build, and ``decode_many`` with the
walker on and off."""

import dataclasses
import shutil

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from symphonia_tpu_torch import batch, mpa_walk, native, trace
from symphonia_tpu_torch.codecs.mpa_common import _parse_header
from symphonia_tpu_torch.core.errors import DecodeError, Unsupported
from symphonia_tpu_torch.core.formats import FormatOptions, SeekMode, SeekTo
from symphonia_tpu_torch.core.io import MediaSourceStream
from symphonia_tpu_torch.formats.mpa import MpaReader
from symphonia_tpu_torch.testing import mp3_builder as sb
from symphonia_tpu_torch.testing import mp3_entropy_streams as es
from symphonia_tpu_torch.testing import mp3_lame_builder as lb

FMA = lb.JOINT_STEREO_44K
SPEECH = lb.Format(48000, 1, 64)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the walker")


def lame(seed, seconds, fmt=FMA, **kw):
    n = int(seconds * fmt.sample_rate)
    rng = np.random.default_rng(seed)
    silence = (4, 3) if fmt is SPEECH else (0, 0)
    g = lb.draw(rng, n, fmt=fmt, silence=silence,
                env=lb.envelope(14000.0, sample_rate=fmt.sample_rate)
                if fmt is SPEECH else None)
    return lb.build_stream(g, n, fmt=fmt, **kw).data


def header_word(version_bits, layer_bits, bitrate_idx, rate_idx, *,
                padding=0, crc=False, mode=0, emphasis=0):
    return ((0x7FF << 21) | (version_bits << 19) | (layer_bits << 17)
            | ((0 if crc else 1) << 16) | (bitrate_idx << 12)
            | (rate_idx << 10) | (padding << 9) | (mode << 6) | emphasis)


def frame(word, rng=None):
    """A frame of header ``word`` with a body of zeros, or of seeded bytes
    rich in 0xFF (false syncs) where ``rng`` is given."""
    size = _parse_header(word).frame_size
    body = (bytes(size - 4) if rng is None
            else rng.choice([0, 0xFF, 0xE3, 0xFB, 0x44], size - 4).astype(
                np.uint8).tobytes())
    return word.to_bytes(4, "big") + body


def soup(seed):
    """A seeded stream of frames that share a version, layer and rate, with
    frames of random headers (valid or not, another rate or layer), junk
    with false syncs, cut frames, and a cut at a random end."""
    rng = np.random.default_rng(seed)
    vb, lyr, ri = (int(rng.choice([0, 2, 3])), int(rng.integers(1, 4)),
                   int(rng.integers(0, 3)))
    out = bytearray(rng.integers(0, 256, int(rng.integers(0, 40)),
                                 np.uint8).tobytes())
    for _ in range(int(rng.integers(20, 60))):
        r = rng.random()
        if r < 0.7:
            out += frame(header_word(vb, lyr, int(rng.integers(1, 15)), ri,
                                     padding=int(rng.integers(0, 2)),
                                     crc=bool(rng.integers(0, 2)),
                                     mode=int(rng.integers(0, 4)),
                                     emphasis=int(rng.choice([0, 1, 3]))),
                         rng)
        elif r < 0.8:
            word = (0xFFE00000 | int(rng.integers(0, 1 << 21)))
            try:
                out += frame(word, rng)
            except DecodeError:
                out += word.to_bytes(4, "big")
        elif r < 0.9:
            out += bytes([0xFF, 0xE0 | int(rng.integers(0, 32))])
            out += rng.integers(0, 256, int(rng.integers(0, 50)),
                                np.uint8).tobytes()
        else:
            f = frame(header_word(vb, lyr, int(rng.integers(1, 15)), ri), rng)
            out += f[: int(rng.integers(1, len(f)))]
    return bytes(out[: len(out) - int(rng.integers(0, 30))])


def first_audio(data):
    """Offset of the first audio frame the verbatim reader finds."""
    return int(MpaReader(MediaSourceStream(data))._offsets[0])


def with_vbri(data):
    """``data``'s Info frame made a VBRI frame: the Xing tag cleared, VBRI
    at 32 bytes after the header, with byte and frame counts."""
    r = MpaReader(MediaSourceStream(data))
    info = int(r._offsets[0]) - r.header.frame_size
    out = bytearray(data)
    side = 4 + r.header.side_info_len()
    out[info + side : info + side + 4] = bytes(4)
    v = info + 36
    out[v : v + 4] = b"VBRI"
    out[v + 10 : v + 14] = (len(data) - info).to_bytes(4, "big")
    out[v + 14 : v + 18] = len(r._offsets).to_bytes(4, "big")
    return bytes(out)


def insert(data, at, piece):
    return data[:at] + piece + data[at:]


def inputs():
    rng = np.random.default_rng(25)
    fma = lame(1, 2.0)
    speech = lame(2, 2.5, SPEECH, tags={})
    l3 = sb.build_mpeg1_l3_stream(12, n_ch=2, seed=3)
    mid = first_audio(fma) + 7 * 835
    other_rate = frame(header_word(3, 1, 9, 1))       # 48 kHz, Layer III
    other_layer = frame(header_word(3, 2, 9, 0))      # 44.1 kHz, Layer II
    false_sync = b"\xff\xfb\x90" + bytes(5) + b"\xff\xe2"
    cases = {
        "fma": fma,
        "fma_no_info": lame(3, 1.0, info=False, tags={}),
        "fma_no_reservoir": lame(4, 1.0, reservoir=False),
        "speech": speech,
        "mpeg1_mono": sb.build_mpeg1_l3_stream(15, n_ch=1, seed=5),
        "mpeg1_stereo": l3,
        "mpeg2": es.lsf_stream(rng, 14, 2, 2.0),
        "mpeg2_mono": es.lsf_stream(rng, 14, 1, 2.0),
        "mpeg2_5": es.lsf_stream(rng, 14, 2, 2.5),
        "layer1": chip_smoke.build_mpa_l12("l1", 7, 41),
        "layer2": chip_smoke.build_mpa_l12("l2", 6, 42),
        "layer2_lsf": chip_smoke.build_mpa_l12("l2_lsf", 5, 43),
        "crc": es.with_crc(es.mpeg1_stream(rng, 10, 2)),
        "vbri": with_vbri(speech),
        "info_only": speech[: first_audio(speech)],
        "junk_head": rng.integers(0, 256, 700, np.uint8).tobytes()
        + b"\xff\xfb\xff\xe0" + l3,
        "junk_mid": insert(fma, mid, false_sync + bytes(20)),
        "false_sync_mid": insert(fma, mid + 100, b"\xff\xfb\x90\x64"),
        "other_rate_mid": insert(fma, mid, other_rate),
        "other_layer_mid": insert(fma, mid, other_layer),
        "truncated_last": fma[:-300],
        "sync_last_byte": fma + b"\xff",
        "header_at_end": fma + b"\xff\xfb\x90",
        "lone_frame": frame(header_word(3, 1, 9, 0)),
        "two_frames_cut": (frame(header_word(3, 1, 9, 0)) * 2)[:-1],
    }
    cases.update({f"soup{s}": soup(s) for s in range(12)})
    return cases


INPUTS = inputs()


def readers(data, gapless):
    opts = FormatOptions(enable_gapless=gapless)
    return (MpaReader(MediaSourceStream(data), opts),
            mpa_walk.MpaReader(MediaSourceStream(data), opts))


def assert_same(ref, port):
    assert port._buf == ref._buf and port._start == ref._start
    for name in ("_offsets", "_sizes"):
        a, b = getattr(ref, name), getattr(port, name)
        assert b.dtype == np.int64 and b.flags.c_contiguous
        np.testing.assert_array_equal(b, a)
    for name in ("header", "_spf", "_cursor", "_delay", "_padding",
                 "_total_out", "_track"):
        assert getattr(port, name) == getattr(ref, name), name
    assert list(port._metadata) == list(ref._metadata)
    assert port.tracks() == ref.tracks()
    ta, tb = ref.packet_table(), port.packet_table()
    for f in dataclasses.fields(ta):
        a, b = getattr(ta, f.name), getattr(tb, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a, f.name


def packets(reader, limit=None):
    out = []
    while limit is None or len(out) < limit:
        p = reader.next_packet()
        if p is None:
            break
        out.append(p)
    return out


@pytest.mark.parametrize("gapless", [True, False], ids=["gapless", "raw"])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_the_compiled_walk_is_the_verbatim_reader(name, gapless):
    data = INPUTS[name]
    ref, port = readers(data, gapless)
    assert_same(ref, port)
    assert packets(port) == packets(ref)
    n = len(ref._offsets)
    total = n * ref._spf
    for ts in (0, 1, ref._spf - 1, total // 3, total // 2, total - 1, total,
               total + 5000):
        for mode in (SeekMode.COARSE, SeekMode.ACCURATE):
            if n == 0:
                continue  # the verbatim reader's seek wants a frame
            assert port.seek(mode, SeekTo(ts=ts)) == ref.seek(
                mode, SeekTo(ts=ts))
            assert packets(port, 3) == packets(ref, 3)


def test_the_inputs_reach_every_rule():
    # The cases walk what their names say: resyncs inside the stream, the
    # other rate or layer skipped, a truncated last frame, a tag frame.
    def table(name):
        return MpaReader(MediaSourceStream(INPUTS[name]))._offsets

    fma = table("fma")
    for name in ("junk_mid", "other_rate_mid", "other_layer_mid"):
        assert len(table(name)) == len(fma)
    assert len(table("truncated_last")) < len(fma)
    assert len(table("info_only")) == 0
    assert len(table("lone_frame")) == 1 and len(table("two_frames_cut")) == 1
    assert MpaReader(MediaSourceStream(INPUTS["crc"])).header.has_crc
    assert MpaReader(MediaSourceStream(INPUTS["layer1"])).header.layer == 1
    vbri = MpaReader(MediaSourceStream(INPUTS["vbri"]))
    assert vbri._delay == 0 and len(vbri._offsets) == len(
        table("speech"))


@pytest.mark.parametrize("data", [b"", b"\xff", b"\xff\xfb",
                                  bytes(5000),
                                  b"\xff\xfb\x90\x64" + bytes(413)
                                  + b"\xff\xfb\x00\x64" + bytes(8),
                                  b"\xff" * 64,
                                  frame(header_word(3, 1, 9, 0))
                                  + b"\xff\xfb\x00\x64"],
                         ids=["empty", "one_sync_byte", "two_bytes", "zeros",
                              "bad_successor", "ff_run",
                              "bad_successor_at_the_end"])
def test_no_frame_raises_the_same_unsupported(data):
    with pytest.raises(Unsupported) as ref:
        MpaReader(MediaSourceStream(data))
    with pytest.raises(Unsupported) as port:
        mpa_walk.MpaReader(MediaSourceStream(data))
    assert str(port.value) == str(ref.value)


def test_every_header_word():
    # Each version, layer, bitrate, rate, padding and emphasis (8,192
    # words): two frames of it walk to the verbatim table, or both refuse.
    rng = np.random.default_rng(7)
    sizes = []
    for bits in range(1 << 13):
        vb, lyr, bi = bits >> 11, (bits >> 9) & 3, (bits >> 5) & 15
        ri, pad, emph = (bits >> 3) & 3, (bits >> 2) & 1, bits & 3
        word = header_word(vb, lyr, bi, ri, padding=pad, emphasis=emph,
                           crc=bool(rng.integers(0, 2)),
                           mode=int(rng.integers(0, 4)))
        try:
            size = _parse_header(word).frame_size
        except DecodeError:
            size = None
        data = (word.to_bytes(4, "big") + bytes((size or 40) - 4)) * 2
        if size is not None:
            sizes.append(size)
        try:
            ref = MpaReader(MediaSourceStream(data))
        except Unsupported:
            # A refused word (a shifted one may still parse in its bytes).
            assert size is None
            with pytest.raises(Unsupported):
                mpa_walk.MpaReader(MediaSourceStream(data))
            continue
        assert_same(ref, mpa_walk.MpaReader(MediaSourceStream(data)))
    assert len(sizes) == 3 * 3 * 14 * 3 * 2 * 3
    # The walk's output room: every frame is longer than _MIN_FRAME.
    assert min(sizes) == 24 > mpa_walk._MIN_FRAME


@needs_gxx
def test_the_compiled_walk_runs_and_counts():
    datas = [INPUTS["fma"], INPUTS["speech"]]
    assert mpa_walk._lib() is not None
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("decode_many"):
            for d in datas:
                mpa_walk.MpaReader(MediaSourceStream(d))
    (r,) = trace.requests()
    trace.reset()
    assert r.counters == {"mpa_walk_native_streams": 2}


@pytest.mark.parametrize("how", ["no_library", "native_disabled"])
def test_fallback_is_the_verbatim_walk(monkeypatch, how):
    if how == "no_library":
        monkeypatch.setattr(mpa_walk, "_build", lambda: None)
        monkeypatch.setattr(mpa_walk, "_LIB", None)
        monkeypatch.setattr(mpa_walk, "_TRIED", False)
    else:
        monkeypatch.setattr(native, "_DISABLED", True)
    assert mpa_walk._lib() is None
    calls = []
    real = MpaReader._resync
    monkeypatch.setattr(MpaReader, "_resync", staticmethod(
        lambda *a: calls.append(a[1]) or real(*a)))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("decode_many"):
            for name in ("fma", "junk_mid", "vbri"):
                ref, port = readers(INPUTS[name], True)
                assert_same(ref, port)
    (r,) = trace.requests()
    trace.reset()
    assert r.counters == {"mpa_walk_host_streams": 3}
    # Both readers found their first frame by the verbatim resync.
    assert calls.count(0) == 6


@needs_gxx
def test_the_build(monkeypatch, tmp_path):
    monkeypatch.setattr(mpa_walk, "BUILD_DIR", tmp_path / "_build")
    so = mpa_walk._build()
    assert so.parent == tmp_path / "_build" and so.name.startswith(
        "libmpa_walk_")
    # Only the library is left: no object file, no temporary.
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [so.name]
    assert mpa_walk._build() == so  # found, not built again
    # An edited source gets a library of its own.
    edited = tmp_path / "mpa_walk.cpp"
    edited.write_text(mpa_walk.SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(mpa_walk, "SRC", edited)
    assert mpa_walk._build() not in (None, so)
    # A failed build leaves nothing behind and returns None.
    edited.write_text("not C++")
    assert mpa_walk._build() is None
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_facade_and_open_build_the_compiled_reader():
    fma = INPUTS["fma"]
    route, fmt, _ = batch._probe(fma)
    assert route == "mp3" and type(fmt) is mpa_walk.MpaReader
    # The probe starts the reader after the ID3v2 tag.
    ref = MpaReader(MediaSourceStream(fma))
    np.testing.assert_array_equal(fmt._offsets + fmt._start,
                                  ref._offsets + ref._start)
    dec = batch.Mp3BatchDecoder(device="cpu")
    assert type(dec._open(MediaSourceStream(fma))) is mpa_walk.MpaReader
    route, fmt, _ = batch._probe(INPUTS["layer2"])
    assert route == "mp2" and type(fmt) is mpa_walk.MpaReader


def test_an_unseekable_source_keeps_the_streaming_reader():
    from conftest import ForwardPipe
    from symphonia_tpu_torch import get_probe
    from symphonia_tpu_torch.formats.mpa import MpaStreamReader

    fmt = get_probe().probe(MediaSourceStream(
        ForwardPipe(INPUTS["speech"]))).format
    assert type(fmt) is MpaStreamReader


def test_decode_many_with_the_walker_on_and_off(monkeypatch):
    datas = [INPUTS["fma"], INPUTS["speech"], lame(9, 1.5),
             lame(10, 2.0, SPEECH, tags={})]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        on = batch.decode_many(datas, device="cpu")
    (r,) = trace.requests()
    trace.reset()
    if shutil.which("g++") is not None:
        assert r.counters["mpa_walk_native_streams"] == len(datas)
        assert "mpa_walk_host_streams" not in r.counters
    assert r.calls["scan"] == len(datas)
    monkeypatch.setattr(mpa_walk, "_lib", lambda: None)
    with profile(activities=[ProfilerActivity.CPU]):
        off = batch.decode_many(datas, device="cpu")
    (r,) = trace.requests()
    trace.reset()
    assert r.counters["mpa_walk_host_streams"] == len(datas)
    assert "mpa_walk_native_streams" not in r.counters
    for a, b in zip(on, off):
        assert a.samples.dtype == b.samples.dtype
        assert a.samples.tobytes() == b.samples.tobytes()
        assert (a.sample_rate, a.bits_per_sample) == (b.sample_rate,
                                                      b.bits_per_sample)


@needs_gxx
def test_chip_smoke_phase_15_rehearsed():
    # The card call's host-walk phase, its generators on the CPU, small.
    info = chip_smoke.phase_mpa_walk(2, 2, 1, device="cpu")
    for name, clips in (("fma_mp3", 2), ("commonvoice_mp3", 2)):
        v = info[name]
        assert v["tables_equal"] and v["clips"] == clips and v["frames"] > 0
        assert all(v[k] > 0 for k in ("verbatim_ms", "compiled_ms",
                                      "read_ms", "walk_ms"))
