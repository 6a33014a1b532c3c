"""The port's facade per-packet path on CPU: ``decode_bytes`` and
``decode_many(device="cpu")`` of ``symphonia_tpu_torch.batch`` against the
JAX package's ``symphonia_tpu.batch``, bit for bit, on every stream that no
batch pipeline takes (PCM in WAV, AIFF, CAF and MP4, IMA and MS ADPCM, ALAC
in CAF, FLAC in Matroska), alone and mixed with batch codecs, with
``md5_ok`` and the ``packet_routes`` count."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

from symphonia_tpu import batch as ref
from symphonia_tpu_torch import batch as port

import chip_smoke
from flac_builder import build_flac_file, random_walk
from mp3_builder import build_mpeg1_l3_stream
from test_adpcm import ima_encode, make_adpcm_wav, ms_encode, smooth_signal
from test_aiff_caf import make_aiff, make_caf
from test_mp4 import build_pcm_m4a
from test_wav_pcm import make_wav

PYGAME_DATA = pathlib.Path(importlib.util.find_spec(
    "pygame").submodule_search_locations[0]) / "examples/data"


def _frames(bits, n, ch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, ch))


@functools.lru_cache(maxsize=None)
def _flac_chans():
    return tuple(random_walk(4096 * 2 + 100, 16, seed=12, ch=2))


def _flac_mkv(corrupt_md5=False):
    data = chip_smoke._flac_mkv(list(_flac_chans()), 44100)
    if corrupt_md5:
        # The MD5 is the last 16 bytes of STREAMINFO (CodecPrivate).
        i = data.index(b"fLaC") + 8 + 18
        data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    return data


# name -> builder of the stream's bytes
STREAMS = {
    "wav_u8": lambda: make_wav(_frames(8, 9000, 2, 0), rate=8000, bits=8),
    "wav_s16": lambda: make_wav(_frames(16, 9000, 2, 1), rate=22050),
    "wav_s24": lambda: make_wav(_frames(24, 7000, 1, 2), bits=24),
    "wav_s32": lambda: make_wav(_frames(32, 6000, 2, 3), bits=32),
    "wav_f32": lambda: make_wav((np.random.default_rng(4).standard_normal(
        (6000, 2)) * 0.3).astype(np.float32), fmt_tag=3),
    "aiff": lambda: make_aiff(_frames(16, 9000, 2, 5)),
    "aiff_s24": lambda: make_aiff(_frames(24, 3000, 1, 6), bits=24),
    "caf": lambda: make_caf(_frames(16, 300, 2, 7)),
    "ima_adpcm": lambda: _adpcm(0x11),
    "ms_adpcm": lambda: _adpcm(0x02),
    "alac_caf": lambda: chip_smoke._alac_caf(
        random_walk(4096 * 2 + 512, 16, seed=9, ch=1), 4096, 44100),
    "flac_mkv": _flac_mkv,
    "pcm_mp4": lambda: build_pcm_m4a(
        _frames(16, 5000, 2, 10).T.astype(np.int16)),
}


def _adpcm(tag):
    sig = smooth_signal(3030, 8)
    if tag == 0x11:
        payload, align = ima_encode(sig)
        return make_adpcm_wav(payload, tag, align, 505, len(sig))
    payload, align = ms_encode(sig)
    return make_adpcm_wav(payload, tag, align, 500, len(sig))


@functools.lru_cache(maxsize=None)
def _stream(name) -> bytes:
    return STREAMS[name]()


def _same(got, want):
    assert got.samples.dtype == want.samples.dtype
    assert got.samples.shape == want.samples.shape
    np.testing.assert_array_equal(got.samples, want.samples)
    assert (got.sample_rate, got.bits_per_sample, got.md5_ok) == (
        want.sample_rate, want.bits_per_sample, want.md5_ok)


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_bytes_matches_reference(name):
    data = _stream(name)
    before = (port.packet_routes, port.host_routes)
    got = port.decode_bytes(data, device="cpu")
    assert (port.packet_routes, port.host_routes) == (before[0] + 1,
                                                      before[1])
    _same(got, ref.decode_bytes(data))
    assert got.samples.shape[1] > 0


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_many_matches_decode_bytes(name):
    data = _stream(name)
    before = port.packet_routes
    outs = port.decode_many([data, data], device="cpu")
    assert port.packet_routes == before + 2
    want = ref.decode_bytes(data)
    for out in outs:
        _same(out, want)


def test_lossless_sources_come_back():
    rng = np.random.default_rng(4)
    f32 = (rng.standard_normal((6000, 2)) * 0.3).astype(np.float32)
    out = port.decode_bytes(_stream("wav_f32"), device="cpu").samples
    np.testing.assert_array_equal(out.view(np.int32), f32.T.view(np.int32))
    for name, src in (("wav_s24", _frames(24, 7000, 1, 2)),
                      ("caf", _frames(16, 300, 2, 7)),
                      ("pcm_mp4", _frames(16, 5000, 2, 10))):
        out = port.decode_bytes(_stream(name), device="cpu").samples
        np.testing.assert_array_equal(out, src.T)
    out = port.decode_bytes(_stream("flac_mkv"), device="cpu").samples
    np.testing.assert_array_equal(out, np.stack(_flac_chans()))


@pytest.mark.parametrize("corrupt,verify,md5_ok", [
    (False, True, True), (True, True, False), (False, False, None)])
def test_md5_ok_is_passed_through(corrupt, verify, md5_ok):
    data = _flac_mkv(corrupt_md5=corrupt)
    one = port.decode_bytes(data, device="cpu", verify=verify)
    many = port.decode_many([data], device="cpu", verify=verify)[0]
    want = ref.decode_bytes(data, verify=verify)
    assert want.md5_ok is md5_ok
    _same(one, want)
    _same(many, want)


def test_house_lo_wav():
    path = PYGAME_DATA / "house_lo.wav"
    if not path.exists():
        pytest.skip("pygame's house_lo.wav is not installed")
    data = path.read_bytes()
    _same(port.decode_bytes(data, device="cpu"), ref.decode_bytes(data))


def test_mixed_batch_in_input_order():
    flac = build_flac_file(random_walk(1024, 16, seed=3, ch=2),
                           block_size=256, kind="fixed", order=2)
    mp3 = build_mpeg1_l3_stream(3, n_ch=2, seed=2)
    names = ["wav_s16", "ima_adpcm", "flac_mkv", "aiff", "alac_caf"]
    datas = [flac, _stream(names[0]), mp3, _stream(names[1]),
             _stream(names[2]), flac, _stream(names[3]), mp3,
             _stream(names[4])]
    before = (port.packet_routes, port.host_routes)
    got = port.decode_many(datas, device="cpu", verify=True)
    assert port.packet_routes == before[0] + len(names)
    assert port.host_routes == before[1]
    want = ref.decode_many(datas, verify=True)
    assert len(got) == len(want) == len(datas)
    for data, g, w in zip(datas, got, want):
        if data is mp3:  # the dense stage's bar
            assert g.samples.shape == w.samples.shape
            np.testing.assert_allclose(g.samples, w.samples, atol=2e-5,
                                       rtol=0)
        else:
            _same(g, w)


def test_undecodable_stream_raises_what_decode_bytes_raises():
    bad = b"\x00not an audio stream" * 8
    with pytest.raises(Exception) as one:
        port.decode_bytes(bad, device="cpu")
    with pytest.raises(Exception) as many:
        port.decode_many([_stream("wav_s16"), bad], device="cpu")
    with pytest.raises(Exception) as want:
        ref.decode_bytes(bad)
    assert type(one.value).__name__ == type(many.value).__name__ == type(
        want.value).__name__
    assert str(one.value) == str(many.value) == str(want.value)
