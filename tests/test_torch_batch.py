"""The port's batch decode slices (FLAC, MPEG audio Layers I-III, AAC-LC,
Ogg Vorbis) on CPU against the JAX reference's ``symphonia_tpu.batch``:
FLAC exact with equal MD5 verdicts, MPEG audio within the reference's
dense-stage bar (atol 2e-5), AAC within the reference's batch-decoder bar
(atol 1e-5, test_aac.py:213), Vorbis within 1e-5 on house_lo.ogg
(test_vorbis_ogg.py:207) and 1e-6 of the peak on builder streams."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

from symphonia_tpu import batch as ref
from symphonia_tpu_torch import batch as port

from aac_builder import build_adts, build_raw_block, random_quant_spectrum
from flac_builder import build_flac_file, random_walk
from mp3_builder import build_mpeg1_l3_stream

# A real MPEG-2.5 mono file that ships with pygame's examples.
HOUSE_MP3 = pathlib.Path(importlib.util.find_spec(
    "pygame").submodule_search_locations[0]) / "examples/data/house_lo.mp3"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden_pcm.npz"


@functools.lru_cache(maxsize=None)
def _flacs():
    """Five streams: block sizes 256-4096, mono and stereo, three modes."""
    outs = []  # (bytes, planar source); cached, so read-only
    for seed, (block, ch, mode) in enumerate([
        (256, 2, "left_side"), (1024, 1, "independent"),
        (4096, 2, "mid_side"), (512, 2, "independent"),
        (1024, 2, "mid_side"),
    ]):
        chans = random_walk(block * (2 + seed % 3), 16, seed=seed, ch=ch)
        outs.append((build_flac_file(chans, block_size=block,
                                     stereo_mode=mode, kind="fixed",
                                     order=2), np.stack(chans)))
    return tuple(outs)


@functools.lru_cache(maxsize=None)
def _mp3s():
    """Three stereo streams of 3-4 frames and one mono of 70, sized so the
    reference's power-of-two granule buckets (8 stereo, 256 mono) are the
    ones HOUSE_MP3 needs too: one compile per channel count."""
    return tuple([build_mpeg1_l3_stream(3 + s % 2, n_ch=2, seed=s)
                  for s in range(3)]
                 + [build_mpeg1_l3_stream(70, n_ch=1, seed=7)])


@functools.lru_cache(maxsize=None)
def _ref_one(data: bytes, verify: bool = False):
    """The reference's per-file decode, once per stream (its merged
    decode_many equals per-file output by its own tests)."""
    return ref.decode_bytes(data, verify=verify)


def _same_flac(got, want):
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.samples.dtype == want.samples.dtype
    assert (got.sample_rate, got.bits_per_sample, got.md5_ok) == (
        want.sample_rate, want.bits_per_sample, want.md5_ok)


def _close_mp3(got, want, atol=2e-5):
    assert got.samples.shape == want.samples.shape
    assert got.sample_rate == want.sample_rate
    np.testing.assert_allclose(got.samples, want.samples, atol=atol, rtol=0)


class TestFlacSlice:
    @pytest.mark.parametrize("kind,kw", [
        ("lpc", dict(lpc_coefs=[900, -500, 120], lpc_shift=10,
                     lpc_precision=12)),
        ("fixed", dict(order=3)),
    ])
    def test_decode_bytes_matches_reference(self, kind, kw):
        ch = random_walk(4096, 16, seed=21, ch=2)
        data = build_flac_file(ch, block_size=1024, stereo_mode="mid_side",
                               kind=kind, **kw)
        got = port.decode_bytes(data, device="cpu", verify=True)
        _same_flac(got, _ref_one(data, True))
        np.testing.assert_array_equal(got.samples, np.stack(ch))
        assert got.md5_ok is True

    def test_lane_chunk_chaining(self):
        ch = random_walk(2048, 16, seed=22)
        data = build_flac_file(ch, block_size=256, kind="fixed", order=2)
        got = port.FlacBatchDecoder(device="cpu", lane_chunk=3).decode_bytes(
            data)
        _same_flac(got, ref.FlacBatchDecoder(lane_chunk=4).decode_bytes(data))
        np.testing.assert_array_equal(got.samples, np.stack(ch))

    def test_decode_many_merged_equals_per_file_and_reference(self):
        flacs = _flacs()
        datas = [d for d, _ in flacs]
        dec = port.FlacBatchDecoder(device="cpu", verify=True, lane_chunk=7)
        merged = dec.decode_many(datas)
        for (d, src), got in zip(flacs, merged):
            _same_flac(got, dec.decode_bytes(d))
            _same_flac(got, _ref_one(d, True))
            np.testing.assert_array_equal(got.samples, src)
            assert got.md5_ok is True

    def test_corrupt_frame_takes_parsed_path_like_reference(self):
        data = bytearray(_flacs()[0][0])
        data[len(data) // 2] ^= 0xFF  # corrupt one frame body mid-stream
        data = bytes(data)
        before = port.host_routes
        got = port.decode_many([data], device="cpu", verify=True)[0]
        _same_flac(got, _ref_one(data, True))
        assert port.host_routes == before  # still the device dense stage

    def test_32bit_stream_takes_counted_host_route(self):
        ch = random_walk(1024, 32, seed=99, ch=2)
        data = build_flac_file(ch, bps=32, block_size=512, kind="fixed",
                               order=1)
        before = port.host_routes
        got = port.FlacBatchDecoder(device="cpu", verify=True).decode_bytes(
            data)
        assert port.host_routes == before + 1
        np.testing.assert_array_equal(got.samples.astype(np.int64),
                                      np.stack(ch))
        assert got.md5_ok is True
        _same_flac(got, ref.FlacBatchDecoder(verify=True).decode_bytes(data))


class TestMp3Slice:
    def test_decode_bytes_matches_reference(self):
        for data in (_mp3s()[0], HOUSE_MP3.read_bytes()):
            got = port.decode_bytes(data, device="cpu")
            _close_mp3(got, _ref_one(data))
            assert got.samples.dtype == np.float32

    def test_ungapless_matches_reference(self):
        data = _mp3s()[1]
        got = port.Mp3BatchDecoder(device="cpu", gapless=False).decode_bytes(
            data)
        _close_mp3(got, ref.Mp3BatchDecoder(gapless=False).decode_bytes(data))

    def test_decode_many_chunk_chaining_and_boundaries(self):
        datas = _mp3s()
        dec = port.Mp3BatchDecoder(device="cpu", granule_chunk=5)
        merged = dec.decode_many(datas)
        one = port.Mp3BatchDecoder(device="cpu")
        for d, got in zip(datas, merged):
            _close_mp3(got, one.decode_bytes(d), atol=1e-6)
            _close_mp3(got, _ref_one(d))


@functools.lru_cache(maxsize=None)
def _aacs():
    """Small ADTS streams: (name, bytes), each a case the slice covers."""
    rng = np.random.default_rng(40)
    cyc = [0, 0, 0, 1, 2, 3]  # ONLY_LONG x3, LONG_START, EIGHT_SHORT, STOP

    def frame(seqs, rate, shape=0, **kw):
        quants = [random_quant_spectrum(rng, 12 if s == 2 else 40, rate, s)
                  for s in seqs]
        return build_raw_block(quants, seqs, 12 if 2 in seqs else 40, 140,
                               rate, shape=shape, **kw)

    mono = [frame([s], 44100, shape=int(rng.integers(0, 2)))
            for s in cyc * 2]
    stereo = [frame([0, 0], 44100) for _ in range(5)]
    cycle = [frame([s, s], 44100, shape=int(rng.integers(0, 2)))
             for s in cyc * 2]
    k48 = [frame([s, s], 48000) for s in cyc]
    k24 = [frame([s], 24000) for s in cyc]
    spec0 = np.zeros(1024, np.int64)
    spec0[0:12] = [3, -2, 1, 4, -1, 2, 1, -3, 2, 1, -1, 2]
    spec1 = np.zeros(1024, np.int64)
    spec1[0:4] = [1, -1, 2, 1]
    # Intensity bands in channel 1 keep it host-dequantized (deq = 1)
    # beside channel 0's handoff lanes (test_aac.py:284-287).
    intensity = [build_raw_block([spec0, spec1], [0, 0], 12, 140, 44100,
                                 special_books1={5: 14}) for _ in range(4)]
    return (("mono_cycle", build_adts(mono, 44100, 1)),
            ("stereo_cpe", build_adts(stereo, 44100, 2)),
            ("stereo_cycle", build_adts(cycle, 44100, 2)),
            ("stereo_48k", build_adts(k48, 48000, 2)),
            ("intensity", build_adts(intensity, 44100, 2)),
            ("mono_24k", build_adts(k24, 24000, 1)))


def _close_aac(got, want, atol=1e-5):
    assert got.samples.shape == want.samples.shape
    assert got.sample_rate == want.sample_rate
    assert got.samples.dtype == np.float32
    np.testing.assert_allclose(got.samples, want.samples, atol=atol, rtol=0)


class TestAacSlice:
    @pytest.mark.parametrize("i", range(6))
    def test_decode_bytes_matches_reference(self, i):
        name, data = _aacs()[i]
        got = port.AacBatchDecoder(device="cpu").decode_bytes(data)
        _close_aac(got, ref.AacBatchDecoder().decode_bytes(data))
        assert np.abs(got.samples).max() > 0

    def test_decode_many_groups_rates_like_reference(self, monkeypatch):
        # 44.1 and 48 kHz share their scalefactor bands, so one dispatch;
        # 24 kHz is a second group.
        datas = [d for _, d in _aacs()]
        groups = []
        real = port.AacBatchDecoder._dispatch_merged
        monkeypatch.setattr(
            port.AacBatchDecoder, "_dispatch_merged",
            lambda self, bl, group, res: (groups.append(len(group)),
                                          real(self, bl, group, res)))
        merged = port.AacBatchDecoder(device="cpu").decode_many(datas)
        assert sorted(groups) == [1, 5]
        want = ref.AacBatchDecoder().decode_many(datas)
        for got, w in zip(merged, want):
            _close_aac(got, w)
        assert [m.sample_rate for m in merged] == (
            [44100] * 3 + [48000, 44100, 24000])

    def test_decode_many_equals_each_alone(self):
        # Guards the copy out of the pooled extraction buffers: the second
        # stream's extraction must not overwrite the first's lanes.
        a, b = _aacs()[1][1], _aacs()[2][1]
        dec = port.AacBatchDecoder(device="cpu")
        both = dec.decode_many([a, b])
        for got, d in zip(both, (a, b)):
            # The CPU product sums in another order for another row count.
            _close_aac(got, dec.decode_bytes(d), atol=1e-6)

    def test_surround_5p1(self):
        from test_aac import TestSurroundLayouts

        data = TestSurroundLayouts()._stream_5p1()
        got = port.decode_bytes(data, device="cpu")
        assert got.samples.shape == (6, 8192)
        _close_aac(got, ref.AacBatchDecoder().decode_bytes(data))

    def test_m4a_container(self):
        from test_mp4 import build_m4a

        rng = np.random.default_rng(41)
        frames = [build_raw_block([random_quant_spectrum(rng, 40, 44100)],
                                  [0], 40, 140, 44100) for _ in range(6)]
        data = build_m4a(frames, 44100, 1)
        got = port.decode_many([data], device="cpu")[0]
        _close_aac(got, ref.AacBatchDecoder().decode_bytes(data))

    def test_native_less_oracle_path(self, monkeypatch):
        from symphonia_tpu_torch import native

        data = _aacs()[2][1]
        want = ref.AacBatchDecoder().decode_bytes(data)
        monkeypatch.setattr(native, "available", lambda: False)

        def refuse(*a, **k):
            raise AssertionError("native extraction used")

        monkeypatch.setattr(native, "aac_extract", refuse)
        _close_aac(port.AacBatchDecoder(device="cpu").decode_bytes(data),
                   want)

    @pytest.mark.parametrize("name", ["aac_44k_mono", "aac_48k_stereo"])
    def test_golden_pcm(self, name):
        # The entries of test_golden_pcm.corpus(), built the same way.
        rate, ch, seed = {"aac_44k_mono": (44100, 1, 103),
                          "aac_48k_stereo": (48000, 2, 104)}[name]
        rng = np.random.default_rng(seed)
        frames = [build_raw_block(
            [random_quant_spectrum(rng, 40, rate) for _ in range(ch)],
            [0] * ch, 40, 140, rate) for _ in range(6)]
        got = port.decode_bytes(build_adts(frames, rate, ch), device="cpu")
        with np.load(GOLDEN) as g:
            want = g[f"{name}__pcm"]
            assert got.sample_rate == int(g[f"{name}__rate"])
        assert got.samples.shape == want.shape
        np.testing.assert_allclose(got.samples, want, atol=1e-5, rtol=0)


HOUSE_OGG = HOUSE_MP3.with_suffix(".ogg")


@functools.lru_cache(maxsize=None)
def _vorbis():
    """(name, bytes): house_lo.ogg (mono, one block size) and short stereo
    builder streams, tamed as chip_smoke.py builds them, at 44.1 kHz with
    blocks of 256/2048 and at 48 kHz with 512/4096."""
    from symphonia_tpu_torch.testing.vorbis_stream import build_vorbis

    return (("house", HOUSE_OGG.read_bytes()),
            ("b44k_a", build_vorbis(44100, 8, 11, 1.0, 31)),
            ("b44k_b", build_vorbis(44100, 8, 11, 1.5, 32)),
            ("b48k", build_vorbis(48000, 9, 12, 1.0, 33)))


def _close_vorbis(got, want, name):
    assert got.samples.shape == want.samples.shape
    assert got.sample_rate == want.sample_rate
    assert got.samples.dtype == np.float32
    atol = (1e-5 if name == "house"
            else 1e-6 * max(1.0, float(np.abs(want.samples).max())))
    np.testing.assert_allclose(got.samples, want.samples, atol=atol, rtol=0)


class TestVorbisSlice:
    @pytest.mark.parametrize("i", range(4))
    def test_decode_bytes_matches_reference(self, i):
        name, data = _vorbis()[i]
        got = port.VorbisBatchDecoder(device="cpu").decode_bytes(data)
        _close_vorbis(got, _ref_one(data), name)
        assert np.abs(got.samples).max() > 0

    def test_decode_many_merged_equals_per_file(self):
        # Lanes of every stream share one IMDCT per block size (four sizes
        # here); each stream's output is the bits of its own decode.
        names, datas = zip(*_vorbis())
        dec = port.VorbisBatchDecoder(device="cpu")
        merged = dec.decode_many(list(datas) + [datas[1]])
        for d, got in zip(list(datas) + [datas[1]], merged):
            np.testing.assert_array_equal(got.samples,
                                          dec.decode_bytes(d).samples)
        for name, got, want in zip(names, merged, ref.decode_many(datas)):
            _close_vorbis(got, want, name)

    def test_lane_chunks_equal_one_chunk(self, monkeypatch):
        from symphonia_tpu_torch.ops import vorbis_dense

        data = _vorbis()[2][1]
        want = port.VorbisBatchDecoder(device="cpu").decode_bytes(data)
        monkeypatch.setattr(vorbis_dense, "LANE_CHUNK", 7)
        got = port.VorbisBatchDecoder(device="cpu").decode_bytes(data)
        np.testing.assert_array_equal(got.samples, want.samples)

    def test_native_less_oracle_path(self, monkeypatch):
        from symphonia_tpu_torch import native

        name, data = _vorbis()[1]
        want = _ref_one(data)
        monkeypatch.setattr(native, "vorbis_decode_spectra",
                            lambda *a: None)
        monkeypatch.setenv("SYMPHONIA_TPU_VORBIS_STREAM", "off")
        before = port.host_routes
        got = port.VorbisBatchDecoder(device="cpu").decode_bytes(data)
        _close_vorbis(got, want, name)
        assert port.host_routes == before

    def test_not_ogg_raises_like_reference(self):
        from symphonia_tpu.core.errors import Unsupported as RefUnsupported
        from symphonia_tpu_torch.core.errors import Unsupported

        with pytest.raises(Unsupported, match="OggS"):
            port.VorbisBatchDecoder(device="cpu").decode_bytes(_mp3s()[0])
        with pytest.raises(RefUnsupported, match="OggS"):
            ref.VorbisBatchDecoder().decode_bytes(_mp3s()[0])


@functools.lru_cache(maxsize=None)
def _l12s():
    """(name, bytes): stereo Layer I, MPEG-1 and MPEG-2 LSF Layer II streams
    as chip_smoke.py builds them, and a mono Layer II stream."""
    from chip_smoke import build_mpa_l12
    from test_layer12 import _rand_l2_frame

    return (("l1", build_mpa_l12("l1", 7, 41)),
            ("l2", build_mpa_l12("l2", 6, 42)),
            ("l2_lsf", build_mpa_l12("l2_lsf", 5, 43)),
            ("l2_mono", b"".join(_rand_l2_frame(s)[0] for s in range(4))))


class TestLayer12Slice:
    @pytest.mark.parametrize("i", range(4))
    def test_decode_bytes_runs_l1_and_matches_reference(self, i, monkeypatch):
        from symphonia_tpu_torch.ops import mp3_dense

        name, data = _l12s()[i]
        widths = []
        real = mp3_dense.mpa_l12_synth
        monkeypatch.setattr(mp3_dense, "mpa_l12_synth", lambda *a: (
            widths.append(a[0].shape[3]), real(*a))[1])
        before = port.host_routes
        got = port.decode_bytes(data, device="cpu")
        assert widths and set(widths) == {12 if name == "l1" else 36}
        assert port.host_routes == before
        _close_mp3(got, _ref_one(data))
        assert got.samples.dtype == np.float32
        assert np.abs(got.samples).max() > 0

    def test_frame_chunks_chain(self):
        # Chunks of two Layer I frames: the carried tail reaches two frames.
        data = _l12s()[0][1]
        a = port.Mp3BatchDecoder(device="cpu", granule_chunk=2)
        b = port.Mp3BatchDecoder(device="cpu")
        _close_mp3(a.decode_bytes(data), b.decode_bytes(data), atol=1e-6)

    def test_ungapless_matches_reference(self):
        data = _l12s()[1][1]
        got = port.Mp3BatchDecoder(device="cpu", gapless=False).decode_bytes(
            data)
        _close_mp3(got, ref.Mp3BatchDecoder(gapless=False).decode_bytes(data))

    def test_native_less_stream_takes_counted_host_route(self, monkeypatch):
        from symphonia_tpu import native as ref_native
        from symphonia_tpu_torch import native

        data = _l12s()[1][1]
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(ref_native, "available", lambda: False)
        want = ref.Mp3BatchDecoder().decode_bytes(data)  # its fallback
        before = port.host_routes
        got = port.decode_bytes(data, device="cpu")
        assert port.host_routes == before + 1
        _close_mp3(got, want, atol=0)

    def test_channel_change_takes_counted_host_route(self):
        from test_layer12 import _rand_l2_frame

        data = b"".join(_rand_l2_frame(s, n_ch=1 + s % 2)[0]
                        for s in range(4))
        before = port.host_routes
        got = port.Mp3BatchDecoder(device="cpu").decode_bytes(data)
        assert port.host_routes == before + 1
        _close_mp3(got, ref.Mp3BatchDecoder().decode_bytes(data), atol=0)


class TestFacade:
    def test_mixed_batch_keeps_input_order(self):
        flacs = _flacs()
        mp3s = _mp3s()
        datas = [flacs[0][0], mp3s[0], flacs[1][0], mp3s[3], mp3s[1]]
        outs = port.decode_many(datas, device="cpu", verify=True)
        for d, got in zip(datas, outs):
            one = port.decode_bytes(d, device="cpu", verify=True)
            if got.samples.dtype == np.int32:
                _same_flac(got, one)
                assert got.md5_ok is True
            else:
                _close_mp3(got, one, atol=1e-6)
        for d, got in zip(datas, outs):
            if got.samples.dtype == np.int32:
                _same_flac(got, _ref_one(d, True))
            else:
                _close_mp3(got, _ref_one(d))

    def test_mixed_batch_with_aac_keeps_input_order(self):
        flacs, mp3s, aacs = _flacs(), _mp3s(), _aacs()
        datas = [aacs[3][1], flacs[0][0], aacs[0][1], mp3s[0], aacs[2][1]]
        outs = port.decode_many(datas, device="cpu", verify=True)
        for d, got in zip(datas, outs):
            one = port.decode_bytes(d, device="cpu", verify=True)
            if got.samples.dtype == np.int32:
                _same_flac(got, one)
            else:
                _close_mp3(got, one, atol=1e-6)
        assert outs[1].md5_ok is True
        _close_aac(outs[2], ref.AacBatchDecoder().decode_bytes(datas[2]))

    def test_mixed_batch_of_every_slice_keeps_input_order(self):
        kinds = ["vorbis", "flac", "l1", "mp3", "aac", "l2", "vorbis"]
        datas = [_vorbis()[1][1], _flacs()[0][0], _l12s()[0][1], _mp3s()[0],
                 _aacs()[2][1], _l12s()[1][1], _vorbis()[3][1]]
        outs = port.decode_many(datas, device="cpu", verify=True)
        for kind, d, got in zip(kinds, datas, outs):
            one = port.decode_bytes(d, device="cpu", verify=True)
            if kind == "flac":
                _same_flac(got, one)
                assert got.md5_ok is True
            elif kind == "vorbis":
                np.testing.assert_array_equal(got.samples, one.samples)
                _close_vorbis(got, _ref_one(d), kind)
            else:
                _close_mp3(got, one, atol=1e-6)
                if kind != "aac":
                    _close_mp3(got, _ref_one(d))

    def test_decode_file(self, tmp_path):
        data, src = _flacs()[3]
        p = tmp_path / "a.flac"
        p.write_bytes(data)
        got = port.decode_file(str(p), device="cpu", verify=True)
        np.testing.assert_array_equal(got.samples, src)
        _same_flac(got, _ref_one(data, True))
        q = tmp_path / "b.mp3"
        q.write_bytes(_mp3s()[2])
        _close_mp3(port.decode_file(str(q), device="cpu"),
                   _ref_one(_mp3s()[2]))
        dec = port.FlacBatchDecoder(device="cpu")
        _same_flac(dec.decode_files([str(p)])[0], dec.decode_file(str(p)))

    def test_decode_file_vorbis_and_layer2(self, tmp_path):
        name, data = _vorbis()[3]
        p = tmp_path / "a.ogg"
        p.write_bytes(data)
        got = port.decode_file(str(p), device="cpu")
        _close_vorbis(got, _ref_one(data), name)
        np.testing.assert_array_equal(
            port.VorbisBatchDecoder(device="cpu").decode_file(str(p)).samples,
            got.samples)
        q = tmp_path / "b.mp2"
        q.write_bytes(_l12s()[2][1])
        _close_mp3(port.decode_file(str(q), device="cpu"),
                   _ref_one(_l12s()[2][1]))
