"""The port's batch decode slice (FLAC + MP3 Layer III) on CPU against the
JAX reference's ``symphonia_tpu.batch``: FLAC exact with equal MD5 verdicts,
MP3 within the reference's dense-stage bar (atol 2e-5)."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

from symphonia_tpu import batch as ref
from symphonia_tpu_torch import batch as port

from flac_builder import build_flac_file, random_walk
from mp3_builder import build_mpeg1_l3_stream

# A real MPEG-2.5 mono file that ships with pygame's examples.
HOUSE_MP3 = pathlib.Path(importlib.util.find_spec(
    "pygame").submodule_search_locations[0]) / "examples/data/house_lo.mp3"


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
