"""FLAC dense stage of the PyTorch port against the JAX reference, on CPU.

The port's wrappers run their plain PyTorch twins on CPU tensors; every
comparison here is exact (the FLAC path is integer and bit-exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import symphonia_tpu.codecs.flac as ref_codec
import symphonia_tpu.core.io as ref_io
import symphonia_tpu.formats.flac as ref_format
import symphonia_tpu_torch.codecs.flac as port_codec
import symphonia_tpu_torch.core.io as port_io
import symphonia_tpu_torch.formats.flac as port_format
from symphonia_tpu.codecs.flac import lpc_reconstruct
from symphonia_tpu.ops import flac_dense as ref
from symphonia_tpu_torch.ops import flac_dense as port

from flac_builder import build_flac_file, random_walk


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_lpc(res, coefs, order, shift, n):
    return np.asarray(ref.lpc_reconstruct_batch(
        jnp.asarray(res), jnp.asarray(coefs), jnp.asarray(order),
        jnp.asarray(shift), n))


def _port_lpc(res, coefs, order, shift, n, wasted=None):
    return port.lpc_reconstruct_batch(
        _t(res), _t(coefs), _t(order), _t(shift), n,
        wasted=None if wasted is None else _t(wasted)).numpy()


def _frames(data, of_port: bool):
    """The parsed frames of ``data``, by the port's host stage or by the
    reference's: each package packs only its own frames."""
    fmt, io, codec = ((port_format, port_io, port_codec) if of_port
                      else (ref_format, ref_io, ref_codec))
    reader = fmt.FlacReader(io.MediaSourceStream(data))
    frames = []
    while True:
        p = reader.next_packet()
        if p is None:
            return frames
        frames.append(codec.parse_frame(p.data, reader.stream_info))


class TestLpcVsReference:
    def test_random_lpc_lanes_match_oracle_and_reference(self):
        # The reference's own oracle case (test_flac_tpu.py:82).
        rng = np.random.default_rng(3)
        L, N = 16, 256
        res = np.zeros((L, N), np.int32)
        coefs = np.zeros((L, 32), np.int32)
        orders = np.zeros(L, np.int32)
        shifts = np.zeros(L, np.int32)
        oracle = np.zeros((L, N), np.int64)
        for l in range(L):
            k = int(rng.integers(1, 33))
            sh = int(rng.integers(0, 15))
            c = rng.integers(-(2**14), 2**14, size=k)
            x = np.clip(np.cumsum(rng.integers(-100, 101, size=N)),
                        -30000, 30000)
            x[:k] = rng.integers(-(2**15), 2**15, size=k)
            r = np.empty(N - k, np.int64)
            for i in range(k, N):
                acc = sum(int(c[j]) * int(x[i - 1 - j]) for j in range(k))
                r[i - k] = int(x[i]) - (acc >> sh)
            orders[l], shifts[l] = k, sh
            coefs[l, :k] = c
            res[l, :k] = x[:k]
            res[l, k:] = r
            oracle[l] = lpc_reconstruct(x[:k], r, c, sh)
        got = _port_lpc(res, coefs, orders, shifts, N)
        np.testing.assert_array_equal(got, oracle.astype(np.int32))
        np.testing.assert_array_equal(
            got, _ref_lpc(res, coefs, orders, shifts, N))

    def test_wrapping_ranges_match_reference(self):
        # Samples +-2^25, coefficients +-2^14, orders 0-32, shifts 0-15:
        # the recurrence leaves int32 and both sides must wrap identically.
        rng = np.random.default_rng(4)
        L, N = 24, 96
        res = rng.integers(-2**25, 2**25, size=(L, N)).astype(np.int32)
        coefs = rng.integers(-2**14, 2**14, size=(L, 32)).astype(np.int32)
        order = rng.integers(0, 33, size=L).astype(np.int32)
        shift = rng.integers(0, 16, size=L).astype(np.int32)
        np.testing.assert_array_equal(
            _port_lpc(res, coefs, order, shift, N),
            _ref_lpc(res, coefs, order, shift, N))

    @pytest.mark.parametrize("extreme", [2**31 - 1, -(2**31), 0x7FFF,
                                         -0x8000])
    def test_int64_edge_products(self, extreme):
        # The limb emulation's edge cases (test_flac_tpu.py:43): products
        # near +-2^62, sums modulo 2^64, every shift 0-31.
        rng = np.random.default_rng(extreme & 0xFFFF)
        L, N = 32, 40
        res = np.full((L, N), extreme, np.int64)
        res[:, 1::3] = -(2**31)
        res[:, 2::5] = 2**31 - 1
        coefs = np.full((L, 32), extreme, np.int64)
        coefs[:, 1::2] = -(2**31)
        order = rng.integers(1, 33, size=L)
        shift = np.arange(L) % 32
        args = [a.astype(np.int32) for a in (res, coefs, order, shift)]
        np.testing.assert_array_equal(_port_lpc(*args, N),
                                      _ref_lpc(*args, N))

    def test_shifts_0_to_31_where_result_fits(self):
        # One product per lane (order 1), value in [-2^45, 2^45] with the
        # shifted result inside int32, as i64_shr_to_i32's contract says.
        rng = np.random.default_rng(2)
        L = 512
        c = rng.integers(-(2**15), 2**15, size=L)
        x0 = rng.integers(-(2**30), 2**30, size=L)
        shift = rng.integers(0, 32, size=L)
        keep = ((c * x0) >> shift >= -(2**31)) & ((c * x0) >> shift < 2**31)
        c, x0, shift = c[keep], x0[keep], shift[keep]
        L = len(c)
        res = np.zeros((L, 2), np.int32)
        res[:, 0] = x0
        coefs = np.zeros((L, 32), np.int32)
        coefs[:, 0] = c
        order = np.ones(L, np.int32)
        got = _port_lpc(res, coefs, order, shift.astype(np.int32), 2)
        np.testing.assert_array_equal(got[:, 1], ((c * x0) >> shift)
                                      .astype(np.int32))
        np.testing.assert_array_equal(
            got, _ref_lpc(res, coefs, order, shift.astype(np.int32), 2))

    def test_row_stride_n_max_plus_16(self):
        # Native extraction pads rows to n_max + 16: the port reads the
        # first n_samples columns of each longer row.
        rng = np.random.default_rng(5)
        L, n = 12, 64
        res = rng.integers(-2**20, 2**20, size=(L, n + 16)).astype(np.int32)
        coefs = rng.integers(-2**10, 2**10, size=(L, 32)).astype(np.int32)
        order = rng.integers(0, 33, size=L).astype(np.int32)
        shift = rng.integers(0, 16, size=L).astype(np.int32)
        got = _port_lpc(res, coefs, order, shift, n)
        assert got.shape == (L, n)
        np.testing.assert_array_equal(
            got, _ref_lpc(res[:, :n], coefs, order, shift, n))
        np.testing.assert_array_equal(
            got, _port_lpc(res[:, :n], coefs, order, shift, n))

    def test_wasted_bits_match_reference(self):
        rng = np.random.default_rng(6)
        x = rng.integers(-2**31, 2**31, size=(40, 9)).astype(np.int32)
        w = np.arange(40, dtype=np.int32) % 32
        got = port.apply_wasted_bits(_t(x), _t(w)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref.apply_wasted_bits(jnp.asarray(x),
                                                  jnp.asarray(w))))
        # The wrapper fuses the same shift after the recurrence.
        zeros = np.zeros((40, 32), np.int32)
        o = np.zeros(40, np.int32)
        np.testing.assert_array_equal(
            _port_lpc(x, zeros, o, o, 9, wasted=w), got)

    def test_decorrelate_matches_reference(self):
        rng = np.random.default_rng(7)
        x = rng.integers(-2**31, 2**31, size=(64, 2, 33)).astype(np.int32)
        a = (np.arange(64) % 5).astype(np.int32)  # code 4: pass through
        got = port.decorrelate_batch(_t(x), _t(a)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref.decorrelate_batch(jnp.asarray(x),
                                                  jnp.asarray(a))))

    def test_unsupported_device_raises(self):
        res = torch.zeros((2, 8), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            port.lpc_reconstruct_batch(res, res, res[:, 0], res[:, 0], 8)


PIPELINE_CASES = [
    ("independent", "fixed", dict(order=2)),
    ("mid_side", "fixed", dict(order=3)),
    ("left_side", "lpc", dict(lpc_coefs=[700, -300, 100, 22], lpc_shift=9,
                              lpc_precision=12)),
    ("right_side", "lpc", dict(lpc_coefs=list(range(1, 13)), lpc_shift=8,
                               lpc_precision=12)),
    ("mid_side", "verbatim", dict()),
    ("independent", "constant", dict()),
]


class TestPipelineVsReference:
    @pytest.mark.parametrize("mode,kind,kw", PIPELINE_CASES)
    def test_decode_packed(self, mode, kind, kw):
        ch = random_walk(1024, 16, seed=len(mode) * 7 + len(kind), ch=2)
        if kind == "constant":
            ch = [np.full(1024, 55, np.int64), np.full(1024, -7, np.int64)]
        data = build_flac_file(ch, block_size=256, stereo_mode=mode,
                               kind=kind, **kw)
        frames = _frames(data, True)
        pk_port = port.pack_parsed_frames(frames)
        pk_ref = ref.pack_parsed_frames(_frames(data, False))
        got = port.decode_packed(pk_port, "cpu")
        np.testing.assert_array_equal(got, ref.decode_packed(pk_ref))
        pcm = np.concatenate([got[i, :, : f.header.block_size]
                              for i, f in enumerate(frames)], axis=1)
        np.testing.assert_array_equal(pcm, np.stack(ch).astype(np.int32))

    def test_wasted_bits_pipeline(self):
        ch = [c << 3 for c in random_walk(512, 13, seed=77)]
        data = build_flac_file(ch, block_size=256, kind="fixed", order=2,
                               wasted=3)
        got = port.decode_packed(
            port.pack_parsed_frames(_frames(data, True)), "cpu")
        np.testing.assert_array_equal(
            got, ref.decode_packed(ref.pack_parsed_frames(
                _frames(data, False))))
        np.testing.assert_array_equal(got[:, 0].reshape(-1),
                                      np.asarray(ch[0], np.int32))

    @pytest.mark.parametrize("n_max", [None, 1040])
    def test_pack_parsed_frames_equals_reference(self, n_max):
        chans = random_walk(1500, 16, seed=8, ch=2)
        datas = [build_flac_file(
            [c[:500] for c in chans], block_size=256, stereo_mode=mode,
            kind=kind, **kw) for mode, kind, kw in PIPELINE_CASES[:5]]
        datas.append(build_flac_file([c << 2 for c in random_walk(
            300, 14, seed=9)], block_size=300, kind="fixed", order=1,
            wasted=2))
        a = port.pack_parsed_frames(
            [f for d in datas for f in _frames(d, True)], n_max=n_max)
        b = ref.pack_parsed_frames(
            [f for d in datas for f in _frames(d, False)], n_max=n_max)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
        np.testing.assert_array_equal(port.FIXED_COEFS_PAD,
                                      ref.FIXED_COEFS_PAD)
