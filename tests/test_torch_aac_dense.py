"""AAC-LC dense stage of the PyTorch port against the JAX reference.

The dequantization and the window/overlap-add must be bit-exact (the
reference asserts both exactly: test_aac.py:353, :491, and the host twin
``native.aac_dequant_host``); the IMDCT within 1e-5 absolute at the
reference tests' coefficient scale (x0.1, test_aac.py:349), relative to the
output's peak where escape-range quants push it above 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu import native
from symphonia_tpu.codecs.aac import imdct_matrix_scaled, subband_info
from symphonia_tpu.ops import aac_dense as ref
from symphonia_tpu_torch.ops import aac_dense as port

_, BANDS_LONG, _ = subband_info(44100)
TABLES = port.reference_tables()


@pytest.fixture(scope="module")
def dense():
    return port.AacDense.from_numpy(TABLES, "cpu")


def _quant(rng, n, stale_rows=()):
    """Handoff operands at the entropy stage's scales: Laplacian quants
    with escape-range values up to +-8191 (and the int16 extremes), scales
    2^((sf - 100) / 4) with some uncoded (zero) bands. ``stale_rows`` get
    deq = 1 with quants and scales whose product overflows to inf."""
    qbuf = np.clip(np.rint(rng.laplace(0.0, 4.0, (n, 1024))), -60, 60)
    qbuf = qbuf.astype(np.int16)
    qbuf[0, :18] = [8191, -8191, 8190, -4096, 4095, 2048, -2047, 64, -64,
                    63, -63, 127, -128, 1, -1, 0, 32767, -32768]
    esc = rng.integers(0, n * 1024, 16)
    qbuf.reshape(-1)[esc] = rng.integers(-8191, 8192, 16)
    scales = np.exp2((rng.integers(60, 100, (n, 64)) - 100) / 4.0)
    scales = scales.astype(np.float32)
    scales[:, rng.integers(0, 49, 6)] = 0.0
    deq = np.zeros(n, np.int32)
    coeffs = (rng.standard_normal((n, 1024)) * 0.1).astype(np.float32)
    for r in stale_rows:
        deq[r] = 1
        qbuf[r] = 8191
        scales[r] = 3e38
    return coeffs, qbuf, scales, deq


class TestDequant:
    def test_twin_bit_exact_with_host_and_jax(self):
        rng = np.random.default_rng(1)
        coeffs, qbuf, scales, deq = _quant(rng, 8, stale_rows=(3, 6))
        got = port.dequant_select(coeffs, qbuf, scales, deq, BANDS_LONG,
                                  device="cpu")
        assert np.isfinite(got).all()
        host = native.aac_dequant_host(
            {"coeffs": coeffs[:, None], "qbuf": qbuf[:, None],
             "scales": scales[:, None], "deq": deq[:, None]},
            BANDS_LONG)[:, 0]
        # Bit for bit, signs of zero included.
        np.testing.assert_array_equal(got.view(np.int32), host.view(np.int32))
        fn = ref._dequant_jax(tuple(int(b) for b in BANDS_LONG))
        want = np.asarray(fn(jnp.asarray(coeffs), jnp.asarray(qbuf),
                             jnp.asarray(scales), jnp.asarray(deq)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, ref.dequant_select(coeffs, qbuf, scales, deq, BANDS_LONG))

    def test_leading_axes_and_all_host_lanes(self):
        rng = np.random.default_rng(2)
        coeffs, qbuf, scales, deq = _quant(rng, 6)
        deq[::2] = 1
        shaped = [a.reshape((3, 2) + a.shape[1:])
                  for a in (coeffs, qbuf, scales, deq)]
        got = port.dequant_select(*shaped, BANDS_LONG, device="cpu")
        assert got.shape == (3, 2, 1024)
        np.testing.assert_array_equal(
            got, ref.dequant_select(*shaped, BANDS_LONG))
        ones = np.ones_like(deq)
        np.testing.assert_array_equal(
            port.dequant_select(coeffs, qbuf, scales, ones, BANDS_LONG,
                                device="cpu"), coeffs)

    def test_wrapper_runs_the_twin_on_cpu(self, dense):
        rng = np.random.default_rng(3)
        coeffs, qbuf, scales, deq = _quant(rng, 4, stale_rows=(1,))
        args = (torch.from_numpy(coeffs),
                *dense.quant(torch.from_numpy(qbuf), torch.from_numpy(scales),
                             torch.from_numpy(deq), BANDS_LONG))
        np.testing.assert_array_equal(port.aac_dequant(*args).numpy(),
                                      port.aac_dequant_plain(*args).numpy())


class TestImdct:
    @pytest.mark.parametrize("handoff", [False, True])
    def test_imdct_frames_match_reference(self, handoff):
        rng = np.random.default_rng(10 + handoff)
        seqs = np.array([0, 1, 2, 2, 3, 0, 0, 2, 3, 0, 1, 2, 3])
        coeffs, qbuf, scales, deq = _quant(rng, len(seqs),
                                           stale_rows=(1, 5))
        quant = (qbuf, scales, deq, BANDS_LONG) if handoff else None
        got = port.imdct_frames(coeffs, seqs, quant, device="cpu")
        want = ref.imdct_frames(coeffs, seqs, quant)
        peak = max(1.0, max(float(np.abs(w).max()) for w in want))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-5 * peak, rtol=0)

    def test_prologue_equals_dequant_then_product(self, dense):
        rng = np.random.default_rng(12)
        coeffs, qbuf, scales, deq = _quant(rng, 5, stale_rows=(2,))
        t = torch.from_numpy
        q = dense.quant(t(qbuf), t(scales), t(deq), BANDS_LONG)
        fused = port.aac_imdct(t(coeffs), dense.imdct_long, q)
        full = port.aac_dequant(t(coeffs), *q)
        np.testing.assert_array_equal(
            fused.numpy(), port.aac_imdct(full, dense.imdct_long).numpy())
        assert torch.isfinite(fused).all()

    def test_empty_batch_raises(self, dense):
        for fn, arg in ((dense.imdct, torch.zeros((0, 1024))),
                        (lambda x: port.aac_dequant(x, *dense.quant(
                            torch.zeros((0, 1024), dtype=torch.int16),
                            torch.zeros((0, 64)),
                            torch.zeros(0, dtype=torch.int32), BANDS_LONG)),
                         torch.zeros((0, 1024)))):
            with pytest.raises(ValueError):
                fn(arg)


def _ola_inputs(rng, seqs):
    shapes = [bool(rng.integers(0, 2)) for _ in seqs]
    prevs = [bool(rng.integers(0, 2))] + shapes[:-1]
    coeffs = (rng.standard_normal((len(seqs), 1024)) * 0.1).astype(np.float32)
    pcms = ref.imdct_frames(coeffs, np.asarray(seqs))
    return pcms, shapes, prevs


class TestOla:
    def test_matches_reference_batch_and_chain(self):
        rng = np.random.default_rng(20)
        seqs = [0, 1, 2, 2, 3, 0, 0, 1, 2, 3, 0, 1, 2, 2, 2, 3]
        pcms, shapes, prevs = _ola_inputs(rng, seqs)
        got = port.window_ola_batch(pcms, seqs, shapes, prevs, device="cpu")
        np.testing.assert_array_equal(
            got, ref.window_ola_batch(pcms, seqs, shapes, prevs))
        np.testing.assert_array_equal(
            got, ref.window_ola_chain(pcms, seqs, shapes, prevs))
        assert port.window_ola_batch([], [], [], [], device="cpu").size == 0

    def test_first_mask_over_concatenated_sequences(self, dense):
        """One launch over four sequences equals the reference run per
        sequence: the OLA only couples adjacent frames of one sequence."""
        rng = np.random.default_rng(21)
        seq_list = [[0, 1, 2, 3], [2, 2, 3, 0, 1], [3], [1, 2, 2, 3, 0, 0]]
        flat, seqs, shapes, prevs, first, want = [], [], [], [], [], []
        for sq in seq_list:
            pcms, sh, pv = _ola_inputs(rng, sq)
            want.append(ref.window_ola_batch(pcms, sq, sh, pv))
            flat += [p.reshape(-1) for p in pcms]
            seqs += sq
            shapes += sh
            prevs += pv
            first += [True] + [False] * (len(sq) - 1)
        t = torch.from_numpy
        got = dense.ola(t(np.stack(flat)), t(np.asarray(seqs, np.int32)),
                        t(np.asarray(shapes, np.int32)),
                        t(np.asarray(prevs, np.int32)), t(np.asarray(first)))
        np.testing.assert_array_equal(got.numpy().reshape(-1),
                                      np.concatenate(want))


class TestAacDenseModule:
    def test_buffers_are_the_reference_tables(self, dense):
        head, delay, s_first, s_left, s_right = ref._ola_tables()
        np.testing.assert_array_equal(dense.imdct_long.numpy(),
                                      imdct_matrix_scaled(1024))
        np.testing.assert_array_equal(dense.imdct_short.numpy(),
                                      imdct_matrix_scaled(128))
        np.testing.assert_array_equal(dense.pow43.numpy(), native.aac_pow43())
        for name, tab in (("ola_head", head), ("ola_delay", delay),
                          ("ola_s_first", s_first), ("ola_s_left", s_left),
                          ("ola_s_right", s_right)):
            np.testing.assert_array_equal(getattr(dense, name).numpy(), tab)
        np.testing.assert_array_equal(
            dense.sfb_map(BANDS_LONG).numpy(),
            native.aac_sfb_map(np.asarray(BANDS_LONG)))
        assert dense.sfb_map(BANDS_LONG) is dense.sfb_map(list(BANDS_LONG))
        assert {n for n, _ in dense.named_buffers()} == set(TABLES)

    @pytest.mark.parametrize("chunk", [1, 4, 7])
    def test_decode_lanes_chunks_equal_one_call(self, dense, chunk):
        rng = np.random.default_rng(30 + chunk)
        seqs = np.array([0, 1, 2, 3, 0, 0, 1, 2, 2, 3, 0, 2, 3, 1, 2, 3],
                        np.int32)
        coeffs, qbuf, scales, deq = _quant(rng, len(seqs), stale_rows=(4,))
        deq[seqs == 2] = 1  # short frames are host-dequantized
        lanes = {"coeffs": coeffs, "qbuf": qbuf, "scales": scales,
                 "deq": deq, "seq": seqs,
                 "shape": rng.integers(0, 2, len(seqs)).astype(np.int32),
                 "prev_shape": rng.integers(0, 2, len(seqs)).astype(np.int32)}
        first = np.zeros(len(seqs), bool)
        first[[0, 6, 11]] = True
        one = dense.decode_lanes(lanes, first, BANDS_LONG)
        assert one.shape == (len(seqs), 1024) and np.isfinite(one).all()
        # The CPU product may sum in another order for another row count;
        # escape-range quants put the peak near 9.
        peak = max(1.0, float(np.abs(one).max()))
        np.testing.assert_allclose(
            dense.decode_lanes(lanes, first, BANDS_LONG, lane_chunk=chunk),
            one, atol=1e-6 * peak, rtol=0)
