"""Vorbis dense stage of the PyTorch port against the JAX reference.

The IMDCT twin is held to the reference's jitted ``_imdct_jax`` on the same
numpy-seeded spectra, across the Vorbis block sizes, within 1e-6 of the
larger of 1 and the output's peak (the Vorbis bar: builder streams peak
near 1e3-1e4, and sums of up to 4096 fp32 terms round in proportion)."""

import numpy as np
import pytest
import torch

from symphonia_tpu.codecs.vorbis import imdct_matrix
from symphonia_tpu.ops import vorbis_dense as ref
from symphonia_tpu_torch.ops import vorbis_dense as port


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    bar = 1e-6 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=bar, rtol=0)


def _spectra(seed, L, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, n // 2)) * 100.0).astype(np.float32)


@pytest.fixture(scope="module")
def dense():
    return port.VorbisDense({}, "cpu")


@pytest.mark.parametrize("n", [64, 128, 256, 512, 2048, 8192])
def test_imdct_twin_matches_jax(n):
    x = _spectra(n, 5, n)
    want = np.asarray(ref._imdct_jax(n)(x))
    got = port.vorbis_imdct_plain(torch.from_numpy(x),
                                  torch.from_numpy(imdct_matrix(n))).numpy()
    _close(got, want)


def test_wrapper_runs_twin_on_cpu(dense):
    x = torch.from_numpy(_spectra(1, 7, 256))
    m = dense.matrix(256)
    assert torch.equal(port.vorbis_imdct(x, m),
                       port.vorbis_imdct_plain(x, m))
    with pytest.raises(ValueError):
        port.vorbis_imdct(torch.zeros((0, 128)), m)


def test_matrices_are_lazy_buffers_of_the_reference():
    d = port.VorbisDense({}, "cpu")
    assert not dict(d.named_buffers())
    np.testing.assert_array_equal(d.matrix(512).numpy(), imdct_matrix(512))
    assert {n for n, _ in d.named_buffers()} == {"imdct_512"}
    with pytest.raises(ValueError):
        d.matrix(96)
    e = port.VorbisDense.from_numpy({256: imdct_matrix(256)}, "cpu")
    np.testing.assert_array_equal(e.imdct_256.numpy(), imdct_matrix(256))


def test_imdct_group_any_lane_count_and_chunks(dense, monkeypatch):
    # 13 lanes: the reference pads to a power-of-two bucket, the port does
    # not; chunks of 4 lanes give the very bits of one chunk.
    x = _spectra(2, 13, 2048)
    got = port.imdct_group(x, 2048, dense=dense)
    _close(got, ref.imdct_group(x, 2048))
    monkeypatch.setattr(port, "LANE_CHUNK", 4)
    np.testing.assert_array_equal(port.imdct_group(x, 2048, dense=dense), got)
    assert port.imdct_group(x[:0], 2048, dense=dense).shape == (0, 2048)


def _job(seed, n_packets, C, bs0, bs1):
    rng = np.random.default_rng(seed)
    flags = [bool(f) for f in rng.integers(0, 2, n_packets)]
    if n_packets >= 4:
        flags[1:4] = [True, False, True]  # both lapping transitions
    # Spectra of n/2 lines, as the native entropy stage returns for long
    # blocks and the oracle for both (the dense stage slices to n/2).
    spectra = [(rng.standard_normal((C, (bs1 if f else bs0) // 2)) * 10.0)
               .astype(np.float32) for f in flags]
    return spectra, flags, bs0, bs1


def test_decode_packets_dense_multi_matches_reference(dense):
    jobs = [_job(3, 9, 2, 256, 2048), _job(4, 6, 1, 256, 2048),
            ([], [], 256, 2048), _job(5, 5, 2, 512, 4096)]
    got = port.decode_packets_dense_multi(jobs, dense=dense)
    want = ref.decode_packets_dense_multi(jobs)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)
    assert got[2].shape == (1, 0)
    # Merged equals each job alone, bit for bit.
    for job, g in zip(jobs, got):
        np.testing.assert_array_equal(
            port.decode_packets_dense(*job, dense=dense), g)


def test_decode_packets_dense_single_packet_gives_no_samples(dense):
    spectra, flags, bs0, bs1 = _job(6, 1, 2, 256, 2048)
    out = port.decode_packets_dense(spectra, flags, bs0, bs1, dense=dense)
    assert out.shape == (2, 0)
