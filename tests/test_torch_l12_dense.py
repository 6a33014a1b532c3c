"""Layer I/II dense stage of the PyTorch port against the JAX reference.

Subband samples are drawn at x0.1 (the MP3 tests' scale, test_mp3.py:213);
the parity bar is the reference's own: atol 2e-5 against the JAX stage
(test_layer12.py:574,597), 1e-6 for chained calls against one call."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu.ops.mp3_dense import (_polyphase_combined_matrix,
                                         l12_dense_batch_jax,
                                         polyphase_response_np)
from symphonia_tpu_torch.ops import mp3_dense as port

TABLES = port.l12_tables()


def _inputs(seed, F, C, T):
    rng = np.random.default_rng(seed)
    sb = (rng.standard_normal((F, C, 32, T)) * 0.1).astype(np.float32)
    tail = (rng.standard_normal((C, 480)) * 0.1).astype(np.float32)
    return sb, tail


def _ref(sb, tail=None):
    out = l12_dense_batch_jax(jnp.asarray(sb),
                              None if tail is None else jnp.asarray(tail))
    return [np.asarray(o) for o in out]


def _port(dense, sb, tail=None):
    t = None if tail is None else port.L12Dense.state_from_numpy(tail, "cpu")
    return [o.numpy() for o in dense(torch.from_numpy(sb), t)]


@pytest.fixture(scope="module")
def dense():
    return port.L12Dense.from_numpy(TABLES, "cpu")


@pytest.mark.parametrize("T", [12, 36])
@pytest.mark.parametrize("F", [1, 2, 3, 17])
@pytest.mark.parametrize("with_tail", [False, True])
def test_matches_jax(dense, T, F, with_tail):
    sb, tail = _inputs(100 * T + 2 * F + with_tail, F, 2, T)
    if not with_tail:
        tail = None
    want = _ref(sb, tail)
    got = _port(dense, sb, tail)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)


@pytest.mark.parametrize("T,cuts", [(12, [1, 2, 4]), (12, [3]), (36, [1, 5])])
def test_chained_calls_equal_one_call(dense, T, cuts):
    # Layer I chunks of one and two frames: the 480-sample tail reaches
    # past the chunk (384 samples a frame) into the next call's second frame.
    sb, tail = _inputs(7 + T, 9, 2, T)
    full, full_tail = _port(dense, sb, tail)
    parts, st, a = [], tail, 0
    for b in cuts + [9]:
        p, st = _port(dense, sb[a:b], st)
        parts.append(p)
        a = b
    np.testing.assert_allclose(np.concatenate(parts), full, atol=1e-6, rtol=0)
    np.testing.assert_allclose(st, full_tail, atol=1e-6, rtol=0)


@pytest.mark.parametrize("T", [12, 36])
def test_state_handed_over_from_reference(dense, T):
    # Chunk 1 runs on the reference; its carried tail goes through numpy
    # into the port, which decodes chunk 2.
    sb, _ = _inputs(30 + T, 8, 2, T)
    full = _port(dense, sb)[0]
    a, tail = _ref(sb[:3])
    b, tail2 = _port(dense, sb[3:], tail)
    np.testing.assert_allclose(np.concatenate([a, b]), full, atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tail2, _ref(sb[3:], tail)[1], atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("T", [12, 36])
def test_matches_numpy_polyphase_oracle(dense, T):
    # The reference's numpy polyphase over the concatenated frames of one
    # channel, zero initial state.
    sb, _ = _inputs(50 + T, 5, 1, T)
    want = polyphase_response_np(np.concatenate(list(sb[:, 0]), axis=1))
    pcm, tail = _port(dense, sb)
    np.testing.assert_allclose(pcm.reshape(-1), want[: 5 * 32 * T],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(tail[0], want[5 * 32 * T :], atol=2e-5,
                               rtol=0)


def test_tables_are_the_reference_matrices_in_sb_order():
    # The factors rebuild the reference's combined matrix, whose column
    # t*32 + k is sb's k*T + t: block (slot m, slot t) = diag(W[m - t]) .
    # N[i + 32 ((m - t) & 1)] for 0 <= m - t < 16, in f64 then cast.
    N = TABLES["matrixing"].astype(np.float64)
    W = TABLES["window"].astype(np.float64)
    i = np.arange(32)
    for T in (12, 36):
        m = _polyphase_combined_matrix(T)
        assert m.shape == ((T + 15) * 32, 32 * T)
        k, t = 5, T - 1  # subband k, sample t
        col = np.zeros((T + 15) * 32)
        for j in range(16):
            col[(t + j) * 32 + i] = W[j] * N[i + 32 * (j & 1), k]
        np.testing.assert_array_equal(col.astype(np.float32),
                                      m[:, t * 32 + k])


def test_buffers_and_state_roundtrip(dense):
    assert {n for n, _ in dense.named_buffers()} == {"matrixing", "window"}
    np.testing.assert_array_equal(dense.matrixing.numpy(),
                                  TABLES["matrixing"])
    np.testing.assert_array_equal(dense.window.numpy(), TABLES["window"])
    tail = np.random.default_rng(8).standard_normal((2, 480)).astype(
        np.float32)
    t = port.L12Dense.state_from_numpy(tail, "cpu")
    np.testing.assert_array_equal(port.L12Dense.state_to_numpy(t), tail)


def test_wrapper_runs_twin_on_cpu_and_checks_shapes(dense):
    sb, tail = _inputs(9, 4, 2, 12)
    args = (torch.from_numpy(sb), dense.matrixing, dense.window,
            torch.from_numpy(tail))
    for a, b in zip(port.mpa_l12_synth(*args), port.l12_synth_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        dense(torch.zeros((0, 2, 32, 12)))
    with pytest.raises(ValueError):
        dense(torch.zeros((2, 2, 32, 18)))  # Layer III granules: not L1's
