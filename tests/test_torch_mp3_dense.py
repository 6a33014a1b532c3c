"""MP3 Layer III dense stage of the PyTorch port against the JAX reference.

Spectra are drawn at the reference tests' scale (x0.1, test_mp3.py:213);
the parity bar is the reference's own: atol 2e-5 against the JAX stage,
1e-6 for chained chunks against one call (test_mp3.py:231,253)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu.ops.mp3_dense import (GranuleDenseState, granule_dense_np,
                                         mp3_dense_batch_jax)
from symphonia_tpu_torch.ops import mp3_dense as port

TABLES = port.reference_tables()


def _inputs(seed, G, C, all_types=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((G, C, 576)) * 0.1).astype(np.float32)
    if all_types:
        # Every block type, and at least one mixed and one plain short block.
        bt = (np.arange(G * C).reshape(G, C) + rng.integers(0, 4)) % 4
        mixed = (bt == 2) & (rng.random((G, C)) < 0.5)
        shorts = np.argwhere(bt == 2)
        mixed[tuple(shorts[0])] = True
        mixed[tuple(shorts[-1])] = False
    else:
        bt = np.zeros((G, C))
        mixed = np.zeros((G, C), bool)
    ht = (rng.standard_normal((C, 32, 18)) * 0.1).astype(np.float32)
    st = (rng.standard_normal((C, 480)) * 0.1).astype(np.float32)
    return x, bt.astype(np.int32), mixed, ht, st


def _ref(x, bt, mixed, ht=None, st=None, boundary=None):
    out = mp3_dense_batch_jax(
        jnp.asarray(x), jnp.asarray(bt), jnp.asarray(mixed),
        None if ht is None else jnp.asarray(ht),
        None if st is None else jnp.asarray(st),
        boundary=None if boundary is None else jnp.asarray(boundary))
    return [np.asarray(o) for o in out]


def _port(dense, x, bt, mixed, ht=None, st=None, boundary=None):
    state = ((None, None) if ht is None
             else port.Mp3Dense.state_from_numpy(ht, st, "cpu"))
    out = dense(torch.from_numpy(x), torch.from_numpy(bt),
                torch.from_numpy(mixed), *state,
                boundary=None if boundary is None
                else torch.from_numpy(boundary))
    return [o.numpy() for o in out]


@pytest.fixture(scope="module")
def dense():
    return port.Mp3Dense.from_numpy(TABLES, "cpu")


class TestMp3DenseVsReference:
    @pytest.mark.parametrize("C", [1, 2])
    @pytest.mark.parametrize("with_boundary", [False, True])
    @pytest.mark.parametrize("with_tails", [False, True])
    def test_matches_jax(self, dense, C, with_boundary, with_tails):
        G = 9
        x, bt, mixed, ht, st = _inputs(10 * C + with_boundary, G, C)
        assert set(np.unique(bt)) == {0, 1, 2, 3} and mixed.any()
        boundary = None
        if with_boundary:
            boundary = np.zeros(G, bool)
            boundary[[0, 4, 5]] = True
        if not with_tails:
            ht = st = None
        want = _ref(x, bt, mixed, ht, st, boundary)
        got = _port(dense, x, bt, mixed, ht, st, boundary)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)

    def test_matches_stateful_numpy_oracle(self, dense):
        x, bt, mixed, _, _ = _inputs(11, 6, 2)
        states = [GranuleDenseState() for _ in range(2)]
        expect = np.zeros((6, 2, 576), np.float32)
        for g in range(6):
            for c in range(2):
                expect[g, c] = granule_dense_np(
                    x[g, c].copy(), int(bt[g, c]), bool(mixed[g, c]),
                    states[c])
        pcm, ht, st = _port(dense, x, bt, mixed)
        np.testing.assert_allclose(pcm, expect, atol=2e-5, rtol=0)
        np.testing.assert_allclose(
            ht, np.stack([s.hybrid_tail for s in states]), atol=2e-5, rtol=0)
        np.testing.assert_allclose(
            st, np.stack([s.synth_tail for s in states]), atol=2e-5, rtol=0)

    def test_invalid_block_type_matches_reference(self, dense):
        # A block type outside 0..3 selects no matrix in the reference's
        # one-hot operator; the port must agree.
        x, bt, mixed, _, _ = _inputs(12, 9, 1)
        bt[1, 0] = 5
        mixed[1, 0] = False
        for g, w in zip(_port(dense, x, bt, mixed), _ref(x, bt, mixed)):
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)

    @pytest.mark.parametrize("C", [1, 2])
    def test_state_handed_over_from_reference(self, dense, C):
        # Chunk 1 runs on the reference; its carried state goes through
        # numpy into the port, which decodes chunk 2.
        x, bt, mixed, _, _ = _inputs(13 + C, 18, C)
        full = _port(dense, x, bt, mixed)[0]
        a, ht, st = _ref(x[:9], bt[:9], mixed[:9])
        b, ht2, st2 = _port(dense, x[9:], bt[9:], mixed[9:], ht, st)
        np.testing.assert_allclose(np.concatenate([a, b]), full, atol=2e-5,
                                   rtol=0)
        _, ht_ref, st_ref = _ref(x[9:], bt[9:], mixed[9:], ht, st)
        np.testing.assert_allclose(ht2, ht_ref, atol=2e-5, rtol=0)
        np.testing.assert_allclose(st2, st_ref, atol=2e-5, rtol=0)

    def test_chained_chunks_equal_one_call(self, dense):
        x, bt, mixed, _, _ = _inputs(15, 8, 1, all_types=False)
        full = _port(dense, x, bt, mixed)[0]
        a, ht, st = _port(dense, x[:3], bt[:3], mixed[:3])
        b = _port(dense, x[3:], bt[3:], mixed[3:], ht, st)[0]
        np.testing.assert_allclose(np.concatenate([a, b]), full, atol=1e-6,
                                   rtol=0)

    def test_state_numpy_roundtrip(self):
        rng = np.random.default_rng(16)
        ht = rng.standard_normal((2, 32, 18)).astype(np.float32)
        st = rng.standard_normal((2, 480)).astype(np.float32)
        t_ht, t_st = port.Mp3Dense.state_from_numpy(ht, st, "cpu")
        ht2, st2 = port.Mp3Dense.state_to_numpy(t_ht, t_st)
        np.testing.assert_array_equal(ht2, ht)
        np.testing.assert_array_equal(st2, st)

    def test_buffers_are_the_reference_tables(self, dense):
        np.testing.assert_array_equal(dense.hybrid.numpy(), TABLES["hybrid"])
        np.testing.assert_array_equal(dense.matrixing.numpy(),
                                      TABLES["matrixing"])
        np.testing.assert_array_equal(dense.window.numpy(), TABLES["window"])
        np.testing.assert_array_equal(dense.finv.numpy(), TABLES["finv"])
        assert {n for n, _ in dense.named_buffers()} == {
            "hybrid", "cs", "ca", "finv", "matrixing", "window"}

    def test_empty_batch_raises(self, dense):
        with pytest.raises(ValueError):
            dense(torch.zeros((0, 2, 576)), torch.zeros((0, 2), dtype=torch.int32),
                  torch.zeros((0, 2), dtype=torch.bool))
