"""A3 ``aac_ola``'s kernel arithmetic, modelled in numpy float32.

The CUDA kernel cannot run without a card. It gives a lane one block and a
thread four consecutive output samples, moved as 16-byte words, so a group
of four must never straddle a region of the window/overlap-add (the edges
at 448 and 576, the 128-sample hop of the short windows) nor leave 16-byte
alignment. The model below computes by such groups, asserting both for
every group start, with every product and sum rounded once in the
reference's order; it is held bit for bit to the plain twin, to the
sequential ``window_ola_chain`` and to the JAX package's batched
overlap-add (``_ola_jax`` behind ``window_ola_batch``)."""

import numpy as np
import pytest
import torch

from symphonia_tpu.ops import aac_dense as ref
from symphonia_tpu_torch.ops import aac_dense as port

F32 = np.float32
HEAD, DELAY, S_FIRST, S_LEFT, S_RIGHT = port._ola_tables()
P0, P1 = 448, 576
EIGHT_SHORT = 2


def _take4(a, off):
    """A 16-byte load: four floats at an offset that is a multiple of 4."""
    assert off % 4 == 0 and 0 <= off and off + 4 <= a.shape[0]
    return a[off: off + 4]


def _short_sum4(p, j, lw0, lw, rw):
    """Positions j .. j + 3 of the in-frame overlap-add, one window index
    for the four."""
    assert j % 4 == 0 and 0 <= j < 1152
    k, t = j >> 7, j & 127
    assert (j + 3) >> 7 == k  # the group stays inside one hop
    if k == 0:
        return F32(0.0) + _take4(p, t) * _take4(lw0, t)
    right = _take4(p, (k - 1) * 256 + 128 + t) * _take4(rw, t)
    if k == 8:
        return right
    return right + _take4(p, k * 256 + t) * _take4(lw, t)


def ola_model(pcm, seqs, shapes, prevs, first):
    """pcm [L, 2048] -> [L, 1024] by the kernel's groups of four."""
    L = pcm.shape[0]
    out = np.empty((L, 1024), F32)
    for l in range(L):
        q = max(l - 1, 0)
        seq, shape, prev = seqs[l] & 3, int(shapes[l] != 0), int(prevs[l] != 0)
        linked = l > 0 and not first[l]
        qseq, qshape = seqs[q] & 3, int(shapes[q] != 0)
        qprev = int(prevs[q] != 0)
        for i in range(0, 1024, 4):  # thread i / 4
            # The group lies in one region of head and of delay.
            assert (i < P0) == (i + 3 < P0) and (i < P1) == (i + 3 < P1)
            if seq == EIGHT_SHORT:
                head = (np.zeros(4, F32) if i < P0 else _short_sum4(
                    pcm[l], i - P0, S_FIRST[prev], S_LEFT[shape],
                    S_RIGHT[shape]))
            else:
                head = _take4(pcm[l], i) * _take4(HEAD[seq, prev], i)
            delay = np.zeros(4, F32)
            if linked:
                if qseq == EIGHT_SHORT:
                    if i < P1:
                        delay = _short_sum4(pcm[q], P1 + i, S_FIRST[qprev],
                                            S_LEFT[qshape], S_RIGHT[qshape])
                else:
                    delay = (_take4(pcm[q], 1024 + i)
                             * _take4(DELAY[qseq, qshape], i))
            out[l, i: i + 4] = head + delay
    assert out.dtype == F32
    return out


def _lanes(seed, L, starts, all_short=False):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((L, 2048)) * 0.05).astype(F32)
    seqs = (np.full(L, EIGHT_SHORT) if all_short
            else rng.integers(0, 4, L)).astype(np.int32)
    shapes = rng.integers(0, 2, L).astype(np.int32)
    prevs = rng.integers(0, 2, L).astype(np.int32)
    first = {"all": np.ones(L, bool), "none": np.zeros(L, bool),
             "random": rng.random(L) < 0.3}[starts]
    return pcm, seqs, shapes, prevs, first


def _twin(pcm, seqs, shapes, prevs, first):
    t = torch.from_numpy
    return port.aac_ola_plain(
        t(pcm), t(seqs), t(shapes), t(prevs), t(first),
        *(t(a) for a in (HEAD, DELAY, S_FIRST, S_LEFT, S_RIGHT))).numpy()


@pytest.mark.parametrize("all_short", [False, True])
@pytest.mark.parametrize("starts", ["all", "none", "random"])
@pytest.mark.parametrize("L", [1, 2, 3, 257])
def test_model_equals_twin_bit_for_bit(L, starts, all_short):
    args = _lanes(1000 * L + len(starts), L, starts, all_short)
    got = ola_model(*args)
    np.testing.assert_array_equal(got.view(np.int32),
                                  _twin(*args).view(np.int32))


def _sequences(seed, n_seq, n_fr):
    """Valid window-sequence cycles with both shapes: (flat pcm, seqs,
    shapes, prevs, first)."""
    rng = np.random.default_rng(seed)
    flat = (rng.standard_normal((n_seq * n_fr, 2048)) * 0.05).astype(F32)
    seqs = np.array([(f + k) % 4 for k in range(n_seq)
                     for f in range(n_fr)], np.int32)
    shapes = rng.integers(0, 2, n_seq * n_fr).astype(np.int32)
    prevs = np.roll(shapes, 1)
    first = np.arange(n_seq * n_fr) % n_fr == 0
    prevs[first] = rng.integers(0, 2, n_seq)
    return flat, seqs, shapes, prevs, first


@pytest.mark.parametrize("n_fr", [1, 2, 3, 9])
def test_model_equals_sequential_chain_and_jax(n_fr):
    n_seq = 5
    flat, seqs, shapes, prevs, first = _sequences(40 + n_fr, n_seq, n_fr)
    got = ola_model(flat, seqs, shapes, prevs, first)
    for k in range(n_seq):
        sl = slice(k * n_fr, (k + 1) * n_fr)
        pcms = [p.reshape(8, 256) if s == EIGHT_SHORT else p
                for p, s in zip(flat[sl], seqs[sl])]
        sh, pv = shapes[sl].astype(bool), prevs[sl].astype(bool)
        chain = port.window_ola_chain(pcms, seqs[sl], sh, pv)
        np.testing.assert_array_equal(got[sl].reshape(-1).view(np.int32),
                                      chain.view(np.int32))
        # The JAX package's batched overlap-add (_ola_jax).
        jax_out = ref.window_ola_batch(pcms, list(seqs[sl]), list(sh),
                                       list(pv))
        np.testing.assert_array_equal(got[sl].reshape(-1), jax_out)


@pytest.mark.parametrize("L", [1, 2, 3, 257])
def test_wrapper_on_cpu_equals_model(L):
    args = _lanes(7 * L, L, "random")
    t = torch.from_numpy
    dense = port.AacDense.from_numpy(port.reference_tables(), "cpu")
    got = dense.ola(*(t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  ola_model(*args).view(np.int32))


def test_every_row_the_kernel_loads_is_16_byte_aligned():
    # Rows of pcm are 8 KB apart, rows of out 4 KB, the long tables' rows 4
    # KB and the short windows' rows 512 bytes: from aligned bases every
    # group of four is a 16-byte word, for any L.
    assert HEAD.shape == DELAY.shape == (4, 2, 1024)
    assert S_FIRST.shape == S_LEFT.shape == S_RIGHT.shape == (2, 128)
    for row_floats in (2048, 1024, 128):
        assert row_floats * 4 % 16 == 0
    for edge in (P0, P1, 128, 256, 1024):
        assert edge % 4 == 0
    # Region edges in the in-frame sum's coordinates too.
    assert (1024 - P0) % 4 == 0 and (P1 + 1020) < 2 * P1 + 448


@pytest.mark.parametrize("bad", ["pcm", "table"])
def test_misaligned_operands_are_refused_not_rerouted(bad, monkeypatch):
    # On the card the wrapper raises on operands off 16-byte alignment; it
    # never takes the twin for them. Checked here on CPU tensors by
    # steering the wrapper down its CUDA path up to the alignment test.
    from symphonia_tpu_torch.ops import _build

    args = _lanes(3, 4, "random")
    t = torch.from_numpy
    tables = [t(a.copy()) for a in (HEAD, DELAY, S_FIRST, S_LEFT, S_RIGHT)]
    pcm = t(args[0])
    if bad == "pcm":
        pcm = torch.zeros(4 * 2048 + 1)[1:].view(4, 2048)
    else:
        tables[2] = torch.zeros(2 * 128 + 1)[1:].view(2, 128)
    assert (pcm.data_ptr() % 16 or tables[2].data_ptr() % 16)
    monkeypatch.setattr(_build, "device_type", lambda x: "cuda")
    monkeypatch.setattr(_build, "require_cuda", lambda *a: a[0].device)
    monkeypatch.setattr(_build, "lib", lambda: pytest.fail("launched"))
    with pytest.raises(ValueError, match="16-byte aligned"):
        port.aac_ola(pcm, *(t(a) for a in args[1:]), *tables)
