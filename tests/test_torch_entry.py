"""The port's combined decode step (``symphonia_tpu_torch.entry``) on CPU
against the reference's ``__graft_entry__._decode_step`` under JAX.

Bars: FLAC bit-exact (integer, wrapping int32 as XLA does); MP3 within
2e-5 absolute (the reference's dense-stage bar); AAC and Vorbis within 1e-5
absolute (fp32 sums of 128-1024 terms in another order; the reference's
batch bars)."""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symphonia_tpu.codecs.vorbis import vorbis_window as ref_window
from symphonia_tpu_torch import entry as port
from symphonia_tpu_torch.ops import aac_dense, vorbis_dense

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ref  # noqa: E402

# (name, _example_batch keyword arguments): the reference entry()'s size,
# dryrun_multichip's width (1024 lanes a codec, 48 kHz bands), and a third
# seed at odd lane counts, N not a power of two and 22.05 kHz bands.
CASES = [
    ("entry", dict(F=8, N=256, G=8, A=8, V=8)),
    ("dryrun", dict(F=512, N=256, G=1024, A=1024, V=1024, n1=512, seed=1,
                    aac_rate=48000)),
    ("seed7", dict(F=21, N=192, G=33, A=45, V=19, n1=1024, seed=7,
                   aac_rate=22050)),
]
BARS = {"mp3": 2e-5, "aac": 1e-5, "vorbis": 1e-5}


def _ref_step(args, n_samples):
    fn = jax.jit(partial(ref._decode_step, n_samples=n_samples))
    return [np.asarray(o) for o in fn(*(jnp.asarray(a) for a in args))]


def _port_step(args, n_samples):
    return [o.numpy() for o in port.decode_step(
        *(torch.from_numpy(a) for a in args), n_samples=n_samples)]


def _check(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32
    for name, g, w in zip(("mp3", "aac", "vorbis"), got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=BARS[name], rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_decode_step_matches_reference(name, kw):
    args = port.example_batch(**kw)
    _check(_port_step(args, kw["N"]), _ref_step(args, kw["N"]))


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_example_batch_equals_reference(name, kw):
    got = port.example_batch(**kw)
    want = ref._example_batch(**kw)
    assert len(got) == len(want) == 18
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n1,V", [(512, 37), (2048, 5), (64, 300), (256, 1)])
def test_vorbis_lap_twin_is_the_reference_lap(n1, V):
    rng = np.random.default_rng(n1 + V)
    t = rng.standard_normal((V, n1)).astype(np.float32)
    t[0, :3] = -0.0
    w = ref_window(n1)
    got = vorbis_dense.vorbis_lap(torch.from_numpy(t),
                                  torch.from_numpy(w)).numpy()
    # The reference's expression in numpy fp32 (each product and the sum
    # rounded, as V2 rounds them): bit for bit.
    h = n1 // 2
    ov = np.roll(t[:, h:], 1, axis=0)
    ov[0] = 0.0
    want = ov[:, :h] * w[::-1] + t[:, :h] * w
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # Under XLA the multiply-add may fuse (one rounding fewer): 1 ulp.
    w1 = jnp.asarray(w)
    vt = jnp.asarray(t)
    xla = jnp.roll(vt[:, h:], 1, axis=0).at[0].set(0.0)
    xla = np.asarray(xla[:, :h] * w1[::-1] + vt[:, :h] * w1)
    np.testing.assert_allclose(got, xla, atol=1e-6, rtol=0)


def test_short_handoff_lane_takes_a2_and_matches_reference(monkeypatch):
    # The native contract never hands off a short lane (deq == 0 with
    # EIGHT_SHORT), but the reference step defines its result: dequantized
    # like a long lane, then the eight short IMDCTs.
    args = list(port.example_batch(F=4, N=64, G=4, A=12, V=4, n1=256,
                                   seed=3))
    seqs, deq = args[13].copy(), args[12].copy()
    seqs[[2, 5]] = 2
    deq[[2, 5]] = 0
    deq[7] = 0
    args[13], args[12] = seqs, deq
    # A2 runs once, over the short lanes: the lanes it is given through
    # its row map (the whole batch's coefficients, the index and the count
    # of short lanes) are exactly the short ones.
    calls = []
    real = aac_dense.aac_dequant

    def spy(*a, **kw):
        lanes = kw["rows"][:int(kw["n_rows"])]
        calls.append((a[0].shape, sorted(lanes.tolist())))
        return real(*a, **kw)

    monkeypatch.setattr(aac_dense, "aac_dequant", spy)
    got = _port_step(args, 64)
    assert calls == [((len(seqs), 1024), sorted(np.flatnonzero(seqs == 2)))]
    _check(got, _ref_step(args, 64))
    # ... and the lanes' coefficients really were replaced.
    args[12] = np.ones_like(deq)
    assert np.abs(_port_step(args, 64)[2] - got[2]).max() > 1e-3


def test_entry_on_cpu_gives_the_reference_entry_shapes():
    fn, args = port.entry(device="cpu")
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in args)
    flac_pcm, mp3_pcm, aac_pcm, vorb_pcm = fn(*args)
    assert flac_pcm.shape[0] == args[0].shape[0] // 2
    assert mp3_pcm.shape[-1] == 576
    assert aac_pcm.shape[-1] == 1024
    assert vorb_pcm.shape[-1] == 256
    ref_fn, ref_args = ref.entry()
    for g, w in zip(args, ref_args):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _check([o.numpy() for o in (flac_pcm, mp3_pcm, aac_pcm, vorb_pcm)],
           [np.asarray(o) for o in ref_fn(*(jnp.asarray(a)
                                            for a in ref_args))])


def test_plain_step_equals_step_on_cpu():
    args = [torch.from_numpy(a) for a in port.example_batch(seed=5)]
    for a, b in zip(port.decode_step(*args, n_samples=256),
                    port.decode_step_plain(*args, n_samples=256)):
        assert torch.equal(a, b)
