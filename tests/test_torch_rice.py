"""R1 ``rice_decode`` (K13) on CPU: the port's ``rice_decode_lanes`` and its
plain twin against the JAX package's ``rice_decode_lanes``, exactly (the
residuals and the uint32 end cursors), and the port's numpy copies of the
stream builder and scalar oracle against the reference's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu.ops import rice_device as ref
from symphonia_tpu_torch.ops import _build
from symphonia_tpu_torch.ops import rice_device as port


def _encode(vals: np.ndarray, k: int, lead: int = 0):
    """Rice-code ``vals [B, n]`` with parameter k, lane after lane, after
    ``lead`` zero bits -> (bytes, first-symbol cursors)."""
    flat = vals.reshape(-1).astype(np.int64)
    u = (flat << 1) ^ (flat >> 63)
    q, r = u >> k, u & ((1 << k) - 1)
    lens = q + 1 + k
    starts = lead + np.concatenate([[0], np.cumsum(lens)[:-1]])
    bits = np.zeros(int(starts[-1] + lens[-1]) + 64, np.uint8)
    bits[starts + q] = 1
    for b in range(k):
        bits[starts + q + 1 + b] = (r >> (k - 1 - b)) & 1
    return np.packbits(bits).tobytes(), starts.reshape(vals.shape)[:, 0]


def _both(words, cur, param, n):
    """(reference values, reference end cursors), (twin values, twin end
    cursors), all numpy int64."""
    want, want_end = ref.rice_decode_lanes(
        words, jnp.asarray(np.asarray(cur, np.int32)),
        jnp.asarray(np.asarray(param, np.int32)), n)
    got, got_end = port.rice_decode_lanes(
        torch.from_numpy(words), torch.from_numpy(np.asarray(cur, np.int32)),
        torch.from_numpy(np.asarray(param, np.int32)), n)
    assert got.dtype == torch.int32 and got_end.dtype == torch.int64
    return ((np.asarray(want).astype(np.int64),
             np.asarray(want_end).astype(np.int64)),
            (got.numpy().astype(np.int64), got_end.numpy()))


@pytest.mark.parametrize("k", [0, 1, 4, 9])
def test_twin_matches_reference(k):
    # Values whose symbols fit the 32-bit window (q + 1 + k <= 32), lanes
    # that start anywhere in a word (a 13-bit lead, then whatever lengths
    # the values give).
    rng = np.random.default_rng(k)
    lim = ((31 - k) << k) // 2
    vals = rng.integers(-lim, lim, size=(7, 40))
    data, cur = _encode(vals, k, lead=13)
    assert (cur % 32 != 0).any()
    words = ref.pack_bits_u32(data)
    (want, want_end), (got, got_end) = _both(words, cur, np.full(7, k), 40)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_end, want_end)
    np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("k", [0, 1])
def test_quotients_near_31(k):
    # Zig-zag codes whose unary quotient is 31 - k (the whole 32-bit window,
    # with every remainder bit set and clear) and 30 - k.
    us = np.array([((31 - k) << k) + (1 << k) - 1, (31 - k) << k,
                   (30 - k) << k, 0])
    vals = ((us >> 1) ^ -(us & 1)).reshape(1, -1).repeat(3, 0)
    data, cur = _encode(vals, k, lead=5)
    words = ref.pack_bits_u32(data)
    (want, want_end), (got, got_end) = _both(words, cur, np.full(3, k), 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_end, want_end)
    np.testing.assert_array_equal(got, vals)


def test_reads_past_the_last_word_clamp():
    # Lanes that run off the end of a short stream: the reference's gather
    # clamps each word index to W - 1, the twin must read the same words;
    # parameters across 0-31, arbitrary and far-out cursors.
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=12, dtype=np.uint64).astype(np.uint32)
    words[-2:] = [0, 1]
    cur = np.array([0, 5, 31, 33, 300, 352, 383, 380, 17, 2000])
    param = np.array([0, 1, 4, 9, 31, 3, 0, 12, 30, 2])
    (want, want_end), (got, got_end) = _both(words, cur, param, 30)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_end, want_end)
    assert (got_end > 32 * len(words)).any()


@pytest.mark.parametrize("k", [4, 9])
def test_reference_streams(k):
    data, cur, vals = ref.make_test_streams(16, 64, k, seed=k)
    words = ref.pack_bits_u32(data)
    (want, want_end), (got, got_end) = _both(words, cur, np.full(16, k), 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_end, want_end)
    np.testing.assert_array_equal(got, vals)


def test_numpy_copies_equal_reference():
    for B, n, k, seed in ((5, 33, 4, 0), (3, 20, 0, 2), (8, 9, 9, 5)):
        a, b = ref.make_test_streams(B, n, k, seed), port.make_test_streams(
            B, n, k, seed)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        w = ref.pack_bits_u32(a[0])
        assert w.dtype == port.pack_bits_u32(a[0]).dtype
        np.testing.assert_array_equal(w, port.pack_bits_u32(a[0]))
        if k:
            par = np.full(B, k)
            np.testing.assert_array_equal(
                ref.rice_decode_oracle(a[0], a[1], par, n),
                port.rice_decode_oracle(b[0], b[1], par, n))
    assert port.pack_bits_u32(b"\x01\x02\x03").tolist() == [0x01020300, 0, 0]


def test_wrapper_on_cpu_takes_the_twin():
    data, cur, _ = port.make_test_streams(4, 16, 4, seed=1)
    words = torch.from_numpy(port.pack_bits_u32(data))
    cur = torch.from_numpy(cur)  # int64 cursors are taken as uint32
    par = torch.full((4,), 4, dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    a = port.rice_decode_lanes(words, cur, par, 16)
    b = port.rice_decode_lanes_plain(words.view(torch.int32), cur, par, 16)
    assert _build.LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    out, end = port.rice_decode_lanes(words, cur[:0], par[:0], 16)
    assert out.shape == (0, 16) and end.shape == (0,)
    with pytest.raises(ValueError):
        port.rice_decode_lanes(words[:0], cur, par, 16)
    with pytest.raises(ValueError):
        port.rice_decode_lanes(words.to(torch.int64), cur, par, 16)
    with pytest.raises(ValueError):
        port.rice_decode_lanes(words, cur, par[:2], 16)


def test_bench_tool_on_cpu(capsys):
    from symphonia_tpu_torch.tools import bench_rice_device

    res = bench_rice_device.main(B=12, n=24, k=4, iters=2, device="cpu")
    assert res["correct_slice"] is True and res["platform"] == "cpu"
    assert res["wall_ms"] > 0 and res["realtime_x"] > 0
    out = capsys.readouterr().out
    for line in ("platform: cpu", "first call", "Msamples/s",
                 "correctness slice: True"):
        assert line in out
