"""F1 ``flac_lpc``'s design on CPU: the tap count and lane order its wrapper
computes, and a model of the kernel's arithmetic against the port's plain
twin and the JAX reference.

The kernel (``csrc/flac_dense.cu``) runs only on a card. What it computes
differently from the twin is modelled here in Python integers: only the
taps a lane has (``active_taps``, rounded up to the warp's bucket), the
taps after the first dealt in runs over 2 or 4 threads whose partial
sums are added modulo 2^64, and tap 0 added last. Every comparison is
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import symphonia_tpu_torch.codecs.flac as port_codec
import symphonia_tpu_torch.core.io as port_io
import symphonia_tpu_torch.formats.flac as port_format
from symphonia_tpu.ops import flac_dense as ref
from symphonia_tpu_torch.ops import flac_dense as port

from flac_builder import build_flac_file, random_walk

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
BUCKETS = (0, 4, 8, 12, 16, 24, 32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signed32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def kernel_model(res, coefs, order, shift, wasted, n, parts):
    """The new kernel's arithmetic, lane by lane, in Python integers."""
    taps = port.active_taps(_t(coefs)).numpy()
    out = np.zeros((res.shape[0], n), np.int32)
    for l in range(res.shape[0]):
        T = next(b for b in BUCKETS if b >= taps[l])
        c = [int(v) for v in coefs[l]]
        sh, wb, ordr = int(shift[l]), int(wasted[l]), int(order[l])
        ke = T // parts
        x = []
        for i in range(n):
            early = 0
            for p in range(parts if T else 0):
                part = 0  # one thread's taps: j = p * ke + k + 1
                for k in range(ke):
                    j = p * ke + k + 1
                    if j < 32 and i - 1 - j >= 0:
                        part = (part + c[j] * x[i - 1 - j]) & M64
                early = (early + part) & M64
            acc = early
            if T and i >= 1:
                acc = (early + c[0] * x[i - 1]) & M64  # tap 0 last
            pred = (acc >> sh) & M32 if 0 <= sh <= 31 else 0
            if i < ordr:
                pred = 0
            x.append(_signed32(int(res[l, i]) + pred))
        for i in range(n):
            out[l, i] = _signed32(x[i] << wb) if 0 <= wb <= 31 else 0
    return out


def _twin(res, coefs, order, shift, wasted, n):
    return port.apply_wasted_bits(
        port.lpc_reconstruct_plain(_t(res), _t(coefs), _t(order), _t(shift),
                                   n), _t(wasted)).numpy()


def _reference(res, coefs, order, shift, wasted, n):
    x = ref.lpc_reconstruct_batch(
        jnp.asarray(res[:, :n]), jnp.asarray(coefs), jnp.asarray(order),
        jnp.asarray(shift), n)
    return np.asarray(ref.apply_wasted_bits(x, jnp.asarray(wasted)))


def _check(args, n, parts):
    want = _twin(*args, n)
    np.testing.assert_array_equal(kernel_model(*args, n, parts), want)
    np.testing.assert_array_equal(want, _reference(*args, n))


def _random(L, n, seed, stride=None):
    rng = np.random.default_rng(seed)
    res = rng.integers(-2**25, 2**25, size=(L, stride or n), dtype=np.int32)
    coefs = rng.integers(-2**14, 2**14, size=(L, 32), dtype=np.int32)
    order = rng.integers(0, 33, size=L, dtype=np.int32)
    shift = rng.integers(0, 16, size=L, dtype=np.int32)
    wasted = rng.integers(0, 4, size=L, dtype=np.int32)
    return [res, coefs, order, shift, wasted]


# ---------------------------------------------------------------------------
# active_taps and the lane permutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row,want", [
    ([0] * 32, 0),
    ([5] + [0] * 31, 1),
    ([0] * 31 + [-1], 32),
    ([1, 0, 0, 7, 0, 0, 0, 0] + [0] * 24, 4),       # interior zeros
    ([0, 0, 0, 0, 0, 9] + [0] * 26, 6),             # leading zeros
    ([3] * 12 + [0] * 20, 12),
    ([-(2**31)] * 32, 32),
])
def test_active_taps_rows(row, want):
    got = port.active_taps(_t(np.array([row], np.int32)))
    assert got.dtype == torch.int32 and got.tolist() == [want]


def test_active_taps_empty_batch():
    assert port.active_taps(torch.zeros((0, 32), dtype=torch.int32)).shape \
        == (0,)


@pytest.mark.parametrize("kind,kw", [
    ("fixed", dict(order=2)), ("fixed", dict(order=4)),
    ("lpc", dict(lpc_coefs=[700, -300, 100, 22], lpc_shift=9,
                 lpc_precision=12)),
    ("lpc", dict(lpc_coefs=[4096, 7, 0, 0, -3, 0, 0, 0], lpc_shift=12,
                 lpc_precision=15)),                 # trailing zeros coded
    ("verbatim", dict()), ("constant", dict()),
])
def test_active_taps_of_packed_frames_at_most_order(kind, kw):
    ch = random_walk(512, 16, seed=len(kind), ch=2)
    if kind == "constant":
        ch = [np.full(512, 9, np.int64), np.full(512, -4, np.int64)]
    data = build_flac_file(ch, block_size=256, kind=kind, **kw)
    reader = port_format.FlacReader(port_io.MediaSourceStream(data))
    frames = []
    while (p := reader.next_packet()) is not None:
        frames.append(port_codec.parse_frame(p.data, reader.stream_info))
    pk = port.pack_parsed_frames(frames)
    taps = port.active_taps(_t(pk["coefs"])).numpy()
    assert (taps <= pk["order"]).all()
    if kind in ("verbatim", "constant"):
        assert not taps.any()
    elif kind == "fixed":
        np.testing.assert_array_equal(taps, pk["order"])
    else:
        want = max(i + 1 for i, v in enumerate(kw["lpc_coefs"]) if v)
        assert (taps == want).all()


@pytest.mark.parametrize("L", [1, 33, 500])
def test_lane_permutation_groups_like_tap_counts(L):
    rng = np.random.default_rng(L)
    taps = _t(rng.integers(0, 33, size=L).astype(np.int32))
    perm = port.lane_permutation(taps)
    assert perm.dtype == torch.int32 and perm.shape == (L,)
    assert sorted(perm.tolist()) == list(range(L))
    ordered = taps[perm.long()].tolist()
    assert ordered == sorted(ordered, reverse=True)  # most taps first


@pytest.mark.parametrize("L", [0, 1, 70])
def test_lane_order_on_cpu_is_the_two_plain_functions(L):
    # On the card one helper kernel gives both; a CPU tensor takes the
    # plain functions and launches nothing.
    from symphonia_tpu_torch.ops import _build

    rng = np.random.default_rng(L)
    coefs = rng.integers(-9, 10, size=(L, 32)).astype(np.int32)
    coefs[np.arange(32)[None, :] >= (np.arange(L) % 33)[:, None]] = 0
    before = dict(_build.LAUNCHES)
    taps, perm = port.lane_order(_t(coefs))
    assert _build.LAUNCHES == before
    assert torch.equal(taps, port.active_taps(_t(coefs)))
    assert torch.equal(perm, port.lane_permutation(taps))


@pytest.mark.parametrize("L,want", [(1, 4), (8192, 4), (12288, 4),
                                    (12289, 2), (16384, 2), (65536, 2)])
def test_lane_parts(L, want):
    assert port.lane_parts(L) == want


# ---------------------------------------------------------------------------
# The kernel's arithmetic, modelled, against the twin and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("L", [1, 33])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_model_random_wrapping(n, L, parts):
    # Samples +-2^25 and coefficients +-2^14 in all 32 places whatever
    # ``order`` says: the recurrence leaves int32 and wraps; rows are
    # n + 16 wide (stride > n), and order > n for small n.
    args = _random(L, n, seed=n * 100 + L, stride=n + 16)
    # A tap count for every bucket.
    taps = (np.arange(L) + n) % 33
    args[1][np.arange(32)[None, :] >= taps[:, None]] = 0
    _check(args, n, parts)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("extreme", [2**31 - 1, -(2**31), 0x7FFF, -0x8000])
def test_model_int32_extremes(extreme, parts):
    # Products near +-2^62 whose sums wrap 2^63 and 2^64, every shift 0-31.
    rng = np.random.default_rng(extreme & 0xFFFF)
    L, n = 32, 40
    res = np.full((L, n), extreme, np.int64)
    res[:, 1::3] = -(2**31)
    res[:, 2::5] = 2**31 - 1
    coefs = np.full((L, 32), extreme, np.int64)
    coefs[:, 1::2] = -(2**31)
    order = rng.integers(1, 33, size=L)
    shift = np.arange(L) % 32
    wasted = np.arange(L) % 5
    args = [a.astype(np.int32) for a in (res, coefs, order, shift, wasted)]
    _check(args, n, parts)


@pytest.mark.parametrize("parts", [2, 4])
def test_model_shifts_outside_range(parts):
    # Shifts and wasted shifts outside [0, 31] give a zero prediction and a
    # zero sample.
    args = _random(12, 24, seed=9)
    args[3][:] = [-1, 32, 33, -(2**31), 2**31 - 1, 31, 0, 64, -32, 5, 40, 1]
    args[4][:] = [0, 1, -1, 32, 31, 2**31 - 1, -(2**31), 3, 33, 0, 64, 2]
    _check(args, 24, parts)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("order", [0, 3, 40])
def test_model_coefficients_beyond_order(order, parts):
    # Non-zero coefficients in all 32 places with a small, zero or
    # too-large ``order``: the sum takes them all, as the reference does.
    args = _random(6, 37, seed=order)
    args[2][:] = order
    _check(args, 37, parts)


@pytest.mark.parametrize("parts", [2, 4])
def test_model_zero_tap_lanes_copy_and_shift(parts):
    args = _random(5, 50, seed=3)
    args[1][:] = 0
    args[4][:] = [0, 3, 31, 32, -1]
    _check(args, 50, parts)
    np.testing.assert_array_equal(
        _twin(*args, 50)[1], (args[0][1].astype(np.int64) << 3).astype(
            np.int32))
