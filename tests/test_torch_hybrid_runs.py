"""M1 ``mp3_hybrid``'s kernel arithmetic, modelled in numpy float32.

The CUDA kernel cannot run without a card, so its arithmetic is written out
here step by step: a warp takes a run of consecutive granules of one
channel, lane k subband k; the butterflies exchange samples between
neighbouring lanes with every product and sum rounded once; each IMDCT row
is one chain of fused multiply-adds in increasing j from +0, rows taken in
pairs of 36 contiguous floats; rows 0-17 meet the tail carried inside the
run, rows 18-35 replace it; at the start of a run the tail is recomputed
from x[g - 1]. The model is held to the plain twin (1e-6) and to the JAX
package's ``mp3_dense_batch_jax`` through the port's synthesis (2e-5), and
must not depend on the run length by any bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu.ops.mp3_dense import mp3_dense_batch_jax
from symphonia_tpu_torch.ops import mp3_dense as port

TABLES = port.reference_tables()
# The matrices as they lie in shared memory, and a fifth of zeros for a
# block type outside 0..3.
T4 = np.concatenate([TABLES["hybrid"].reshape(4, 36 * 18),
                     np.zeros((1, 36 * 18), np.float32)])
F32 = np.float32


def _fmaf(a, b, c):
    """One fused multiply-add: the float32 product is exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def _antialias_lanes(x, nb):
    """x [32 lanes, 18]: lane b's sample 17 - i with lane b + 1's sample
    i for b < nb, as the kernel's shuffles pair them."""
    if nb == 0:
        return x
    cs, ca = TABLES["cs"], TABLES["ca"]
    lane = np.arange(32)
    out = x.copy()
    for i in range(8):
        lo, hi = x[:, 17 - i], x[:, i]
        hi_above = np.roll(hi, -1)  # __shfl_down_sync(.., 1)
        lo_below = np.roll(lo, 1)   # __shfl_up_sync(.., 1)
        lower = lane < nb
        upper = (lane >= 1) & (lane <= nb)
        out[lower, 17 - i] = (lo * cs[i] - hi_above * ca[i])[lower]
        out[upper, i] = (hi * cs[i] + lo_below * ca[i])[upper]
    return out


def _rows(m, x, pair0, pairs):
    """Rows 2 pair0 .. 2 (pair0 + pairs) - 1 for all lanes: m [32] matrix
    index a lane, x [32, 18]. Walks each row pair's 36 floats in the
    kernel's order (nine 16-byte words of four)."""
    out = np.zeros((32, 2 * pairs), F32)
    flat = T4[m]  # [32, 648]
    for s in range(pairs):
        base = (pair0 + s) * 36
        for q in range(9):
            for i in range(4):
                e = 4 * q + i
                r, j = (1, e - 18) if e >= 18 else (0, e)
                out[:, 2 * s + r] = _fmaf(flat[:, base + e], x[:, j],
                                          out[:, 2 * s + r])
    return out


def _matrix_index(bt, mixed):
    k = np.arange(32)
    if not 0 <= bt <= 3:
        return np.full(32, 4)
    if bt == port.BLOCK_SHORT:
        return np.where(mixed & (k < 2), 0, port.BLOCK_SHORT)
    return np.full(32, bt)


def hybrid_model(x, bt, mixed, boundary, tail0, run):
    """The kernel's walk over x [G, C, 576]: (S [G, C, 576], tail [C, 32,
    18]); ``boundary`` and ``tail0`` may be None."""
    G, C, _ = x.shape
    finv = TABLES["finv"]
    S = np.zeros((G, C, 576), F32)
    tail_out = np.zeros((C, 32, 18), F32)

    def transform(g, c):
        b, mx = int(bt[g, c]), bool(mixed[g, c])
        nb = (1 if mx else 0) if b == port.BLOCK_SHORT else 31
        xr = _antialias_lanes(x[g, c].reshape(32, 18), nb)
        return xr, _matrix_index(b, mx)

    for c in range(C):
        for g0 in range(0, G, run):
            n = min(run, G - g0)
            cut0 = boundary is not None and bool(boundary[g0])
            tail = np.zeros((32, 18), F32)
            if g0 == 0 and not cut0 and tail0 is not None:
                tail = tail0[c].copy()
            if g0 > 0 and not cut0:  # step -1: granule g0 - 1's rows 18-35
                xr, m = transform(g0 - 1, c)
                tail = _rows(m, xr, 9, 9)
            for g in range(g0, g0 + n):
                cut = boundary is not None and bool(boundary[g])
                xr, m = transform(g, c)
                head = _rows(m, xr, 0, 9)
                prev = np.zeros((32, 18), F32) if cut else tail
                S[g, c] = ((head + prev) * finv).T.reshape(576)
                tail = _rows(m, xr, 9, 9)
            if g0 + n == G:
                tail_out[c] = tail
    return S, tail_out


def _inputs(seed, G, C, cuts=(), carried=True, bad_bt=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((G, C, 576)) * 0.1).astype(F32)
    bt = rng.integers(0, 4, size=(G, C)).astype(np.int32)
    bt[:: max(1, G // 3), 0] = 2  # short blocks, mixed or not
    mixed = (bt == 2) & (rng.random((G, C)) < 0.5)
    if bad_bt:
        bt[G // 2, C - 1] = 5
    boundary = None
    if len(cuts):
        boundary = np.zeros(G, bool)
        boundary[list(cuts)] = True
    ht = ((rng.standard_normal((C, 32, 18)) * 0.1).astype(F32)
          if carried else None)
    return x, bt, mixed, boundary, ht


def _twin(x, bt, mixed, boundary, ht):
    t = torch.from_numpy
    S, tail = port.mp3_hybrid_plain(
        t(x), t(bt), t(mixed), None if boundary is None else t(boundary),
        None if ht is None else t(ht),
        *(t(TABLES[k]) for k in ("hybrid", "cs", "ca", "finv")))
    return S.numpy(), tail.numpy()


# (G, C, boundaries, carried tail): G = 1, 2, 3; G not a multiple of any
# run; a boundary at g = 0, at the first and at the last granule of a run
# of 2, 4 and 8, and in the middle of one.
SHAPES = [
    (1, 1, (), True), (1, 2, (0,), True), (2, 2, (1,), False),
    (3, 1, (), True), (3, 2, (0, 2), False), (11, 2, (0, 4, 7), True),
    (19, 1, (8, 15, 16, 18), True), (9, 2, (3, 5), False),
]


@pytest.mark.parametrize("run", port.RUN_LENGTHS)
@pytest.mark.parametrize("G,C,cuts,carried", SHAPES)
def test_model_matches_twin(G, C, cuts, carried, run):
    args = _inputs(100 * G + C, G, C, cuts, carried)
    S, tail = hybrid_model(*args, run=run)
    S_ref, tail_ref = _twin(*args)
    assert S.dtype == F32 and S.shape == S_ref.shape
    np.testing.assert_allclose(S, S_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tail, tail_ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("G,C,cuts,carried", SHAPES)
def test_result_does_not_depend_on_the_run(G, C, cuts, carried):
    # The tail recomputed at the start of a run is the chain of fused
    # multiply-adds that carried it inside the longer run: bit for bit.
    args = _inputs(100 * G + C, G, C, cuts, carried)
    S1, tail1 = hybrid_model(*args, run=1)
    for run in port.RUN_LENGTHS:
        S, tail = hybrid_model(*args, run=run)
        np.testing.assert_array_equal(S.view(np.int32), S1.view(np.int32))
        np.testing.assert_array_equal(tail.view(np.int32),
                                      tail1.view(np.int32))


@pytest.mark.parametrize("cut_at", [None, 5])
def test_chained_calls_equal_one_call_bit_for_bit(cut_at):
    cuts = () if cut_at is None else (cut_at,)
    x, bt, mixed, boundary, ht = _inputs(7, 13, 2, cuts)
    S, tail = hybrid_model(x, bt, mixed, boundary, ht, run=4)
    h = 6
    b = (None, None) if boundary is None else (boundary[:h], boundary[h:])
    Sa, ta = hybrid_model(x[:h], bt[:h], mixed[:h], b[0], ht, run=4)
    Sb, tb = hybrid_model(x[h:], bt[h:], mixed[h:], b[1], ta, run=8)
    np.testing.assert_array_equal(np.concatenate([Sa, Sb]).view(np.int32),
                                  S.view(np.int32))
    np.testing.assert_array_equal(tb.view(np.int32), tail.view(np.int32))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("run", [1, 4])
@pytest.mark.parametrize("with_boundary", [False, True])
def test_model_chain_matches_jax(C, run, with_boundary):
    # The model's S through the port's synthesis twin against the JAX
    # package's whole dense stage, at its own bar.
    G = 10
    cuts = (0, 4, 5) if with_boundary else ()
    x, bt, mixed, boundary, ht = _inputs(31 + C, G, C, cuts, bad_bt=False)
    st = (np.random.default_rng(5).standard_normal((C, 480)) * 0.1).astype(F32)
    S, tail = hybrid_model(x, bt, mixed, boundary, ht, run=run)
    t = torch.from_numpy
    pcm, synth_tail = port.mp3_synth_plain(
        t(S), t(TABLES["matrixing"]), t(TABLES["window"]), t(st),
        None if boundary is None else t(boundary))
    want = mp3_dense_batch_jax(
        jnp.asarray(x), jnp.asarray(bt), jnp.asarray(mixed), jnp.asarray(ht),
        jnp.asarray(st),
        boundary=None if boundary is None else jnp.asarray(boundary))
    for got, w in zip((pcm.numpy(), tail, synth_tail.numpy()), want):
        np.testing.assert_allclose(got, np.asarray(w), atol=2e-5, rtol=0)


def test_invalid_block_type_gives_zeros_as_jax():
    x, bt, mixed, _, _ = _inputs(9, 6, 1, bad_bt=False)
    bt[2, 0], mixed[2, 0] = 7, False
    bt[5, 0], mixed[5, 0] = -1, False
    S, tail = hybrid_model(x, bt, mixed, None, None, run=4)
    # Granule 2 adds nothing of its own: only granule 1's tail reaches it,
    # and granule 3 meets a zero tail. The last granule's tail is zero.
    S_zero_tail, _ = hybrid_model(x[3:4], bt[3:4], mixed[3:4], None, None, 1)
    np.testing.assert_array_equal(S[3], S_zero_tail[0])
    assert not tail.any()
    S_ref, tail_ref = _twin(x, bt, mixed, None, None)
    np.testing.assert_allclose(S, S_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tail, tail_ref, atol=1e-6, rtol=0)


def test_matrix_rows_pair_into_16_byte_words():
    # Two rows are 36 floats: nine 16-byte words at a 16-byte offset, for
    # every pair of every matrix; rows 18-35 start at pair 9.
    T = TABLES["hybrid"]
    assert T.shape == (4, 36, 18) and T.dtype == F32
    assert T.flags["C_CONTIGUOUS"]
    for m in range(4):
        for pair in range(18):
            offset = (m * 36 * 18 + pair * 36) * 4
            assert offset % 16 == 0
            np.testing.assert_array_equal(
                T4[m, pair * 36: pair * 36 + 36].reshape(2, 18),
                T[m, 2 * pair: 2 * pair + 2])


def test_staging_read_back_is_conflict_free():
    # Lane k reads its 18 floats as nine 8-byte loads at float 18 k + 2 m;
    # shared memory serves an 8-byte load half a warp at a time, and the
    # 16 lanes' word pairs fall in 32 distinct banks.
    for half in (range(16), range(16, 32)):
        for m in range(9):
            banks = {(18 * k + 2 * m + w) % 32 for k in half for w in (0, 1)}
            assert len(banks) == 32
    # The copy: 144 16-byte words, word w by lane w % 32 in round w // 32.
    words = sorted(i * 32 + lane for i in range(5) for lane in range(32)
                   if i * 32 + lane < 144)
    assert words == list(range(144))


@pytest.mark.parametrize("G,C,want", [
    (4096, 2, 8), (4096, 1, 4), (1024, 2, 2), (64, 2, 1), (1, 1, 1),
    (8192, 1, 8), (2048, 2, 4), (2040, 2, 2), (511, 2, 1), (16384, 2, 8)])
def test_run_length_rule(G, C, want):
    assert port.run_length(G, C) == want
    assert want in port.RUN_LENGTHS
    # A longer run would leave fewer than RUN_WARPS warps.
    longer = [r for r in port.RUN_LENGTHS if r > want]
    assert all(C * -(-G // r) < port.RUN_WARPS for r in longer)


def test_wrapper_takes_the_twin_on_cpu_whatever_the_run():
    x, bt, mixed, boundary, ht = _inputs(3, 5, 2, (2,))
    t = torch.from_numpy
    args = (t(x), t(bt), t(mixed), t(boundary), t(ht),
            *(t(TABLES[k]) for k in ("hybrid", "cs", "ca", "finv")))
    S_ref, tail_ref = port.mp3_hybrid_plain(*args)
    for run in (None, 1, 8):
        S, tail = port.mp3_hybrid(*args, run=run)
        assert torch.equal(S, S_ref) and torch.equal(tail, tail_ref)
