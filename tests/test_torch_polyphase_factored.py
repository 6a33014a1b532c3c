"""The factored polyphase synthesis of the port's M2 and L1 (the matrixing
with N [64, 32], then the 16-tap FIR with the window W [16, 32]) against the
JAX reference, which computes the same function as one product with its
dense combined matrix.

Tolerances, stated per check:
- the factor tables rebuild the reference's combined matrix bit for bit
  (each entry is one product W[j, i] * N[q, k], in f64 then cast, as the
  reference builds it);
- N's mirror and fold identities, which the kernel uses, hold bit for bit
  (row 16, ~1e-14, is the one row that does not fold);
- the twins against ``mp3_dense_batch_jax`` / ``l12_dense_batch_jax`` and
  against an f64 dense product: 2e-5 absolute at x0.1 inputs, the
  reference's bar (test_mp3.py:231, test_layer12.py:574);
- chained calls against one call: 1e-6 (test_mp3.py:253).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from symphonia_tpu.ops import mp3_dense as ref
from symphonia_tpu_torch.ops import mp3_dense as port

TABLES = port.reference_tables()
N = TABLES["matrixing"]
W = TABLES["window"]
NT, WT = torch.from_numpy(N), torch.from_numpy(W)


def _rebuild(T):
    """The combined matrix [(T + 15) * 32, 32T] from the factors: block
    (slot m, slot t) = diag(W[m - t]) . N[i + 32 ((m - t) & 1)]."""
    n64, w64 = N.astype(np.float64), W.astype(np.float64)
    i = np.arange(32)
    M = np.zeros(((T + 15) * 32, 32 * T))
    for t in range(T):
        for j in range(16):
            M[(t + j) * 32 + i, t * 32:(t + 1) * 32] = (
                w64[j][:, None] * n64[i + 32 * (j & 1)])
    return M.astype(np.float32)


@pytest.mark.parametrize("T", [12, 18, 36])
def test_factors_rebuild_the_combined_matrix(T):
    np.testing.assert_array_equal(_rebuild(T), ref._polyphase_combined_matrix(T))


def test_modules_carry_the_factors():
    for module in (port.Mp3Dense.from_numpy(TABLES, "cpu"),
                   port.L12Dense.from_numpy(port.l12_tables(), "cpu")):
        np.testing.assert_array_equal(module.matrixing.numpy(), N)
        np.testing.assert_array_equal(module.window.numpy(), W)
        assert module.matrixing.dtype == module.window.dtype == torch.float32


@pytest.mark.parametrize("identity", ["negated", "equal"])
def test_matrixing_mirrors_exactly(identity):
    # N[32 - q] = -N[q] (q = 0..15) and N[96 - q] = N[q] (q = 33..47), bit
    # for bit: the kernel computes 33 rows and writes the other 31.
    if identity == "negated":
        for q in range(16):
            np.testing.assert_array_equal(N[32 - q], -N[q])
    else:
        for q in range(33, 48):
            np.testing.assert_array_equal(N[96 - q], N[q])
    assert sorted(set(port.MATRIXING_ROWS) | {16}
                  | {32 - q for q in range(16)}
                  | {96 - q for q in range(33, 48)}) == list(range(64))


@pytest.mark.parametrize("parity", [0, 1])
def test_computed_rows_fold_exactly(parity):
    # N[q][31 - k] = (-1)^q N[q][k], bit for bit, for every computed row.
    k = np.arange(16)
    rows = [q for q in port.MATRIXING_ROWS if q % 2 == parity]
    assert len(rows) == 16
    for q in rows:
        np.testing.assert_array_equal(N[q, 31 - k], (-1) ** q * N[q, k])


def test_row_16_is_the_exception():
    # Row 16 is cos((2k + 1) pi / 2) in float: ~1e-14, not 0, and it
    # neither folds nor mirrors, so the kernel computes it in full.
    assert 16 not in port.MATRIXING_ROWS
    assert 0 < np.abs(N[16]).max() < 1e-13
    k = np.arange(16)
    assert not np.array_equal(N[16, 31 - k], N[16, k])


def test_matrixing_is_the_plain_product():
    S = np.random.default_rng(1).standard_normal((7, 3, 32)) * 0.1
    got = port._matrixing(torch.from_numpy(S.astype(np.float32)), NT)
    want = S @ N.astype(np.float64).T
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # Mirrored rows are 0 - v: an exact zero gives +0.0.
    zero = port._matrixing(torch.zeros(1, 32), NT)
    assert not torch.signbit(zero).any()


# ---------------------------------------------------------------------------
# M2: the twin against the reference
# ---------------------------------------------------------------------------


def _dense_m2(S, tail0, boundary):
    """M2 as the reference's dense product, in f64: S [G, C, 576] ->
    (pcm, tail)."""
    M = ref._polyphase_combined_matrix(18).astype(np.float64)
    resp = S.astype(np.float64) @ M.T  # [G, C, 1056]
    G = S.shape[0]
    prev = np.concatenate([tail0[None], resp[:-1, :, 576:]], axis=0)
    if boundary is not None:
        prev[boundary] = 0.0
    pcm = resp[:, :, :576].copy()
    pcm[:, :, :480] += prev
    return pcm, resp[G - 1, :, 576:]


def _m2_inputs(seed, G, C=2):
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((G, C, 576)) * 0.1).astype(np.float32)
    tail = (rng.standard_normal((C, 480)) * 0.1).astype(np.float32)
    return S, tail


@pytest.mark.parametrize("cut", [None, [0], [4], [0, 4], [3, 4, 5]])
def test_m2_twin_matches_dense_product(cut):
    G = 9
    S, tail = _m2_inputs(20 + G, G)
    bd = None
    if cut is not None:
        bd = np.zeros(G, bool)
        bd[cut] = True
    pcm, st = port.mp3_synth_plain(
        torch.from_numpy(S), NT, WT, torch.from_numpy(tail),
        None if bd is None else torch.from_numpy(bd))
    want_pcm, want_tail = _dense_m2(S, tail, bd)
    np.testing.assert_allclose(pcm.numpy(), want_pcm, atol=2e-5, rtol=0)
    np.testing.assert_allclose(st.numpy(), want_tail, atol=2e-5, rtol=0)


@pytest.mark.parametrize("cut", [[0], [4], [0, 5]])
@pytest.mark.parametrize("G", [1, 2, 9])
def test_m2_chain_matches_jax_with_boundaries(G, cut):
    # The whole Layer III dense stage (M1's twin, then M2's) against
    # mp3_dense_batch_jax, a boundary at g = 0 and/or mid-batch, with
    # carried tails.
    rng = np.random.default_rng(100 * G + len(cut))
    x = (rng.standard_normal((G, 2, 576)) * 0.1).astype(np.float32)
    bt = rng.integers(0, 4, (G, 2)).astype(np.int32)
    mixed = (bt == 2) & (rng.random((G, 2)) < 0.5)
    ht = (rng.standard_normal((2, 32, 18)) * 0.1).astype(np.float32)
    st = (rng.standard_normal((2, 480)) * 0.1).astype(np.float32)
    bd = np.zeros(G, bool)
    bd[[c for c in cut if c < G]] = True
    want = ref.mp3_dense_batch_jax(
        jnp.asarray(x), jnp.asarray(bt), jnp.asarray(mixed), jnp.asarray(ht),
        jnp.asarray(st), boundary=jnp.asarray(bd))
    dense = port.Mp3Dense.from_numpy(TABLES, "cpu")
    got = dense(torch.from_numpy(x), torch.from_numpy(bt),
                torch.from_numpy(mixed), torch.from_numpy(ht),
                torch.from_numpy(st), boundary=torch.from_numpy(bd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("cuts", [[4], [5], [1, 6], [2, 3]])
def test_m2_chained_calls_equal_one_call(cuts):
    # Boundaries at 2 and 5; the cuts fall inside that run, on a boundary
    # granule and around it.
    G = 9
    S, tail = _m2_inputs(7, G)
    bd = np.zeros(G, bool)
    bd[[2, 5]] = True
    S_t, bd_t = torch.from_numpy(S), torch.from_numpy(bd)
    full, full_tail = port.mp3_synth_plain(S_t, NT, WT,
                                           torch.from_numpy(tail), bd_t)
    parts, st, a = [], torch.from_numpy(tail), 0
    for b in cuts + [G]:
        p, st = port.mp3_synth_plain(S_t[a:b], NT, WT, st, bd_t[a:b])
        parts.append(p)
        a = b
    np.testing.assert_allclose(torch.cat(parts).numpy(), full.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.numpy(), full_tail.numpy(), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# L1: the twin against the reference
# ---------------------------------------------------------------------------


def _l12_inputs(seed, F, T, C=2):
    rng = np.random.default_rng(seed)
    sb = (rng.standard_normal((F, C, 32, T)) * 0.1).astype(np.float32)
    tail = (rng.standard_normal((C, 480)) * 0.1).astype(np.float32)
    return sb, tail


@pytest.mark.parametrize("T,F", [(12, 1), (12, 2), (12, 5), (36, 1), (36, 2)])
def test_l12_twin_matches_jax_with_carried_tail(T, F):
    # Layer I with one and two frames: the carried tail reaches past the
    # call (384 samples a frame), and its last 96 samples pass on.
    sb, tail = _l12_inputs(40 + T + F, F, T)
    want = ref.l12_dense_batch_jax(jnp.asarray(sb), jnp.asarray(tail))
    got = port.l12_synth_plain(torch.from_numpy(sb), NT, WT,
                               torch.from_numpy(tail))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("T,cuts", [(12, [1, 2, 4]), (12, [3]), (36, [1, 5])])
def test_l12_chained_calls_equal_one_call(T, cuts):
    sb, tail = _l12_inputs(7 + T, 9, T)
    sb_t = torch.from_numpy(sb)
    full, full_tail = port.l12_synth_plain(sb_t, NT, WT,
                                           torch.from_numpy(tail))
    parts, st, a = [], torch.from_numpy(tail), 0
    for b in cuts + [9]:
        p, st = port.l12_synth_plain(sb_t[a:b], NT, WT, st)
        parts.append(p)
        a = b
    np.testing.assert_allclose(torch.cat(parts).numpy(), full.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.numpy(), full_tail.numpy(), atol=1e-6,
                               rtol=0)


def test_l12_reads_sb_slot_by_slot():
    # L1 on sb [F, C, 32, T] is M2's function on the slot-major operand.
    sb, tail = _l12_inputs(3, 4, 12)
    sb_t, tail_t = torch.from_numpy(sb), torch.from_numpy(tail)
    got = port.l12_synth_plain(sb_t, NT, WT, tail_t)
    want = port._synth_factored(sb_t.transpose(2, 3), NT, WT, tail_t, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The card's work count (chip_smoke.py's bounds)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,limit", [(18, 76_000), (12, 41_000),
                                     (36, 235_000)])
def test_work_is_the_factored_product(T, limit):
    # Multiply-adds a frame-channel: at most 1/8 of the dense product's.
    dense = (32 * T + 480) * 32 * T
    if T == 18:
        factored = chip_smoke.work_mp3_synth(1, 1)[1]
        assert chip_smoke.work_mp3_synth(1, 1, dense=True)[1] == dense
    else:
        factored = chip_smoke.work_mpa_l12_synth(1, 1, T)[1]
        assert chip_smoke.work_mpa_l12_synth(1, 1, T, dense=True)[1] == dense
    assert factored <= limit and factored * 8 <= dense
    assert factored == T * chip_smoke.SYNTH_MACS_PER_SLOT
