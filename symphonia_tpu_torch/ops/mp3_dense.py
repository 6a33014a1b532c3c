"""MPEG audio dense stages: Layer III spectra [G, C, 576] -> PCM [G, C,
576], and Layer I/II subband samples [F, C, 32, T] -> PCM [F, C, 32T].

PyTorch port of ``symphonia_tpu/ops/mp3_dense.py:346`` (``mp3_dense_batch_jax``).
Every granule decodes in parallel; the two linear cross-granule couplings
(hybrid overlap-add, polyphase FIFO) are applied by superposition, with
carried state ``(hybrid_tail [C, 32, 18], synth_tail [C, 480])`` between
calls and an optional ``boundary [G]`` mask that zeroes both couplings
where a new stream starts inside a merged batch.

Two kernels:

* ``mp3_hybrid`` (M1): antialias, hybrid IMDCT per block type, hybrid
  overlap-add, frequency inversion, written as the polyphase operand
  ``S [G, C, 576]`` (vec index t*32 + k). A warp takes a run of consecutive
  granules of one channel (:func:`run_length`), a lane one subband with its
  18 inputs in registers; the matrix rows come from shared memory once for
  all 32 subbands, and the hybrid tail stays in registers inside a run;
* ``mp3_synth`` (M2): the polyphase synthesis in true fp32, in factored
  form: the ``[64, 32]`` matrixing of each 32-sample slot, then the 16-tap
  windowed FIR across slots, with the 480-sample synthesis overlap-add
  fused in. The reference computes it as one product with the ``[1056,
  576]`` combined polyphase matrix (``_polyphase_combined_matrix``), whose
  blocks are those two factors; the factored form, with N's mirrored and
  folded rows, does 32x fewer multiply-adds.

A third, ``mp3_place`` (M3), replaces no TPU program: after each chunk's
M2 it copies the chunk's PCM into one buffer of a merged group's output,
each clip as ``[C, N]`` with its encoder delay and padding already cut
(:func:`place_table`), so that the host moves no sample (the reference
concatenates, transposes and trims on the host).

Layer I/II (``:273``, ``l12_dense_batch_jax``) has no hybrid stage: its
bitstream stage's subband samples ``sb [F, C, 32, T]`` go straight into the
same synthesis, for T = 12 (Layer I) or 36 (Layer II), and the 480-sample
tail overlaps the next ceil(480 / 32T) frames (two for Layer I), with a
carried ``synth_tail [C, 480]`` between calls. One kernel,
``mpa_l12_synth`` (L1), M2's body for those T, reading sb as it is.

The operator tables come from the numpy builders below, the reference
package's own, copied (``symphonia_tpu/ops/mp3_dense.py:29-259``), and are
held as buffers of :class:`Mp3Dense` and :class:`L12Dense`. The numpy
granule chain beside them (``granule_dense_np``) is the oracle and serves
the per-packet decoder.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import trace
from . import _build

BLOCK_LONG = 0
BLOCK_START = 1
BLOCK_SHORT = 2
BLOCK_END = 3


# ---------------------------------------------------------------------------
# Table construction (all from ISO/IEC 11172-3 formulas)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def imdct_windows() -> np.ndarray:
    """The four 36-point block windows (hybrid_synthesis.rs:53-92)."""
    w = np.zeros((4, 36))
    i = np.arange(36)
    w[BLOCK_LONG] = np.sin(np.pi / 36 * (i + 0.5))
    w[BLOCK_START, :18] = np.sin(np.pi / 36 * (i[:18] + 0.5))
    w[BLOCK_START, 18:24] = 1.0
    w[BLOCK_START, 24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
    w[BLOCK_SHORT, :12] = np.sin(np.pi / 12 * (i[:12] + 0.5))
    w[BLOCK_END, 6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
    w[BLOCK_END, 12:18] = 1.0
    w[BLOCK_END, 18:] = np.sin(np.pi / 36 * (i[18:] + 0.5))
    return w


@lru_cache(maxsize=None)
def hybrid_matrices() -> np.ndarray:
    """``T[bt] @ x[18] -> tmp[36]`` for each block type.

    Long/start/end: tmp[i] = w[i] * sum_k x[k] cos(pi/72 (2i+19)(2k+1)).
    Short: three 12-point IMDCTs of the interleaved windows, windowed and
    overlap-laid into tmp[6..30] (hybrid_synthesis.rs imdct12_win).
    """
    wins = imdct_windows()
    T = np.zeros((4, 36, 18))
    i = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    imdct36 = np.cos(np.pi / 72 * (2 * i + 19) * (2 * k + 1))
    for bt in (BLOCK_LONG, BLOCK_START, BLOCK_END):
        T[bt] = imdct36 * wins[bt][:, None]
    # Short blocks.
    ii = np.arange(12)[:, None]
    kk = np.arange(6)[None, :]
    imdct12 = np.cos(np.pi / 24 * (2 * ii + 7) * (2 * kk + 1))  # [12, 6]
    ws = wins[BLOCK_SHORT][:12]
    for w in range(3):
        for iout in range(12):
            for kin in range(6):
                T[BLOCK_SHORT, 6 + 6 * w + iout, 3 * kin + w] += (
                    imdct12[iout, kin] * ws[iout]
                )
    return T.astype(np.float32)


@lru_cache(maxsize=None)
def antialias_coeffs():
    """cs/ca butterfly coefficients (ISO 11172-3 Table B.9 construction)."""
    c = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
    den = np.sqrt(1.0 + c * c)
    return (1.0 / den).astype(np.float32), (c / den).astype(np.float32)


@lru_cache(maxsize=None)
def polyphase_matrix() -> np.ndarray:
    """Spec matrixing N[i, k] = cos((16 + i)(2k + 1) pi / 64), [64, 32]."""
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64).astype(np.float32)


@lru_cache(maxsize=None)
def synthesis_window() -> np.ndarray:
    """ISO Table B.3 synthesis window D reshaped to [16, 32]."""
    from ..codecs.mpa_common import tables

    return tables()["synthesis_d"].reshape(16, 32)


@lru_cache(maxsize=None)
def freq_inversion_mask() -> np.ndarray:
    """[32, 18] sign mask: odd samples of odd subbands are negated
    (hybrid_synthesis.rs frequency_inversion)."""
    sb = np.arange(32)[:, None]
    t = np.arange(18)[None, :]
    return np.where((sb & 1) & (t & 1), -1.0, 1.0).astype(np.float32)


@lru_cache(maxsize=None)
def _polyphase_combined_matrix(T: int = 18) -> np.ndarray:
    """[(T+15)*32, T*32] matrix for an ENTIRE polyphase stage.

    T = 18 for Layer III granules, 12 for Layer I frames, 36 for Layer II
    frames (the [1056, 576] L3 shape documented below generalizes).

    Folds the [64, 32] matrixing, the v[64] tap selection, and the 512-tap
    windowed FIR (synthesis.rs:158-348) into one dense operator:
    ``resp_vec = M @ vec(S)`` with ``vec(S)[t*32+k] = sb_time[t, k]`` and
    ``resp_vec[m*32+i]`` the response sample at FIR slot m, subsample i.
    Entry: M[(m,i), (t,:)] = D[32*(m-t)+i] * N[q(m-t, i), :] for
    0 <= m-t < 16. Built in f64, cast f32; on device the whole stage is a
    single K=576 MXU matmul per channel (batch axis minor — see
    mp3_dense_batch_jax's layout note)."""
    N = polyphase_matrix().astype(np.float64)
    W = synthesis_window().astype(np.float64)
    q = _synth_sel_idx()
    M = np.zeros(((T + 15) * 32, T * 32))
    for m in range(T + 15):
        for k in range(16):
            t = m - k
            if 0 <= t < T:
                for i in range(32):
                    M[m * 32 + i, t * 32 : (t + 1) * 32] += W[k, i] * N[q[k, i]]
    return M.astype(np.float32)


@lru_cache(maxsize=None)
def _synth_sel_idx() -> np.ndarray:
    """QIDX[k, i]: which of v[64] feeds output tap k at sample i
    (even k -> lower half, odd k -> upper half; synthesis.rs:313-324)."""
    k = np.arange(16)[:, None]
    i = np.arange(32)[None, :]
    return (i + 32 * (k & 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# numpy granule pipeline (oracle + stateful per-packet path)
# ---------------------------------------------------------------------------


def antialias_np(x: np.ndarray, n_boundaries: int) -> np.ndarray:
    """Anti-alias butterflies on a [32, 18] granule buffer.

    ``n_boundaries``: 31 for long-ish blocks, 1 for mixed, 0 for short
    (hybrid_synthesis.rs:224-280; applying the butterfly at a boundary
    between two zero subbands is a no-op, so the rzero bound is dropped).
    """
    if n_boundaries == 0:
        return x
    cs, ca = antialias_coeffs()
    y = x.copy()
    # Each boundary butterfly touches samples 10..17 of subband b-1 and
    # 0..7 of subband b — disjoint sets across boundaries — so all
    # boundaries vectorize in one shot (bit-identical: same per-element
    # expressions, reading the original x).
    nb = n_boundaries
    lo = x[0:nb, 17:9:-1]  # samples 17..10 of the lower subbands [nb, 8]
    hi = x[1 : nb + 1, 0:8]
    y[0:nb, 17:9:-1] = lo * cs - hi * ca
    y[1 : nb + 1, 0:8] = hi * cs + lo * ca
    return y


def hybrid_synthesis_np(x: np.ndarray, block_type: int, mixed: bool) -> np.ndarray:
    """[32, 18] spectral -> [32, 36] windowed IMDCT responses (pre-OLA)."""
    T = hybrid_matrices()
    if block_type == BLOCK_SHORT:
        if mixed:
            out = np.einsum("ij,sj->si", T[BLOCK_SHORT], x).astype(np.float32)
            out[:2] = np.einsum("ij,sj->si", T[BLOCK_LONG], x[:2])
            return out
        return np.einsum("ij,sj->si", T[BLOCK_SHORT], x).astype(np.float32)
    return np.einsum("ij,sj->si", T[block_type], x).astype(np.float32)


def polyphase_response_np(hybrid_out: np.ndarray) -> np.ndarray:
    """[32 sb, T t] time-domain subband samples -> [32*T + 480] response.

    Computes this granule's full contribution to the PCM stream via the
    matrixing matmul + windowed FIR taps; the 480-sample tail belongs to
    following granules (superposition form of synthesis.rs:158-348).
    T = 18 for Layer III granules, 12 for Layer I frames, 36 for Layer II.
    """
    N = polyphase_matrix()
    W = synthesis_window()
    qidx = _synth_sel_idx()
    S = hybrid_out.T  # [T, 32 sb]
    T = S.shape[0]
    V = S @ N.T  # [T, 64]
    c = (V[:, qidx] * W[None, :, :]).astype(np.float32, copy=False)  # [T, 16, 32]
    # out[t] = sum_k c[t-k, k] (the 16 overlapping tap groups). A strided
    # view over a zero-padded copy turns the 16 shifted adds into one
    # reduction: w[t, k, j] = A[15 + t - k, k, j] = c[t-k, k, j] or 0.
    A = np.zeros((T + 30, 16, 32), dtype=np.float32)
    A[15 : 15 + T] = c
    s0, s1, s2 = A.strides
    w = np.lib.stride_tricks.as_strided(
        A[15:], shape=(T + 15, 16, 32), strides=(s0, s1 - s0, s2)
    )
    return w.sum(axis=1, dtype=np.float32).reshape(-1)


class GranuleDenseState:
    """Carries cross-granule linear state for the stateful per-packet path:
    the hybrid overlap tail and the pending polyphase response tail."""

    def __init__(self, hybrid_tail: np.ndarray = None, synth_tail: np.ndarray = None):
        # Optional caller-owned buffers: the per-packet decoder passes
        # views into one [C, ...] block shared with the native dense stage,
        # so both paths mutate the same state. Updates are in-place —
        # the array identity is stable.
        self.hybrid_tail = (np.zeros((32, 18), dtype=np.float32)
                            if hybrid_tail is None else hybrid_tail)
        self.synth_tail = (np.zeros(480, dtype=np.float32)
                           if synth_tail is None else synth_tail)

    def reset(self):
        self.hybrid_tail[:] = 0
        self.synth_tail[:] = 0


def granule_dense_np(
    x: np.ndarray, block_type: int, mixed: bool, state: GranuleDenseState
) -> np.ndarray:
    """Full dense stage for one granule-channel: [576] spectral (reordered,
    stereo-decoded) -> [576] PCM, updating carried state."""
    xb = x.reshape(32, 18)
    n_bounds = 0 if (block_type == BLOCK_SHORT and not mixed) else (
        1 if block_type == BLOCK_SHORT else 31
    )
    xb = antialias_np(xb, n_bounds)
    tmp = hybrid_synthesis_np(xb, block_type, mixed)  # [32, 36]
    sb_time = tmp[:, :18] + state.hybrid_tail
    state.hybrid_tail[:] = tmp[:, 18:]
    sb_time = sb_time * freq_inversion_mask()
    resp = polyphase_response_np(sb_time)
    out = resp[:576].copy()
    out[:480] += state.synth_tail
    state.synth_tail[:] = resp[576:]
    return out


# ---------------------------------------------------------------------------
# The port's operators
# ---------------------------------------------------------------------------


def reference_tables() -> Dict[str, np.ndarray]:
    """The dense stage's constant operators, from the builders above: the
    hybrid stage's, and the polyphase synthesis's two factors (the
    combined matrix ``_polyphase_combined_matrix`` is their product)."""
    cs, ca = antialias_coeffs()
    return {
        "hybrid": hybrid_matrices(),               # [4, 36, 18]
        "cs": cs, "ca": ca,                        # [8] each
        "finv": freq_inversion_mask(),             # [32, 18]
        **l12_tables(),
    }


L12_T = (12, 36)  # subband samples per frame: Layer I, Layer II


def l12_tables() -> Dict[str, np.ndarray]:
    """The polyphase synthesis's factors, shared by every frame width T:
    the matrixing ``N [64, 32]`` and the synthesis window ``W [16, 32]``
    (its tap selection ``_synth_sel_idx`` is i + 32 (k & 1), computed)."""
    return {"matrixing": polyphase_matrix(),  # [64, 32]
            "window": synthesis_window()}     # [16, 32]


# The rows of N the kernels compute: N[32 - q] = -N[q] for q = 0..15 and
# N[96 - q] = N[q] for q = 33..47 hold exactly in float32, so rows 0..16
# and 33..48 give the other 31. Of those, every row but 16 also satisfies
# N[q][31 - k] = (-1)^q N[q][k] exactly, so it is computed from the folded
# slot (S[k] + S[31 - k] for even q, S[k] - S[31 - k] for odd, k < 16);
# row 16 (~1e-14, not 0) takes the plain 32-term product.
MATRIXING_ROWS = tuple(range(16)) + tuple(range(33, 49))


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def mp3_hybrid_plain(x, bt, mixed, boundary, hybrid_tail0, T, cs, ca, finv):
    """Twin of M1. Returns (S [G, C, 576], hybrid_tail [C, 32, 18])."""
    G, C, _ = x.shape
    xb = x.reshape(G, C, 32, 18)
    bt = bt.to(torch.int64)
    mixed = mixed.to(torch.bool)
    # --- antialias (hybrid_synthesis.rs:224) ---
    n_bounds = torch.where(bt == BLOCK_SHORT, mixed.to(torch.int64),
                           torch.full_like(bt, 31))
    lo = xb[:, :, :31, 10:18].flip(-1)  # [G, C, 31, 8], sample 17 - i
    hi = xb[:, :, 1:, 0:8]
    nl = lo * cs - hi * ca
    nh = hi * cs + lo * ca
    bmask = (torch.arange(31, device=x.device)[None, None, :, None]
             < n_bounds[:, :, None, None])
    xa = xb.clone()
    xa[:, :, 1:, 0:8] = torch.where(bmask, nh, hi)
    xa[:, :, :31, 10:18] = torch.where(bmask, nl, lo).flip(-1)
    # --- hybrid IMDCT: one-hot block-type selection per (lane, subband) ---
    lt = torch.where(bt == BLOCK_SHORT, torch.full_like(bt, BLOCK_LONG), bt)
    sb_split = torch.where(bt == BLOCK_SHORT,
                           torch.where(mixed, 2, 0), torch.full_like(bt, 32))
    idx = torch.where(
        torch.arange(32, device=x.device)[None, None, :] < sb_split[..., None],
        lt[..., None], torch.full_like(lt[..., None], BLOCK_SHORT))
    tmp = torch.zeros((G, C, 32, 36), dtype=x.dtype, device=x.device)
    for b in range(4):
        sel = (idx == b).to(x.dtype)[..., None]
        tmp = tmp + sel * torch.matmul(xa, T[b].T)
    heads, tails = tmp[..., :18], tmp[..., 18:]
    # --- hybrid overlap-add: one-granule shift ---
    if hybrid_tail0 is None:
        hybrid_tail0 = torch.zeros((C, 32, 18), dtype=x.dtype,
                                   device=x.device)
    prev = torch.cat([hybrid_tail0[None], tails[:-1]], dim=0)
    if boundary is not None:
        prev = torch.where(boundary[:, None, None, None], 0.0, prev)
    sb_time = (heads + prev) * finv  # frequency inversion
    S = sb_time.transpose(-1, -2).reshape(G, C, 576)  # vec index t*32 + k
    return S, tails[-1].clone()


def _matrixing(S, matrixing):
    """``V [..., 64]`` from ``S [..., 32]`` as the kernels form it: the rows
    of :data:`MATRIXING_ROWS` from the folded slot, row 16 from the plain
    product, the other rows mirrored (the negated ones as 0 - v, +0 for an
    exact zero)."""
    lo, hi = S[..., :16], S[..., 16:].flip(-1)  # S[k], S[31 - k]
    rows = torch.tensor(MATRIXING_ROWS, device=S.device)
    n = matrixing.index_select(0, rows)[:, :16]  # [32, 16]
    odd = (rows % 2 == 1)
    v = torch.where(odd, torch.matmul(lo - hi, n.T),
                    torch.matmul(lo + hi, n.T))  # [..., 32]
    low, up = v[..., :16], v[..., 16:]  # rows 0..15, 33..48
    row16 = torch.matmul(S, matrixing[16])[..., None]
    return torch.cat([low, row16, 0.0 - low.flip(-1),  # 0..16, 17..32
                      up, up[..., :15].flip(-1)], dim=-1)  # 33..48, 49..63


def _synth_factored(S, matrixing, window, synth_tail0, boundary):
    """The factored polyphase synthesis of M2 and L1, step by step as the
    kernel takes it: ``S [F, C, T, 32]`` (slot-major) -> ``(pcm [F, C,
    32T], tail [C, 480])``. V from :func:`_matrixing`; the 16-tap FIR sums
    the taps of each source frame apart (term_k: frame g - k), in tap
    order; ``pcm = term_0 + (term_1 + term_2)`` where the response of the
    frames before reaches, with ``synth_tail0`` standing in for the frames
    before the call (not where ``boundary[0]``) and ``boundary [F]``
    zeroing the terms of earlier frames; the outgoing tail is that sum for
    the K virtual frames after the last."""
    F, C, T, _ = S.shape
    n = 32 * T
    K = -(-480 // n)  # frames the tail reaches forward
    dev, dt = S.device, S.dtype
    slots = (F + K) * T
    V = _matrixing(S, matrixing).permute(1, 0, 2, 3).reshape(C, F * T, 64)
    V = torch.cat([V.new_zeros(C, 15, 64), V, V.new_zeros(C, K * T, 64)],
                  dim=1)
    a = [torch.zeros((C, F + K, T, 32), dtype=dt, device=dev)
         for _ in range(K + 1)]
    for j in range(16):
        h = 32 * (j & 1)
        c = (window[j] * V[:, 15 - j: 15 - j + slots, h: h + 32]).reshape(
            C, F + K, T, 32)
        # Tap j of output slot m comes from frame g - k: k = 0 for m >= j,
        # 1 for j - T <= m < j, 2 below.
        lo = max(j - T, 0)
        for k, (m0, m1) in enumerate(((j, T), (lo, j), (0, lo))[:K + 1]):
            a[k][:, :, m0:m1] += c[:, :, m0:m1]
    a = [x.reshape(C, F + K, n) for x in a]
    g = torch.arange(F + K, device=dev)[:, None]
    p = torch.arange(n, device=dev)[None, :]
    cut = torch.zeros(F + K, dtype=torch.bool, device=dev)
    if boundary is not None:
        cut[:F] = boundary.to(torch.bool)
    tail = torch.zeros((C, 480), dtype=dt, device=dev)
    if synth_tail0 is not None:
        tail = synth_tail0 if boundary is None else torch.where(
            boundary[0], 0.0, synth_tail0)
    prev = torch.zeros((C, F + K, n), dtype=dt, device=dev)
    for k in range(1, K + 1):
        src = g - k
        t = g * n + p  # the carried tail's index where src == -1
        carried = torch.where(t < 480, tail[:, t.clamp(max=479)], 0.0)
        linked = (src >= 0) & (src < F) & ~cut[:, None]
        term = torch.where(src == -1, carried,
                           torch.where(linked, a[k], 0.0))
        in_range = p + (k - 1) * n < 480
        prev = torch.where(in_range, term if k == 1 else prev + term, prev)
    pcm = torch.where(p < 480, a[0][:, :F] + prev[:, :F], a[0][:, :F])
    return (pcm.transpose(0, 1).contiguous(),
            prev[:, F:].reshape(C, K * n)[:, :480].contiguous())


def mp3_synth_plain(S, matrixing, window, synth_tail0, boundary):
    """Twin of M2: S [G, C, 576] (index t*32 + k) -> (pcm [G, C, 576], tail
    [C, 480]), the factored synthesis of :func:`_synth_factored`."""
    G, C, _ = S.shape
    return _synth_factored(S.reshape(G, C, 18, 32), matrixing, window,
                           synth_tail0, boundary)


def l12_synth_plain(sb, matrixing, window, synth_tail0):
    """Twin of L1: ``sb [F, C, 32, T] -> (pcm [F, C, 32T], tail [C, 480])``
    for T = 12 or 36, the factored synthesis of :func:`_synth_factored` on
    sb read slot by slot."""
    return _synth_factored(sb.transpose(2, 3), matrixing, window,
                           synth_tail0, None)


def place_table(counts, bounds, C: int) -> Tuple[np.ndarray, int]:
    """M3's table for a group of clips of ``C`` channels, back to back in
    its granule order: ``counts`` each clip's granules, ``bounds`` each
    one's kept samples ``[start, end)`` of its ``G x 576``. Returns the
    int64 ``[K, 5]`` table (first granule, granules, trim start, trimmed
    length N, output offset) and the buffer's floats: clip k lies at
    ``out[offset : offset + C * N]`` as ``[C, N]``."""
    counts = np.asarray(counts, np.int64).reshape(-1)
    bounds = np.asarray(bounds, np.int64).reshape(-1, 2)
    K = len(counts)
    t = np.zeros((K, 5), np.int64)
    t[:, 1] = counts
    t[:, 2] = bounds[:, 0]
    t[:, 3] = bounds[:, 1] - bounds[:, 0]
    sizes = C * t[:, 3]
    if K:
        t[1:, 0] = np.cumsum(counts)[:-1]
        t[1:, 4] = np.cumsum(sizes)[:-1]
    return t, int(sizes.sum())


def place_rows(table: np.ndarray, g0: int, g1: int) -> Tuple[int, int]:
    """The rows ``k0 .. k1`` of ``table`` whose granules meet the chunk
    ``[g0, g1)`` (those of a clip with no granule among them)."""
    first, count = table[:, 0], table[:, 1]
    return (int(np.searchsorted(first + count, g0, side="right")),
            int(np.searchsorted(first, g1, side="left")))


def mp3_place_plain(pcm, table, out, g0: int, rows: Tuple[int, int]):
    """Twin of M3: the chunk ``pcm [g, C, 576]`` (granules ``g0 .. g0 + g``
    of its group) into ``out``, each of the rows ``rows`` of ``table`` (see
    :func:`place_table`) as its clip's ``[C, N]`` from sample ``start`` of
    its ``[C, G x 576]``; returns ``out``."""
    g, C, _ = pcm.shape
    for k in range(*rows):
        first, G, start, N, off = (int(v) for v in table[k])
        if (G < 0 or start < 0 or N <= 0 or start > G * 576 - N or off < 0
                or off > out.numel() - C * N):
            continue  # a row the kernel skips too
        lo, hi = max(g0, first), min(g0 + g, first + G)
        if hi <= lo:
            continue
        s0 = (lo - first) * 576  # the chunk's first sample of the clip
        a, b = max(s0, start), min((hi - first) * 576, start + N)
        if b <= a:
            continue
        seg = pcm[lo - g0 : hi - g0].permute(1, 0, 2).reshape(C, -1)
        out[off : off + C * N].view(C, N)[:, a - start : b - start] = \
            seg[:, a - s0 : b - s0]
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _opt_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# M1's warps take runs of consecutive granules of one channel, the hybrid
# tail carried in registers inside a run and recomputed from x[g - 1] at
# its start. Long runs save that recomputation (half a granule's product a
# run); short ones give more warps, and a warp takes its granules one after
# another. RUN_WARPS is the least number of warps a longer run must leave:
# 128 blocks of eight, about one a multiprocessor of an H100 (measured
# there at 64, 1024 and 4096 stereo granules: chip_smoke.py's
# ``graph_ms_by_run``).
RUN_LENGTHS = (8, 4, 2, 1)
RUN_WARPS = 128 * 8


def run_length(G: int, C: int) -> int:
    """Granules a warp of M1 takes in a row: the longest of
    :data:`RUN_LENGTHS` that still leaves :data:`RUN_WARPS` warps, else 1."""
    for run in RUN_LENGTHS:
        if C * -(-G // run) >= RUN_WARPS:
            return run
    return 1


def mp3_hybrid(x, bt, mixed, boundary, hybrid_tail0, T, cs, ca, finv,
               run: Optional[int] = None):
    """M1 wrapper: (S [G, C, 576], hybrid_tail [C, 32, 18]). ``run`` is the
    number of consecutive granules a warp takes (:func:`run_length` by
    default); the result does not depend on it."""
    G, C, _ = x.shape
    if G == 0:
        raise ValueError("empty granule batch")
    if _build.device_type(x) == "cpu":
        return mp3_hybrid_plain(x, bt, mixed, boundary, hybrid_tail0, T,
                                cs, ca, finv)
    x = x.to(torch.float32).contiguous()
    bt = bt.to(torch.int32).contiguous()
    mixed = mixed.to(torch.bool).contiguous()
    boundary = (None if boundary is None
                else boundary.to(torch.bool).contiguous())
    hybrid_tail0 = (None if hybrid_tail0 is None
                    else hybrid_tail0.to(torch.float32).contiguous())
    opt = [t for t in (boundary, hybrid_tail0) if t is not None]
    dev = _build.require_cuda(x, bt, mixed, T, cs, ca, finv, *opt)
    if (bt.shape != (G, C) or mixed.shape != (G, C)
            or (boundary is not None and boundary.shape != (G,))
            or (hybrid_tail0 is not None
                and hybrid_tail0.shape != (C, 32, 18))
            or x.shape[2] != 576 or T.shape != (4, 36, 18)
            or cs.shape != (8,) or ca.shape != (8,) or finv.shape != (32, 18)
            or any(t.dtype != torch.float32 for t in (T, cs, ca, finv))):
        raise ValueError("x [G, C, 576], bt/mixed [G, C], boundary [G], "
                         "tail [C, 32, 18], f32 T [4, 36, 18], cs/ca [8], "
                         "finv [32, 18]")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    run = run_length(G, C) if run is None else int(run)
    if run < 1:
        raise ValueError("run must be at least 1")
    S = torch.empty((G, C, 576), dtype=torch.float32, device=dev)
    tail = torch.empty((C, 32, 18), dtype=torch.float32, device=dev)
    lib = _build.lib()
    err = lib.mp3_hybrid_launch(
        x.data_ptr(), bt.data_ptr(), mixed.data_ptr(), _opt_ptr(boundary),
        _opt_ptr(hybrid_tail0), T.data_ptr(), cs.data_ptr(), ca.data_ptr(),
        finv.data_ptr(), S.data_ptr(), tail.data_ptr(), G, C, run,
        _build.stream_ptr(dev))
    _build.LAUNCHES["mp3_hybrid"] += 1
    _build.check("mp3_hybrid", err)
    return S, tail


def _check_factors(matrixing, window) -> bool:
    return (matrixing.dtype == torch.float32 and window.dtype == torch.float32
            and matrixing.shape == (64, 32) and window.shape == (16, 32)
            and matrixing.data_ptr() % 16 == 0)


def mp3_synth(S, matrixing, window, synth_tail0, boundary):
    """M2 wrapper: S [G, C, 576] -> (pcm [G, C, 576], tail [C, 480]), the
    factored polyphase synthesis (matrixing ``N [64, 32]``, then the
    16-tap FIR with window ``W [16, 32]``) with the 480-sample overlap in
    one kernel, in true fp32."""
    G, C, _ = S.shape
    if G == 0:
        raise ValueError("empty granule batch")
    if _build.device_type(S) == "cpu":
        return mp3_synth_plain(S, matrixing, window, synth_tail0, boundary)
    S = S.contiguous()
    boundary = (None if boundary is None
                else boundary.to(torch.bool).contiguous())
    synth_tail0 = (None if synth_tail0 is None
                   else synth_tail0.to(torch.float32).contiguous())
    opt = [t for t in (boundary, synth_tail0) if t is not None]
    dev = _build.require_cuda(S, matrixing, window, *opt)
    if (S.dtype != torch.float32 or S.shape[2] != 576
            or not _check_factors(matrixing, window)
            or (boundary is not None and boundary.shape != (G,))
            or (synth_tail0 is not None and synth_tail0.shape != (C, 480))):
        raise ValueError("f32 S [G, C, 576], matrixing [64, 32] (16-byte "
                         "aligned), window [16, 32], boundary [G], tail "
                         "[C, 480]")
    if S.data_ptr() % 16:
        raise ValueError("S must be 16-byte aligned")
    pcm = torch.empty((G, C, 576), dtype=torch.float32, device=dev)
    tail = torch.empty((C, 480), dtype=torch.float32, device=dev)
    err = _build.lib().mp3_synth_launch(
        S.data_ptr(), matrixing.data_ptr(), window.data_ptr(),
        _opt_ptr(synth_tail0), _opt_ptr(boundary), pcm.data_ptr(),
        tail.data_ptr(), G, C, _build.stream_ptr(dev))
    _build.LAUNCHES["mp3_synth"] += 1
    _build.check("mp3_synth", err)
    return pcm, tail


def mpa_l12_synth(sb, matrixing, window, synth_tail0):
    """L1 wrapper: ``sb [F, C, 32, T] -> (pcm [F, C, 32T], tail [C,
    480])`` for T = 12 or 36, M2's factored synthesis on sb as it is, in
    true fp32; ``synth_tail0`` None means stream start."""
    F, C, _, T = sb.shape
    if F == 0:
        raise ValueError("empty frame batch")
    if _build.device_type(sb) == "cpu":
        return l12_synth_plain(sb, matrixing, window, synth_tail0)
    sb = sb.contiguous()
    synth_tail0 = (None if synth_tail0 is None
                   else synth_tail0.to(torch.float32).contiguous())
    opt = [] if synth_tail0 is None else [synth_tail0]
    dev = _build.require_cuda(sb, matrixing, window, *opt)
    if (sb.dtype != torch.float32 or sb.shape[2] != 32 or T not in L12_T
            or not _check_factors(matrixing, window)
            or (synth_tail0 is not None and synth_tail0.shape != (C, 480))):
        raise ValueError("f32 sb [F, C, 32, T] with T 12 or 36, matrixing "
                         "[64, 32] (16-byte aligned), window [16, 32], tail "
                         "[C, 480]")
    pcm = torch.empty((F, C, 32 * T), dtype=torch.float32, device=dev)
    tail = torch.empty((C, 480), dtype=torch.float32, device=dev)
    err = _build.lib().mpa_l12_synth_launch(
        sb.data_ptr(), matrixing.data_ptr(), window.data_ptr(),
        _opt_ptr(synth_tail0), pcm.data_ptr(), tail.data_ptr(), F, C, T,
        _build.stream_ptr(dev))
    _build.LAUNCHES["mpa_l12_synth"] += 1
    _build.check("mpa_l12_synth", err)
    return pcm, tail


def mp3_place(pcm, table, out, g0: int, rows: Tuple[int, int]):
    """M3 wrapper: lays the chunk ``pcm [g, C, 576]`` (f32, granules ``g0
    .. g0 + g`` of its group) into ``out`` (f32, 1-D) by the rows ``k0 ..
    k1`` of ``table`` (int64 ``[K, 5]``, :func:`place_table`) that meet it
    (:func:`place_rows`); returns ``out``. The twin runs for CPU tensors,
    the kernel for CUDA ones; both copy, bit for bit."""
    k0, k1 = (int(r) for r in rows)
    tensors = (pcm, table, out)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"pcm, table and out on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    kind = _build.device_type(pcm)
    if (pcm.dim() != 3 or pcm.shape[2] != 576 or pcm.dtype != torch.float32
            or table.dim() != 2 or table.shape[1] != 5
            or table.dtype != torch.int64
            or out.dim() != 1 or out.dtype != torch.float32
            or not 0 <= k0 <= k1 <= table.shape[0] or int(g0) < 0):
        raise ValueError("f32 pcm [g, C, 576], int64 table [K, 5], f32 out "
                         "[n], 0 <= k0 <= k1 <= K, g0 >= 0")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mp3_place's tensors must be contiguous")
    if pcm.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("pcm and out must be 16-byte aligned")
    g, C, _ = pcm.shape
    if g == 0 or k0 == k1:
        return out
    if kind == "cpu":
        return mp3_place_plain(pcm, table, out, int(g0), (k0, k1))
    err = _build.lib().mp3_place_launch(
        pcm.data_ptr(), int(g0), g, C, table.data_ptr(), table.shape[0], k0,
        k1, out.data_ptr(), out.numel(), _build.stream_ptr(pcm.device))
    _build.LAUNCHES["mp3_place"] += 1
    _build.check("mp3_place", err)
    return out


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


def _upload(tables: Dict[str, np.ndarray], keys, device) -> list:
    """``tables[k]`` for each of ``keys`` as float32 on ``device``, each a
    copy of its own, through :func:`trace.to_device`; their bytes counted
    as ``mp3_table_bytes``."""
    arrays = [np.array(tables[k], np.float32) for k in keys]
    trace.count("mp3_table_bytes", sum(a.nbytes for a in arrays))
    return trace.to_device(torch.device(device), *arrays)


class Mp3Dense(nn.Module):
    """The Layer III dense stage with its constant operators as buffers.

    ``forward(x, bt, mixed, hybrid_tail0=None, synth_tail0=None,
    boundary=None) -> (pcm, hybrid_tail, synth_tail)`` with the reference's
    semantics; ``None`` tails mean stream start."""

    def __init__(self, hybrid, cs, ca, finv, matrixing, window):
        super().__init__()
        self.register_buffer("hybrid", hybrid)        # [4, 36, 18]
        self.register_buffer("cs", cs)                # [8]
        self.register_buffer("ca", ca)                # [8]
        self.register_buffer("finv", finv)            # [32, 18]
        self.register_buffer("matrixing", matrixing)  # [64, 32]
        self.register_buffer("window", window)        # [16, 32]

    @classmethod
    def from_numpy(cls, tables: Dict[str, np.ndarray], device) -> "Mp3Dense":
        """The module with ``tables`` uploaded to ``device``: their bytes
        counted as ``mp3_table_bytes`` (and ``h2d_bytes``)."""
        return cls(*_upload(tables, ("hybrid", "cs", "ca", "finv",
                                     "matrixing", "window"), device))

    @staticmethod
    def state_from_numpy(hybrid_tail: np.ndarray, synth_tail: np.ndarray,
                         device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Carried state (hybrid_tail [C, 32, 18], synth_tail [C, 480])
        from numpy, e.g. handed over from the reference mid-stream."""
        device = torch.device(device)
        return (torch.from_numpy(np.array(hybrid_tail, np.float32)).to(device),
                torch.from_numpy(np.array(synth_tail, np.float32)).to(device))

    @staticmethod
    def state_to_numpy(hybrid_tail: torch.Tensor, synth_tail: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return hybrid_tail.cpu().numpy(), synth_tail.cpu().numpy()

    def forward(self, x, bt, mixed, hybrid_tail0=None, synth_tail0=None,
                boundary=None):
        S, hybrid_tail = mp3_hybrid(x, bt, mixed, boundary, hybrid_tail0,
                                    self.hybrid, self.cs, self.ca, self.finv)
        pcm, synth_tail = mp3_synth(S, self.matrixing, self.window,
                                    synth_tail0, boundary)
        return pcm, hybrid_tail, synth_tail


class L12Dense(nn.Module):
    """The Layer I/II dense stage with the polyphase factors as buffers
    ``matrixing`` [64, 32] and ``window`` [16, 32] (:func:`l12_tables`),
    one pair for both frame widths.

    ``forward(sb, synth_tail0=None) -> (pcm, synth_tail)`` with the
    reference's semantics; ``None`` means stream start."""

    def __init__(self, matrixing, window):
        super().__init__()
        self.register_buffer("matrixing", matrixing)
        self.register_buffer("window", window)

    @classmethod
    def from_numpy(cls, tables: Dict[str, np.ndarray], device) -> "L12Dense":
        """As :meth:`Mp3Dense.from_numpy`."""
        return cls(*_upload(tables, ("matrixing", "window"), device))

    @staticmethod
    def state_from_numpy(synth_tail: np.ndarray, device) -> torch.Tensor:
        """Carried ``synth_tail [C, 480]`` from numpy, e.g. handed over
        from the reference mid-stream."""
        return torch.from_numpy(np.array(synth_tail, np.float32)).to(
            torch.device(device))

    @staticmethod
    def state_to_numpy(synth_tail: torch.Tensor) -> np.ndarray:
        return synth_tail.cpu().numpy()

    def forward(self, sb, synth_tail0=None):
        T = sb.shape[3]
        if T not in L12_T:
            raise ValueError(f"T = {T}: Layer I has 12, Layer II 36")
        return mpa_l12_synth(sb, self.matrixing, self.window, synth_tail0)
