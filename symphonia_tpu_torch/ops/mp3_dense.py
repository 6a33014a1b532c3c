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
  ``S [G, C, 576]`` (vec index t*32 + k);
* ``mp3_synth`` (M2): the product of ``S`` with the ``[1056, 576]``
  combined polyphase matrix in true fp32, with the 480-sample synthesis
  overlap-add fused into it.

Layer I/II (``:273``, ``l12_dense_batch_jax``) has no hybrid stage: its
bitstream stage's subband samples go straight into the polyphase product,
``[F*C, 32T] x [32T, 32T + 480]`` for T = 12 (Layer I) or 36 (Layer II),
and the 480-sample tail overlaps the next ceil(480 / 32T) frames (two for
Layer I), with a carried ``synth_tail [C, 480]`` between calls. One kernel,
``mpa_l12_synth`` (L1), M2's body for those T.

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
    """The dense stage's constant operators, from the builders above."""
    cs, ca = antialias_coeffs()
    return {
        "hybrid": hybrid_matrices(),               # [4, 36, 18]
        "cs": cs, "ca": ca,                        # [8] each
        "finv": freq_inversion_mask(),             # [32, 18]
        "polyphase": _polyphase_combined_matrix(),  # [1056, 576]
    }


L12_T = (12, 36)  # subband samples per frame: Layer I, Layer II


def l12_tables() -> Dict[int, np.ndarray]:
    """Layer I/II polyphase operators ``[(T+15)*32, 32T]`` per T, from the
    reference builder, with the K axis permuted into the order of the
    bitstream stage's ``sb [.., 32, T]`` (index k*T + t for subband k,
    sample t; the reference's is t*32 + k), so ``sb`` enters the product
    as it is."""
    out = {}
    for T in L12_T:
        m = _polyphase_combined_matrix(T)
        out[T] = np.ascontiguousarray(
            m.reshape(-1, T, 32).transpose(0, 2, 1).reshape(m.shape))
    return out


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


def mp3_synth_plain(S, polyphase, synth_tail0, boundary):
    """Twin of M2: S [G, C, 576] -> (pcm [G, C, 576], tail [C, 480])."""
    G, C, _ = S.shape
    # The CPU product's sum order depends on G (its BLAS splits K across
    # threads for few rows), so chained calls equal one call within fp32
    # rounding here, and bit for bit only in M2.
    resp = torch.matmul(S, polyphase.T.contiguous())  # [G, C, 1056]
    if synth_tail0 is None:
        synth_tail0 = torch.zeros((C, 480), dtype=S.dtype, device=S.device)
    prev = torch.cat([synth_tail0[None], resp[:-1, :, 576:]], dim=0)
    if boundary is not None:
        prev = torch.where(boundary[:, None, None], 0.0, prev)
    pcm = torch.cat([resp[:, :, :480] + prev, resp[:, :, 480:576]], dim=2)
    return pcm, resp[-1, :, 576:].clone()


def l12_synth_plain(sb, polyphase, synth_tail0):
    """Twin of L1: ``sb [F, C, 32, T] -> (pcm [F, C, 32T], tail [C, 480])``,
    the reference's ``l12_dense_batch_jax`` line for line, ``polyphase``
    from :func:`l12_tables` (K in sb's order)."""
    F, C, _, T = sb.shape
    n = 32 * T
    total = n + 480
    K = -(-480 // n)  # frames the tail reaches forward

    def zeros(*shape):
        return torch.zeros(shape, dtype=sb.dtype, device=sb.device)

    resp = torch.matmul(sb.reshape(F, C, n), polyphase.T.contiguous())
    if synth_tail0 is None:
        synth_tail0 = zeros(C, 480)
    pcm = resp[:, :, :n]
    # (a) tails of earlier frames in the batch: k-step shifts along F.
    for k in range(1, min(K, F) + 1):
        lo, hi = k * n, min((k + 1) * n, total)
        if lo >= total or F <= k:
            break
        seg = resp[: F - k, :, lo:hi]
        if hi - lo < n:
            seg = torch.cat([seg, zeros(F - k, C, n - (hi - lo))], dim=2)
        pcm = pcm + torch.cat([zeros(k, C, n), seg], dim=0)
    # (b) the carried tail, sliced across the first min(K, F) frames.
    carried = (torch.cat([synth_tail0, zeros(C, K * n - 480)], dim=1)
               if K * n > 480 else synth_tail0)
    nf = min(K, F)
    lead = carried[:, : nf * n].reshape(C, nf, n).transpose(0, 1)
    if nf < F:
        lead = torch.cat([lead, zeros(F - nf, C, n)], dim=0)
    pcm = pcm + lead
    # Outgoing tail: pending response of the last K frames (+ any carried
    # remainder when the batch is shorter than the tail's reach).
    synth_tail = zeros(C, 480)
    for j in range(min(K, F)):
        lo = n * (j + 1)
        width = min(480, total - lo)
        part = resp[F - 1 - j, :, lo : lo + width]
        if width < 480:
            part = torch.cat([part, zeros(C, 480 - width)], dim=1)
        synth_tail = synth_tail + part
    if F * n < 480:
        left = synth_tail0[:, F * n :]
        synth_tail = synth_tail + torch.cat(
            [left, zeros(C, 480 - left.shape[1])], dim=1)
    return pcm, synth_tail


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _opt_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def mp3_hybrid(x, bt, mixed, boundary, hybrid_tail0, T, cs, ca, finv):
    """M1 wrapper: (S [G, C, 576], hybrid_tail [C, 32, 18])."""
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
    S = torch.empty((G, C, 576), dtype=torch.float32, device=dev)
    tail = torch.empty((C, 32, 18), dtype=torch.float32, device=dev)
    lib = _build.lib()
    err = lib.mp3_hybrid_launch(
        x.data_ptr(), bt.data_ptr(), mixed.data_ptr(), _opt_ptr(boundary),
        _opt_ptr(hybrid_tail0), T.data_ptr(), cs.data_ptr(), ca.data_ptr(),
        finv.data_ptr(), S.data_ptr(), tail.data_ptr(), G, C,
        _build.stream_ptr(dev))
    _build.LAUNCHES["mp3_hybrid"] += 1
    _build.check("mp3_hybrid", err)
    return S, tail


def mp3_synth(S, polyphase, synth_tail0, boundary):
    """M2 wrapper: S [G, C, 576] -> (pcm [G, C, 576], tail [C, 480]), the
    polyphase product with ``polyphase [1056, 576]`` in true fp32 and the
    synthesis overlap-add in one kernel."""
    G, C, _ = S.shape
    if G == 0:
        raise ValueError("empty granule batch")
    if _build.device_type(S) == "cpu":
        return mp3_synth_plain(S, polyphase, synth_tail0, boundary)
    S = S.contiguous()
    boundary = (None if boundary is None
                else boundary.to(torch.bool).contiguous())
    synth_tail0 = (None if synth_tail0 is None
                   else synth_tail0.to(torch.float32).contiguous())
    opt = [t for t in (boundary, synth_tail0) if t is not None]
    dev = _build.require_cuda(S, polyphase, *opt)
    if (S.dtype != torch.float32 or S.shape[2] != 576
            or polyphase.dtype != torch.float32
            or polyphase.shape != (1056, 576)
            or (boundary is not None and boundary.shape != (G,))
            or (synth_tail0 is not None and synth_tail0.shape != (C, 480))):
        raise ValueError("f32 S [G, C, 576], polyphase [1056, 576], "
                         "boundary [G], tail [C, 480]")
    if S.data_ptr() % 16 or polyphase.data_ptr() % 16:
        raise ValueError("S and polyphase must be 16-byte aligned")
    pcm = torch.empty((G, C, 576), dtype=torch.float32, device=dev)
    tail = torch.empty((C, 480), dtype=torch.float32, device=dev)
    lib = _build.lib()
    err = lib.mp3_synth_launch(
        S.data_ptr(), polyphase.data_ptr(), _opt_ptr(synth_tail0),
        _opt_ptr(boundary), pcm.data_ptr(), tail.data_ptr(), G, C,
        _build.stream_ptr(dev))
    _build.LAUNCHES["mp3_synth"] += 1
    _build.check("mp3_synth", err)
    return pcm, tail


def mpa_l12_synth(sb, polyphase, synth_tail0):
    """L1 wrapper: ``sb [F, C, 32, T] -> (pcm [F, C, 32T], tail [C,
    480])`` for T = 12 or 36, the polyphase product with ``polyphase``
    (:func:`l12_tables`) in true fp32 and the K-step overlap-add in one
    kernel; ``synth_tail0`` None means stream start."""
    F, C, _, T = sb.shape
    if F == 0:
        raise ValueError("empty frame batch")
    if _build.device_type(sb) == "cpu":
        return l12_synth_plain(sb, polyphase, synth_tail0)
    sb = sb.contiguous()
    synth_tail0 = (None if synth_tail0 is None
                   else synth_tail0.to(torch.float32).contiguous())
    opt = [] if synth_tail0 is None else [synth_tail0]
    dev = _build.require_cuda(sb, polyphase, *opt)
    if (sb.dtype != torch.float32 or sb.shape[2] != 32 or T not in L12_T
            or polyphase.dtype != torch.float32
            or polyphase.shape != ((T + 15) * 32, 32 * T)
            or (synth_tail0 is not None and synth_tail0.shape != (C, 480))):
        raise ValueError("f32 sb [F, C, 32, T] with T 12 or 36, polyphase "
                         "[(T+15)*32, 32T], tail [C, 480]")
    if sb.data_ptr() % 16 or polyphase.data_ptr() % 16:
        raise ValueError("sb and polyphase must be 16-byte aligned")
    pcm = torch.empty((F, C, 32 * T), dtype=torch.float32, device=dev)
    tail = torch.empty((C, 480), dtype=torch.float32, device=dev)
    err = _build.lib().mpa_l12_synth_launch(
        sb.data_ptr(), polyphase.data_ptr(), _opt_ptr(synth_tail0),
        pcm.data_ptr(), tail.data_ptr(), F, C, T, _build.stream_ptr(dev))
    _build.LAUNCHES["mpa_l12_synth"] += 1
    _build.check("mpa_l12_synth", err)
    return pcm, tail


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


class Mp3Dense(nn.Module):
    """The Layer III dense stage with its constant operators as buffers.

    ``forward(x, bt, mixed, hybrid_tail0=None, synth_tail0=None,
    boundary=None) -> (pcm, hybrid_tail, synth_tail)`` with the reference's
    semantics; ``None`` tails mean stream start."""

    def __init__(self, hybrid, cs, ca, finv, polyphase):
        super().__init__()
        self.register_buffer("hybrid", hybrid)        # [4, 36, 18]
        self.register_buffer("cs", cs)                # [8]
        self.register_buffer("ca", ca)                # [8]
        self.register_buffer("finv", finv)            # [32, 18]
        self.register_buffer("polyphase", polyphase)  # [1056, 576]

    @classmethod
    def from_numpy(cls, tables: Dict[str, np.ndarray], device) -> "Mp3Dense":
        def t(k):
            return torch.from_numpy(np.ascontiguousarray(
                tables[k], dtype=np.float32))

        return cls(t("hybrid"), t("cs"), t("ca"), t("finv"),
                   t("polyphase")).to(torch.device(device))

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
        pcm, synth_tail = mp3_synth(S, self.polyphase, synth_tail0, boundary)
        return pcm, hybrid_tail, synth_tail


class L12Dense(nn.Module):
    """The Layer I/II dense stage with its polyphase operators as buffers
    ``polyphase_12`` [864, 384] and ``polyphase_36`` [1632, 1152]
    (:func:`l12_tables`).

    ``forward(sb, synth_tail0=None) -> (pcm, synth_tail)`` with the
    reference's semantics; ``None`` means stream start."""

    def __init__(self, polyphase_12, polyphase_36):
        super().__init__()
        self.register_buffer("polyphase_12", polyphase_12)
        self.register_buffer("polyphase_36", polyphase_36)

    @classmethod
    def from_numpy(cls, tables: Dict[int, np.ndarray], device) -> "L12Dense":
        return cls(*(torch.from_numpy(np.array(tables[T], np.float32))
                     for T in L12_T)).to(torch.device(device))

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
        return mpa_l12_synth(sb, getattr(self, f"polyphase_{T}"),
                             synth_tail0)
