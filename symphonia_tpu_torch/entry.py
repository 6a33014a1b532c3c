"""The combined four-codec decode step: the port of the driver entry point.

Counterpart of ``__graft_entry__.py`` (whose name, at the repository root,
belongs to the driver): :func:`decode_step` is its ``_decode_step`` (K14,
``:62``), one dense-stage step over a FLAC, an MP3, an AAC and a Vorbis
lane batch, composed of the port's kernels:

* FLAC: F1 ``flac_lpc`` (recurrence and wasted bits) over ``[2F, N]``
  lanes, then F2 ``flac_decorrelate`` over ``[F, 2, N]``;
* MP3: M1 ``mp3_hybrid`` and M2 ``mp3_synth`` (the factored polyphase
  synthesis: matrixing, then the 16-tap windowed FIR) with zero carried
  state, all ``G`` granules one stream;
* AAC: A1 ``aac_imdct`` with its dequant prologue over the lanes whose
  window sequence is not EIGHT_SHORT, A1 without it over the ``[8S, 128]``
  windows of the short lanes (A2 ``aac_dequant`` first where a short lane
  hands off, ``deq == 0``), then A3 ``aac_ola`` over the whole batch as one
  sequence;
* Vorbis: V1 ``vorbis_imdct`` at block size ``n1``, then V2 ``vorbis_lap``.

:func:`decode_step_plain` is the same step of the plain twins (tests and
``chip_smoke.py`` hold the kernels against it). :func:`example_batch` is
the reference's ``_example_batch`` (``:126``), equal array by array, and
:func:`entry` gives ``(fn, args)`` as the reference's ``entry()`` does,
with ``args`` as tensors on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from functools import lru_cache, partial
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from .batch import resolve_device
from .codecs.aac import EIGHT_SHORT, subband_info
from .codecs.vorbis import vorbis_window
from .native import aac_sfb_map
from .ops import aac_dense, flac_dense, mp3_dense, vorbis_dense


def example_batch(F: int = 8, N: int = 256, G: int = 8, A: int = 8,
                  V: int = 8, n1: int = 512, seed: int = 0,
                  aac_rate: int = 44100):
    """The reference's example step inputs, numpy, from ``seed``: FLAC
    ``[2F, N]`` residual lanes with random LPC coefficients (their sums
    wrap int32 all the time), ``G`` stereo MP3 granules, ``A`` AAC lanes
    (about half of the long ones hand off their quants, ``deq == 0``), ``V``
    Vorbis spectra of block size ``n1``, and the per-coefficient band map
    for ``aac_rate``."""
    rng = np.random.default_rng(seed)
    L = 2 * F
    res = rng.integers(-1000, 1000, size=(L, N)).astype(np.int32)
    coefs = np.zeros((L, 32), dtype=np.int32)
    order = np.zeros(L, dtype=np.int32)
    shift = np.zeros(L, dtype=np.int32)
    wasted = np.zeros(L, dtype=np.int32)
    assign = rng.integers(0, 4, size=F).astype(np.int32)
    for l in range(L):
        k = int(rng.integers(0, 13))
        order[l] = k
        if k:
            coefs[l, :k] = rng.integers(-(2**13), 2**13, size=k)
            shift[l] = int(rng.integers(8, 15))
    spectra = (rng.standard_normal((G, 2, 576)) * 0.05).astype(np.float32)
    bt = rng.integers(0, 4, size=(G, 2)).astype(np.int32)
    mixed = (bt == 2) & (rng.random((G, 2)) < 0.5)
    aac_coeffs = (rng.standard_normal((A, 1024)) * 0.05).astype(np.float32)
    aac_seqs = rng.integers(0, 4, size=A).astype(np.int32)
    aac_shapes = rng.integers(0, 2, size=A).astype(np.int32)
    aac_prev = np.concatenate([[0], aac_shapes[:-1]]).astype(np.int32)
    aac_qbuf = rng.integers(-60, 61, size=(A, 1024)).astype(np.int16)
    aac_scales = np.abs(rng.standard_normal((A, 64)) * 0.01).astype(
        np.float32)
    aac_deq = ((aac_seqs == 2) | (rng.random(A) < 0.5)).astype(np.int32)
    vorb_spec = (rng.standard_normal((V, n1 // 2)) * 0.05).astype(np.float32)
    _, bl, _ = subband_info(aac_rate)
    aac_sfb = np.asarray(aac_sfb_map(bl), dtype=np.int32)
    return (res, coefs, order, shift, wasted, assign, spectra, bt, mixed,
            aac_coeffs, aac_qbuf, aac_scales, aac_deq,
            aac_seqs, aac_shapes, aac_prev, aac_sfb, vorb_spec)


class _Constants:
    """The step's constant operators on one device: the MP3 and AAC dense
    stages' buffers, the Vorbis IMDCT matrices and window slopes by block
    size."""

    def __init__(self, device: torch.device):
        self.mp3 = mp3_dense.Mp3Dense.from_numpy(
            mp3_dense.reference_tables(), device)
        self.aac = aac_dense.AacDense.from_numpy(
            aac_dense.reference_tables(), device)
        self.vorbis = vorbis_dense.VorbisDense({}, device)
        self._windows: Dict[int, torch.Tensor] = {}

    def window(self, n: int) -> torch.Tensor:
        if n not in self._windows:
            self._windows[n] = torch.from_numpy(vorbis_window(n)).to(
                self.vorbis.device)
        return self._windows[n]


@lru_cache(maxsize=None)
def _constants(device: torch.device) -> _Constants:
    return _Constants(device)


def _stages(plain: bool) -> SimpleNamespace:
    """The step's stages: the kernel wrappers, or their plain twins."""
    fd, md, ad, vd = flac_dense, mp3_dense, aac_dense, vorbis_dense
    if plain:
        return SimpleNamespace(
            lpc=lambda res, c, o, s, n, w: fd.apply_wasted_bits(
                fd.lpc_reconstruct_plain(res, c, o, s, n), w),
            decorrelate=fd.decorrelate_plain, hybrid=md.mp3_hybrid_plain,
            synth=md.mp3_synth_plain, imdct=ad.aac_imdct_plain,
            dequant=ad.aac_dequant_plain, ola=ad.aac_ola_plain,
            vorbis_imdct=vd.vorbis_imdct_plain, lap=vd.vorbis_lap_plain)
    return SimpleNamespace(
        lpc=lambda res, c, o, s, n, w: fd.lpc_reconstruct_batch(
            res, c, o, s, n, wasted=w),
        decorrelate=fd.decorrelate_batch, hybrid=md.mp3_hybrid,
        synth=md.mp3_synth, imdct=ad.aac_imdct, dequant=ad.aac_dequant,
        ola=ad.aac_ola, vorbis_imdct=vd.vorbis_imdct, lap=vd.vorbis_lap)


def _step(k: SimpleNamespace, flac_res, flac_coefs, flac_order, flac_shift,
          flac_wasted, flac_assign, mp3_spectra, mp3_bt, mp3_mixed,
          aac_coeffs, aac_qbuf, aac_scales, aac_deq, aac_seqs, aac_shapes,
          aac_prev_shapes, aac_sfb, vorb_spec, n_samples: int):
    dev = flac_res.device
    c = _constants(dev)

    # --- FLAC ---
    x = k.lpc(flac_res, flac_coefs, flac_order, flac_shift, n_samples,
              flac_wasted)
    F = flac_res.shape[0] // 2
    flac_pcm = k.decorrelate(x.reshape(F, 2, n_samples), flac_assign)

    # --- MP3: one stream, zero carried state ---
    mp3 = c.mp3
    S, _ = k.hybrid(mp3_spectra, mp3_bt, mp3_mixed, None, None, mp3.hybrid,
                    mp3.cs, mp3.ca, mp3.finv)
    mp3_pcm, _ = k.synth(S, mp3.matrixing, mp3.window, None, None)

    # --- AAC: dequantize the handoff lanes, one IMDCT per window class,
    # then the window/overlap-add over the batch as one sequence ---
    aac = c.aac
    A = aac_coeffs.shape[0]
    is_short = aac_seqs == EIGHT_SHORT
    aac_time = torch.empty((A, 2048), dtype=torch.float32, device=dev)
    for rows, short in ((torch.nonzero(~is_short).flatten(), False),
                        (torch.nonzero(is_short).flatten(), True)):
        if not rows.numel():
            continue
        x = aac_coeffs.index_select(0, rows)
        quant = tuple(t.index_select(0, rows)
                      for t in (aac_qbuf, aac_scales, aac_deq)) + (
                          aac_sfb, aac.pow43)
        if not short:
            y = k.imdct(x, aac.imdct_long, quant)
        else:
            if bool((quant[2] == 0).any()):
                x = k.dequant(x, *quant)
            y = k.imdct(x.reshape(-1, 128), aac.imdct_short)
        aac_time.index_copy_(0, rows, y.reshape(-1, 2048))
    first = torch.zeros(A, dtype=torch.bool, device=dev)
    first[0] = True
    aac_pcm = k.ola(aac_time, aac_seqs, aac_shapes, aac_prev_shapes, first,
                    *aac.ola_tables)

    # --- Vorbis: one block size n1, then the lap of consecutive lanes ---
    n1 = 2 * vorb_spec.shape[1]
    vorb_time = k.vorbis_imdct(vorb_spec, c.vorbis.matrix(n1))
    vorb_pcm = k.lap(vorb_time, c.window(n1))
    return flac_pcm, mp3_pcm, aac_pcm, vorb_pcm


def decode_step(*args, n_samples: int) -> Tuple[torch.Tensor, ...]:
    """One combined decode step on the inputs' device, in the reference
    step's argument order: ``(flac_res, flac_coefs, flac_order,
    flac_shift, flac_wasted, flac_assign, mp3_spectra, mp3_bt, mp3_mixed,
    aac_coeffs, aac_qbuf, aac_scales, aac_deq, aac_seqs, aac_shapes,
    aac_prev_shapes, aac_sfb, vorb_spec)`` -> ``(flac_pcm [F, 2, N],
    mp3_pcm [G, 2, 576], aac_pcm [A, 1024], vorb_pcm [V, n1/2])``. On CUDA
    tensors each stage launches its kernel or raises."""
    return _step(_stages(False), *args, n_samples=n_samples)


def decode_step_plain(*args, n_samples: int) -> Tuple[torch.Tensor, ...]:
    """:func:`decode_step` composed of the kernels' plain PyTorch twins."""
    return _step(_stages(True), *args, n_samples=n_samples)


def entry(device="cuda"):
    """``(fn, args)``: the step at ``n_samples = 256`` and the reference
    entry's example batch (8 lanes a codec) as tensors on ``device``, the
    card unless the caller asks for ``"cpu"``; raises without CUDA."""
    dev = resolve_device(device)
    N = 256
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in example_batch(F=8, N=N, G=8, A=8, V=8))
    return partial(decode_step, n_samples=N), args
