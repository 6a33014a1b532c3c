"""Vorbis dense stage: batched IMDCTs grouped by block size, and the lap.

PyTorch port of ``symphonia_tpu/ops/vorbis_dense.py``. The packet-channel
lanes of every stream are grouped by block size n (a power of two from 64
to 8192), and each group is one product ``[L, n/2] @ [n/2, n]`` with the
reference's unscaled IMDCT matrix (``imdct_matrix(n)``). The windowed lap
stitch between packets of a stream is the reference's numpy ``lap_stitch``,
copied here (``symphonia_tpu/ops/vorbis_dense.py:53-81``).

Two kernels (``csrc/vorbis_dense.cu``): ``vorbis_imdct`` (V1), the product
in true fp32 (it takes the full matrix, computes the product with its rows
``n/4 .. 3n/4 - 1`` and writes the other half of the output mirrored: bit
for bit the dense product for n <= 4096, within the Vorbis bar at 8192,
where 1618 matrix entries miss the mirror by one ulp; the twin stays the
dense product), and ``vorbis_lap`` (V2), the batched equal-size lap of the
reference's combined decode step (``__graft_entry__.py:117-121``), which
:mod:`..entry` runs. Each wrapper runs its plain PyTorch twin for CPU
tensors and launches its kernel for CUDA tensors, or raises. The matrices
are buffers of :class:`VorbisDense`, one per block size, built on first
use.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from .. import trace
from ..codecs.vorbis import imdct_matrix, vorbis_window
from . import _build

# Lanes per device product: a memory bound (n = 8192 takes 48 KB a lane).
LANE_CHUNK = 16384
BLOCK_SIZES = tuple(1 << e for e in range(6, 14))  # legal Vorbis n
# Rows per CPU product (see vorbis_imdct_plain).
CPU_ROWS = 256


def vorbis_imdct_plain(x, m):
    """Twin of V1: ``x [L, n/2] -> x @ m.T [L, n]``.

    On the CPU the product runs in blocks of exactly ``CPU_ROWS`` rows (the
    last one padded with zeros). The CPU BLAS picks its summation order by
    the product's shape (with fewer rows it splits K across threads), so
    blocks of one shape make each lane's result independent of how many
    lanes share the call: a merged decode then equals per-file decodes bit
    for bit, as V1's does on the card."""
    mt = m.T.contiguous()
    if x.device.type != "cpu":
        return torch.matmul(x, mt)
    L, k = x.shape
    out = torch.empty((L, mt.shape[1]), dtype=x.dtype)
    for s in range(0, L, CPU_ROWS):
        blk = x[s : s + CPU_ROWS]
        rows = blk.shape[0]
        if rows < CPU_ROWS:
            blk = torch.cat([blk, blk.new_zeros((CPU_ROWS - rows, k))])
        out[s : s + rows] = torch.matmul(blk, mt)[:rows]
    return out


def vorbis_imdct(x, m):
    """V1 wrapper: ``x [L, n/2] f32 -> [L, n]`` with ``m [n, n/2]``, the
    IMDCT matrix of block size n: the kernel reads its rows ``n/4 .. 3n/4
    - 1`` and mirrors the rest of the output."""
    L, k = x.shape
    if L == 0:
        raise ValueError("empty lane batch")
    if _build.device_type(x) == "cpu":
        return vorbis_imdct_plain(x, m)
    x = x.contiguous()
    m = m.contiguous()
    n = m.shape[0]
    if (x.dtype != torch.float32 or m.dtype != torch.float32
            or m.shape != (2 * k, k) or n not in BLOCK_SIZES):
        raise ValueError("f32 x [L, n/2], m [n, n/2], n a power of two in "
                         "64..8192")
    if x.data_ptr() % 16 or m.data_ptr() % 16:
        raise ValueError("x and m must be 16-byte aligned")
    dev = _build.require_cuda(x, m)
    y = torch.empty((L, n), dtype=torch.float32, device=dev)
    err = _build.lib().vorbis_imdct_launch(
        x.data_ptr(), m.data_ptr(), y.data_ptr(), L, n,
        _build.stream_ptr(dev))
    _build.LAUNCHES["vorbis_imdct"] += 1
    _build.check("vorbis_imdct", err)
    return y


def vorbis_lap_plain(t, w):
    """Twin of V2: ``t [V, n1]`` (consecutive blocks of n1 samples) and the
    window slope ``w [n1/2]`` -> ``pcm [V, n1/2]``, the reference's
    ``ov[:, :n1/2] * w[::-1] + t[:, :n1/2] * w`` with ``ov[r] = t[r-1,
    n1/2:]`` and ``ov[0] = 0``."""
    h = t.shape[1] // 2
    ov = torch.cat([t.new_zeros((1, h)), t[:-1, h:]], dim=0)
    return ov * w.flip(0) + t[:, :h] * w


def vorbis_lap(t, w):
    """V2 wrapper: ``t [V, n1] f32`` and ``w [n1/2]`` -> ``[V, n1/2]``."""
    V, n1 = t.shape
    if V == 0:
        raise ValueError("empty lane batch")
    if _build.device_type(t) == "cpu":
        return vorbis_lap_plain(t, w)
    t = t.contiguous()
    w = w.contiguous()
    if (t.dtype != torch.float32 or w.dtype != torch.float32 or n1 % 2
            or w.shape != (n1 // 2,)):
        raise ValueError("f32 t [V, n1] with n1 even, w [n1/2]")
    dev = _build.require_cuda(t, w)
    pcm = torch.empty((V, n1 // 2), dtype=torch.float32, device=dev)
    err = _build.lib().vorbis_lap_launch(
        t.data_ptr(), w.data_ptr(), pcm.data_ptr(), V, n1,
        _build.stream_ptr(dev))
    _build.LAUNCHES["vorbis_lap"] += 1
    _build.check("vorbis_lap", err)
    return pcm


def lap_stitch(
    imdcts: Sequence[np.ndarray], flags: Sequence[bool], bs0: int, bs1: int
) -> np.ndarray:
    """Windowed overlap-add across a packet sequence for one channel
    (dsp.rs DspChannel::synth semantics). imdcts[p] has length bs of
    packet p. The first packet produces no output (no left partner)."""
    w0 = vorbis_window(bs0)
    w1 = vorbis_window(bs1)
    outs: List[np.ndarray] = []
    for p in range(1, len(imdcts)):
        prev, cur = imdcts[p - 1], imdcts[p]
        prev_bs, bs = len(prev), len(cur)
        win = w1 if (prev_bs == bs1 and bs == bs1) else w0
        ov = prev[prev_bs // 2 :]
        out = np.empty((prev_bs + bs) // 4, dtype=np.float32)
        if prev_bs == bs:
            out[:] = ov[: bs // 2] * win[::-1] + cur[: bs // 2] * win
        elif prev_bs > bs:  # long -> short
            start = (bs1 - bs0) // 4
            end = start + bs0 // 2
            out[:start] = ov[:start]
            out[start:] = ov[start:end] * win[::-1] + cur[: bs0 // 2] * win
        else:  # short -> long
            start = (bs1 - bs0) // 4
            end = start + bs0 // 2
            out[: bs0 // 2] = ov[: bs0 // 2] * win[::-1] + cur[start:end] * win
            out[bs0 // 2 :] = cur[end : bs1 // 2]
        outs.append(out)
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


class VorbisDense(nn.Module):
    """The IMDCT matrices as buffers ``imdct_<n>`` on ``device``, one per
    block size; a block size not given at construction is built from the
    reference's ``imdct_matrix`` on first use."""

    def __init__(self, matrices: Dict[int, torch.Tensor], device):
        super().__init__()
        self.device = torch.device(device)
        for n, m in matrices.items():
            self.register_buffer(f"imdct_{n}", m.to(self.device))

    @classmethod
    def from_numpy(cls, tables: Dict[int, np.ndarray], device
                   ) -> "VorbisDense":
        return cls({n: torch.from_numpy(np.array(m, np.float32))
                    for n, m in tables.items()}, device)

    def matrix(self, n: int) -> torch.Tensor:
        name = f"imdct_{n}"
        if name not in self._buffers:
            if n not in BLOCK_SIZES:
                raise ValueError(f"block size {n} is not a Vorbis block size")
            self.register_buffer(name, torch.from_numpy(
                np.array(imdct_matrix(n))).to(self.device))
        return self._buffers[name]

    def imdct(self, x, n: int):
        """x [L, n/2] on this module's device -> [L, n]."""
        return vorbis_imdct(x, self.matrix(n))


# ---------------------------------------------------------------------------
# Counterparts of the reference's public functions
# ---------------------------------------------------------------------------


def imdct_group(spectra: np.ndarray, n: int, *, dense: VorbisDense
                ) -> np.ndarray:
    """The IMDCT of one block-size group, ``[L, n/2] -> [L, n]`` float32,
    in chunks of ``LANE_CHUNK`` lanes (any lane count is a valid shape)."""
    L = len(spectra)
    out = np.empty((L, n), np.float32)
    for s in range(0, L, LANE_CHUNK):
        x, = trace.to_device(dense.device, np.asarray(
            spectra[s : s + LANE_CHUNK], dtype=np.float32))
        with trace.span("enqueue"):
            y = dense.imdct(x, n)
        out[s : s + LANE_CHUNK] = trace.to_host(y)
    return out


def decode_packets_dense(spectra_list: Sequence[np.ndarray],
                         flags: Sequence[bool], bs0: int, bs1: int, *,
                         dense: VorbisDense) -> np.ndarray:
    """One packet sequence -> [C, total_samples] (see the multi-stream
    form)."""
    return decode_packets_dense_multi([(spectra_list, flags, bs0, bs1)],
                                      dense=dense)[0]


def decode_packets_dense_multi(jobs, *, dense: VorbisDense
                               ) -> List[np.ndarray]:
    """The reference's merged dense stage over several packet sequences.

    ``jobs``: (spectra_list, flags, bs0, bs1) per stream, spectra_list[p]
    ``[C, >= n/2]``. Lanes of every job group by block size, not by job, so
    all streams share one IMDCT per distinct n; the lap stitch stays
    per-stream host work. A job's channel count is its first packet's; a
    job without packets gives ``zeros((1, 0))``."""
    lane_map: dict = {}   # n -> list of [n/2] rows
    slot_map: dict = {}   # n -> list of (job, packet, channel)
    with trace.span("pack"):
        for ji, (spectra_list, flags, bs0, bs1) in enumerate(jobs):
            for p, f in enumerate(flags):
                n = bs1 if f else bs0
                for c in range(spectra_list[p].shape[0]):
                    lane_map.setdefault(n, []).append(
                        spectra_list[p][c][: n // 2])
                    slot_map.setdefault(n, []).append((ji, p, c))
    out_imdct = [
        [[None] * len(flags)
         for _ in range(spectra_list[0].shape[0] if spectra_list else 1)]
        for spectra_list, flags, _, _ in jobs
    ]
    for n, lanes in lane_map.items():
        with trace.span("pack"):
            rows = np.stack(lanes)
        y = imdct_group(rows, n, dense=dense)
        with trace.span("stitch"):
            for row, (ji, p, c) in enumerate(slot_map[n]):
                out_imdct[ji][c][p] = y[row]
    outs = []
    with trace.span("stitch"):
        for ji, (spectra_list, flags, bs0, bs1) in enumerate(jobs):
            if not spectra_list:
                outs.append(np.zeros((1, 0), np.float32))
                continue
            outs.append(np.stack([lap_stitch(ch, flags, bs0, bs1)
                                  for ch in out_imdct[ji]]))
    return outs
