"""AAC-LC dense stage: batched IMDCTs, then the window/overlap-add chain.

PyTorch port of ``symphonia_tpu/ops/aac_dense.py``. A frame's coefficients
go through a 2048-point IMDCT (long-window frames, ``[L, 1024] @ [1024,
2048]``) or eight 256-point ones (EIGHT_SHORT frames, ``[8 L, 128] @ [128,
256]``); the window products and the overlap-add with the previous frame
follow (dsp.rs:56-159, re-expressed frame-locally by the reference).

Three kernels (``csrc/aac_dense.cu``):

* ``aac_imdct`` (A1): the IMDCT product in true fp32, with an optional
  prologue that dequantizes the entropy stage's handoff lanes (``deq ==
  0``) while loading them (K6 with it, K7 without). It takes the full
  ``[2n, n]`` matrix, computes the product with its rows ``n/2 .. 3n/2 -
  1`` and writes the other half of the output mirrored (half of each
  matrix's rows are exact negated copies of the others), bit for bit
  equal to the dense product; its twin stays the dense product. With a
  row map (``rows``, ``n_rows`` on the card) it reads and writes only the
  lanes the index names, in place in a caller's output: the entry step and
  :meth:`AacDense.decode_lanes` split long from short lanes that way, with
  no gather or scatter copy (and, in the step, no count on the host);
* ``aac_dequant`` (A2): that prologue alone (K9), behind
  :func:`dequant_select` and, through the same row map, before the entry
  step's short IMDCT;
* ``aac_ola`` (A3): the window/overlap-add (K8) over lanes of many
  (file, channel) sequences in one launch, with a ``first [L]`` mask that
  is true where a sequence starts (its previous delay is zero). A block
  takes one lane, a thread four consecutive samples: 16-byte loads of pcm
  and of the window rows, one 16-byte store, each pcm element read once.

Each wrapper runs its plain PyTorch twin for CPU tensors and launches its
kernel for CUDA tensors, or raises. The constant tables come from the
reference package's numpy builders (``codecs/aac.py`` and ``_ola_tables``
below, copied with the sequential oracle ``window_ola_chain`` from
``symphonia_tpu/ops/aac_dense.py:179-205, 277-327``) and are held as
buffers of :class:`AacDense`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import trace
from ..codecs.aac import (
    EIGHT_SHORT,
    LONG_START,
    LONG_STOP,
    ONLY_LONG,
    Dsp,
    imdct_matrix_scaled,
)
from ..native import aac_pow43, aac_sfb_map
from . import _build

# ---------------------------------------------------------------------------
# The window tables and the sequential oracle (numpy)
# ---------------------------------------------------------------------------

_P0 = 512 - 64
_P1 = 512 + 64


@lru_cache(maxsize=None)
def _ola_tables():
    """Per-(seq, shape) window vectors for the batched OLA.

    head[seq, prev_shape] multiplies pcm[:1024]; delay[seq, shape]
    multiplies pcm[1024:] (dsp.rs:56-159 re-expressed as frame-local
    elementwise products — the overlap-add only ever spans adjacent
    frames, so the whole chain batches with one roll)."""
    dsp = Dsp()
    longs = [dsp.sine_long, dsp.kbd_long]
    shorts = [dsp.sine_short, dsp.kbd_short]
    z448 = np.zeros(448, np.float32)
    o448 = np.ones(448, np.float32)
    head = np.zeros((4, 2, 1024), np.float32)
    delay = np.zeros((4, 2, 1024), np.float32)
    for sh in range(2):
        head[ONLY_LONG, sh] = longs[sh]
        head[LONG_START, sh] = longs[sh]
        head[LONG_STOP, sh] = np.concatenate([z448, shorts[sh], o448])
        delay[ONLY_LONG, sh] = longs[sh][::-1]
        delay[LONG_STOP, sh] = longs[sh][::-1]
        delay[LONG_START, sh] = np.concatenate([o448, shorts[sh][::-1], z448])
    # Short-window left/right half-window vectors.
    s_first = np.stack(shorts)          # [2,128] left window of w=0 (prev shape)
    s_left = np.stack(shorts)           # [2,128] left window of w>0 (cur shape)
    s_right = np.stack([s[::-1] for s in shorts])  # [2,128]
    return head, delay, s_first, s_left, s_right


def window_ola_chain(
    pcms: Sequence[np.ndarray],
    seqs: Sequence[int],
    shapes: Sequence[bool],
    prev_shapes: Sequence[bool],
) -> np.ndarray:
    """The stateful window/overlap-add chain over a frame sequence for one
    channel (dsp.rs:56-159 with the IMDCT precomputed). Returns the
    concatenated 1024-sample frames."""
    dsp = Dsp()
    delay = np.zeros(1024, np.float32)
    outs = []
    for pcm, seq, shape, prev_shape in zip(pcms, seqs, shapes, prev_shapes):
        long_win = dsp.kbd_long if shape else dsp.sine_long
        short_win = dsp.kbd_short if shape else dsp.sine_short
        prev_long = dsp.kbd_long if prev_shape else dsp.sine_long
        prev_short = dsp.kbd_short if prev_shape else dsp.sine_short
        dst = np.empty(1024, np.float32)
        if seq == EIGHT_SHORT:
            short = np.zeros(1152, np.float32)
            for w in range(8):
                src = pcm[w]
                left_w = prev_short if w == 0 else short_win
                if w == 0:
                    short[:128] = src[:128] * left_w
                    short[128:256] = src[128:256] * short_win[::-1]
                else:
                    short[w * 128 : w * 128 + 128] += src[:128] * short_win
                    short[w * 128 + 128 : w * 128 + 256] += src[128:] * short_win[::-1]
            dst[:_P0] = delay[:_P0]
            dst[_P0:] = delay[_P0:] + short[: 1024 - _P0]
            new_delay = np.zeros(1024, np.float32)
            new_delay[:_P1] = short[_P1 : 2 * _P1]
        elif seq in (ONLY_LONG, LONG_START):
            dst[:] = delay + pcm[:1024] * prev_long
            if seq == ONLY_LONG:
                new_delay = pcm[1024:] * long_win[::-1]
            else:
                new_delay = np.zeros(1024, np.float32)
                new_delay[:_P0] = pcm[1024 : 1024 + _P0]
                new_delay[_P0:_P1] = (
                    pcm[1024 + _P0 : 1024 + _P1] * short_win[::-1][: _P1 - _P0]
                )
        else:  # LONG_STOP
            dst[:_P0] = delay[:_P0]
            dst[_P0:_P1] = delay[_P0:_P1] + pcm[_P0:_P1] * prev_short[: _P1 - _P0]
            dst[_P1:] = delay[_P1:] + pcm[_P1:1024]
            new_delay = pcm[1024:] * long_win[::-1]
        delay = new_delay
        outs.append(dst)
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


# The dequant handoff's operands: (qbuf [L, 1024] i16, scales [L, 64] f32,
# deq [L] i32, sfb_map [1024] i32, pow43 [8192] f32).
Quant = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]

_OLA_KEYS = ("ola_head", "ola_delay", "ola_s_first", "ola_s_left",
             "ola_s_right")


def reference_tables() -> Dict[str, np.ndarray]:
    """The dense stage's constants, from the numpy builders."""
    head, delay, s_first, s_left, s_right = _ola_tables()
    return {
        "imdct_long": imdct_matrix_scaled(1024),   # [2048, 1024]
        "imdct_short": imdct_matrix_scaled(128),   # [256, 128]
        "pow43": aac_pow43(),                      # [8192]
        "ola_head": head,                          # [4, 2, 1024]
        "ola_delay": delay,                        # [4, 2, 1024]
        "ola_s_first": s_first,                    # [2, 128]
        "ola_s_left": s_left,                      # [2, 128]
        "ola_s_right": s_right,                    # [2, 128]
    }


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _lanes(rows, n_rows) -> torch.Tensor:
    """The plain twins' view of a row map: the lanes ``rows[:n_rows]`` as an
    index (``int`` of a count on the card waits for it; the kernels never
    do)."""
    return rows[: int(n_rows)].long()


def aac_dequant_plain(coeffs, qbuf, scales, deq, sfb_map, pow43, rows=None,
                      n_rows=None):
    """Twin of A2: ``+-(pow43[min(|q|, 8191)] * scale[sfb_map[i]])`` where
    ``deq == 0``, else ``coeffs``. Rows with ``deq != 0`` may overflow to
    inf here; the select discards them (a select, never a mask product).
    The +0.0 turns -0.0 into +0.0, as ``native.aac_dequant_host`` does.
    With ``rows``: the same at the lanes ``rows[:n_rows]`` only (gather,
    dequantize, scatter) in a new ``[L, 1024]`` tensor whose other rows are
    undefined."""
    if rows is not None:
        lanes = _lanes(rows, n_rows)
        out = torch.empty(coeffs.shape, dtype=torch.float32,
                          device=coeffs.device)
        out[lanes] = aac_dequant_plain(coeffs[lanes], qbuf[lanes],
                                       scales[lanes], deq[lanes], sfb_map,
                                       pow43)
        return out
    q = qbuf.to(torch.int32)
    mag = q.abs().clamp_max(8191).long()
    v = pow43[mag] * scales[..., sfb_map.long()]
    v = torch.where(q < 0, -v, v) + 0.0
    return torch.where((deq == 0)[..., None], v, coeffs)


def aac_imdct_plain(x, m, quant: Optional[Quant] = None, rows=None,
                    n_rows=None, out=None):
    """Twin of A1: ``x [L, n] -> x @ m.T [L, 2n]``, the handoff rows
    dequantized first when ``quant`` is given. With ``rows``: ``x [A,
    1024]`` lanes, and the lanes ``rows[:n_rows]`` gathered (with their
    quants), each as ``1024 / n`` rows of ``n`` (the eight short windows at
    n = 128), multiplied, and scattered into ``out [A, 2048]``, which is
    returned; its other rows are left as they are."""
    if rows is not None:
        lanes = _lanes(rows, n_rows)
        q = None if quant is None else (
            tuple(t[lanes] for t in quant[:3]) + tuple(quant[3:]))
        y = aac_imdct_plain(x[lanes].reshape(-1, m.shape[1]), m, q)
        out[lanes] = y.reshape(len(lanes), out.shape[1])
        return out
    if quant is not None:
        x = aac_dequant_plain(x, *quant)
    return torch.matmul(x, m.T)


def aac_ola_plain(pcm, seqs, shapes, prev_shapes, first, head_t, delay_t,
                  s_first, s_left, s_right):
    """Twin of A3: pcm [L, 2048] -> [L, 1024], the reference's ``_ola_jax``
    with the previous frame's delay zeroed where ``first`` (and at row 0)."""
    L = pcm.shape[0]
    seqs, shapes, prev = seqs.long(), shapes.long(), prev_shapes.long()
    head_long = pcm[:, :1024] * head_t[seqs, prev]
    delay_long = pcm[:, 1024:] * delay_t[seqs, shapes]
    # EIGHT_SHORT: in-frame OLA of 8 x 256 windows at hop 128. Slot k of s
    # holds window k-1's right half plus window k's left half, in that order.
    w8 = pcm.reshape(L, 8, 256)
    lw = s_left[shapes][:, None, :].repeat(1, 8, 1)
    lw[:, 0] = s_first[prev]
    s = torch.zeros((L, 9, 128), dtype=pcm.dtype, device=pcm.device)
    s[:, 1:] = w8[:, :, 128:] * s_right[shapes][:, None, :]
    s[:, :8] = s[:, :8] + w8[:, :, :128] * lw
    s = s.reshape(L, 1152)
    z = torch.zeros((L, 448), dtype=pcm.dtype, device=pcm.device)
    head_short = torch.cat([z, s[:, :576]], dim=1)
    delay_short = torch.cat([s[:, 576:], z], dim=1)
    is_short = (seqs == EIGHT_SHORT)[:, None]
    head = torch.where(is_short, head_short, head_long)
    delay = torch.where(is_short, delay_short, delay_long)
    prev_delay = torch.cat([torch.zeros_like(delay[:1]), delay[:-1]], dim=0)
    prev_delay = torch.where(first.to(torch.bool)[:, None], 0.0, prev_delay)
    return head + prev_delay


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_quant(quant: Quant, L: int) -> Quant:
    qbuf, scales, deq, sfb_map, pow43 = quant
    qbuf = qbuf.to(torch.int16).contiguous()
    scales = scales.to(torch.float32).contiguous()
    deq = deq.to(torch.int32).contiguous()
    sfb_map = sfb_map.to(torch.int32).contiguous()
    pow43 = pow43.to(torch.float32).contiguous()
    if (qbuf.shape != (L, 1024) or scales.shape != (L, 64)
            or deq.shape != (L,) or sfb_map.shape != (1024,)
            or pow43.shape != (8192,)):
        raise ValueError("qbuf [L, 1024], scales [L, 64], deq [L], "
                         "sfb_map [1024], pow43 [8192]")
    if qbuf.data_ptr() % 16:
        raise ValueError("qbuf must be 16-byte aligned")
    return qbuf, scales, deq, sfb_map, pow43


def _check_rows(rows, n_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row map as the kernels take it: ``rows`` int32 [R] and ``n_rows``
    one int32 (<= R, not checked: it stays on the device), both
    contiguous; no conversion, which would copy."""
    if (rows.dtype != torch.int32 or rows.dim() != 1 or rows.numel() == 0
            or n_rows.dtype != torch.int32 or n_rows.numel() != 1):
        raise ValueError("rows int32 [R], R > 0, and n_rows one int32")
    return rows, n_rows


def aac_imdct(x, m, quant: Optional[Quant] = None, *, rows=None, n_rows=None,
              out=None):
    """A1 wrapper: ``x [L, n] f32 -> [L, 2n]`` with ``m [2n, n]``; ``quant``
    turns the dequant prologue on (n = 1024). ``m`` is an IMDCT matrix
    (``imdct_long``, ``imdct_short``): the kernel reads its rows ``n/2 ..
    3n/2 - 1`` and mirrors the rest of the output.

    With a row map (``rows`` int32 [R] and ``n_rows``, one int32 <= R, both
    on the card, and ``out``): ``x [A, 1024]`` and ``quant`` are lanes, and
    the lanes ``rows[:n_rows]`` go through the product, each as ``1024 /
    n`` rows of ``n`` (a long frame at n = 1024, eight short windows at n =
    128), into the same lanes of ``out [A, 2048]``, which is returned. No
    other row of ``out`` is written, nothing is gathered or scattered, and
    the count stays on the card: blocks past it return at once."""
    mapped = rows is not None
    if mapped != (n_rows is not None) or mapped != (out is not None):
        raise ValueError("rows, n_rows and out go together")
    if x.shape[0] == 0:
        raise ValueError("empty lane batch")
    if _build.device_type(x) == "cpu":
        return aac_imdct_plain(x, m, quant, rows, n_rows, out)
    x = x.contiguous()
    m = m.contiguous()
    A = x.shape[0]
    n = m.shape[1] if mapped else x.shape[1]
    if (x.dtype != torch.float32 or m.dtype != torch.float32
            or m.shape != (2 * n, n) or n % 64
            or (quant is not None and n != 1024)):
        raise ValueError("f32 x [L, n], m [2n, n], n % 64 == 0, n == 1024 "
                         "with the dequant prologue")
    if mapped and (x.shape[1] != 1024 or 1024 % n
                   or out.shape != (A, 2048) or out.dtype != torch.float32):
        raise ValueError("with a row map: x [A, 1024], out f32 [A, 2048], "
                         "n dividing 1024")
    if x.data_ptr() % 16 or m.data_ptr() % 16 or (
            mapped and out.data_ptr() % 16):
        raise ValueError("x, m and out must be 16-byte aligned")
    q = () if quant is None else _check_quant(quant, A)
    r = _check_rows(rows, n_rows) if mapped else ()
    dev = _build.require_cuda(x, m, *q, *r, *((out,) if mapped else ()))
    group = 1024 // n if mapped else 1
    y = out if mapped else torch.empty((A, 2 * n), dtype=torch.float32,
                                       device=dev)
    qp = [None] * 5 if quant is None else [t.data_ptr() for t in q]
    rp = [t.data_ptr() for t in r] if mapped else [None, None]
    err = _build.lib().aac_imdct_launch(
        x.data_ptr(), m.data_ptr(), *qp, y.data_ptr(), A * group, n, *rp,
        rows.numel() if mapped else 0, group, _build.stream_ptr(dev))
    _build.LAUNCHES["aac_imdct"] += 1
    _build.check("aac_imdct", err)
    return y


def aac_dequant(coeffs, qbuf, scales, deq, sfb_map, pow43, *, rows=None,
                n_rows=None):
    """A2 wrapper: ``coeffs [L, 1024]`` with the handoff rows (``deq ==
    0``) replaced by their dequantized quants. With a row map (``rows``
    int32 [R] and ``n_rows``, one int32 <= R, on the card): only the rows
    ``rows[:n_rows]`` are written, in a new ``[L, 1024]`` tensor whose
    other rows are undefined; the count stays on the card."""
    if (rows is None) != (n_rows is None):
        raise ValueError("rows and n_rows go together")
    L = coeffs.shape[0]
    if L == 0:
        raise ValueError("empty lane batch")
    if _build.device_type(coeffs) == "cpu":
        return aac_dequant_plain(coeffs, qbuf, scales, deq, sfb_map, pow43,
                                 rows, n_rows)
    coeffs = coeffs.to(torch.float32).contiguous()
    if coeffs.shape != (L, 1024):
        raise ValueError("coeffs [L, 1024]")
    q = _check_quant((qbuf, scales, deq, sfb_map, pow43), L)
    r = () if rows is None else _check_rows(rows, n_rows)
    dev = _build.require_cuda(coeffs, *q, *r)
    out = torch.empty((L, 1024), dtype=torch.float32, device=dev)
    err = _build.lib().aac_dequant_launch(
        coeffs.data_ptr(), *(t.data_ptr() for t in q), out.data_ptr(), L,
        *([t.data_ptr() for t in r] if r else [None, None]),
        rows.numel() if r else 0, _build.stream_ptr(dev))
    _build.LAUNCHES["aac_dequant"] += 1
    _build.check("aac_dequant", err)
    return out


def aac_ola(pcm, seqs, shapes, prev_shapes, first, head_t, delay_t,
            s_first, s_left, s_right):
    """A3 wrapper: ``pcm [L, 2048] -> [L, 1024]``; ``first [L]`` is true
    where a sequence starts. On the card ``pcm`` and the tables must be
    16-byte aligned (the kernel moves four samples at a time)."""
    L = pcm.shape[0]
    if L == 0:
        raise ValueError("empty lane batch")
    if _build.device_type(pcm) == "cpu":
        return aac_ola_plain(pcm, seqs, shapes, prev_shapes, first, head_t,
                             delay_t, s_first, s_left, s_right)
    pcm = pcm.to(torch.float32).contiguous()
    lanes = [t.to(torch.int32).contiguous()
             for t in (seqs, shapes, prev_shapes)]
    first = first.to(torch.bool).contiguous()
    tables = [t.to(torch.float32).contiguous()
              for t in (head_t, delay_t, s_first, s_left, s_right)]
    if (pcm.shape != (L, 2048) or any(t.shape != (L,) for t in lanes)
            or first.shape != (L,) or tables[0].shape != (4, 2, 1024)
            or tables[1].shape != (4, 2, 1024)
            or any(t.shape != (2, 128) for t in tables[2:])):
        raise ValueError("pcm [L, 2048], seqs/shapes/prev_shapes/first [L], "
                         "head/delay [4, 2, 1024], short windows [2, 128]")
    dev = _build.require_cuda(pcm, *lanes, first, *tables)
    if any(t.data_ptr() % 16 for t in (pcm, *tables)):
        raise ValueError("pcm and the window tables must be 16-byte aligned")
    out = torch.empty((L, 1024), dtype=torch.float32, device=dev)
    err = _build.lib().aac_ola_launch(
        pcm.data_ptr(), *(t.data_ptr() for t in lanes), first.data_ptr(),
        *(t.data_ptr() for t in tables), out.data_ptr(), L,
        _build.stream_ptr(dev))
    _build.LAUNCHES["aac_ola"] += 1
    _build.check("aac_ola", err)
    return out


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

# One lane per (frame, channel): the host stage's arrays, as
# :meth:`AacDense.decode_lanes` takes them (``first`` marks sequence starts).
LANE_KEYS = ("coeffs", "qbuf", "scales", "deq", "seq", "shape", "prev_shape")


class AacDense(nn.Module):
    """The AAC dense stage with its constants as buffers: the two IMDCT
    matrices, the pow43 table and the five window/OLA tables. ``sfb_map``
    tensors (one per ``bands_long``, the scale-gather index of the dequant)
    are cached per device."""

    def __init__(self, imdct_long, imdct_short, pow43, ola_head, ola_delay,
                 ola_s_first, ola_s_left, ola_s_right):
        super().__init__()
        self.register_buffer("imdct_long", imdct_long)    # [2048, 1024]
        self.register_buffer("imdct_short", imdct_short)  # [256, 128]
        self.register_buffer("pow43", pow43)              # [8192]
        self.register_buffer("ola_head", ola_head)        # [4, 2, 1024]
        self.register_buffer("ola_delay", ola_delay)      # [4, 2, 1024]
        self.register_buffer("ola_s_first", ola_s_first)  # [2, 128]
        self.register_buffer("ola_s_left", ola_s_left)    # [2, 128]
        self.register_buffer("ola_s_right", ola_s_right)  # [2, 128]
        self._sfb_maps: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def from_numpy(cls, tables: Dict[str, np.ndarray], device) -> "AacDense":
        def t(k):
            return torch.from_numpy(np.ascontiguousarray(
                tables[k], dtype=np.float32))

        return cls(t("imdct_long"), t("imdct_short"), t("pow43"),
                   *(t(k) for k in _OLA_KEYS)).to(torch.device(device))

    def sfb_map(self, bands_long: Sequence[int]) -> torch.Tensor:
        """The reference's ``aac_sfb_map`` [1024] int32 on this module's
        device, built once per ``bands_long``."""
        dev = self.pow43.device
        key = (tuple(int(b) for b in bands_long), str(dev))
        if key not in self._sfb_maps:
            self._sfb_maps[key] = torch.from_numpy(
                aac_sfb_map(np.asarray(key[0]))).to(dev)
        return self._sfb_maps[key]

    def quant(self, qbuf, scales, deq, bands_long) -> Quant:
        return (qbuf, scales, deq, self.sfb_map(bands_long), self.pow43)

    def imdct(self, x, quant: Optional[Quant] = None):
        """x [L, 1024] (long) or [L, 128] (short windows) -> [L, 2n]."""
        m = self.imdct_long if x.shape[1] == 1024 else self.imdct_short
        return aac_imdct(x, m, quant)

    @property
    def ola_tables(self) -> Tuple[torch.Tensor, ...]:
        """(head, delay, s_first, s_left, s_right), A3's table operands."""
        return tuple(getattr(self, k) for k in _OLA_KEYS)

    def ola(self, pcm, seqs, shapes, prev_shapes, first):
        return aac_ola(pcm, seqs, shapes, prev_shapes, first,
                       *self.ola_tables)

    def decode_lanes(self, lanes: Dict[str, np.ndarray], first: np.ndarray,
                     bands_long: Sequence[int],
                     lane_chunk: int = 0) -> np.ndarray:
        """Host lane arrays (:data:`LANE_KEYS`, each over L lanes, and
        ``first [L]``) -> PCM [L, 1024] float32, on this module's device.

        Per chunk of ``lane_chunk`` lanes (0: one chunk): one IMDCT per
        window class, each reading and writing its lanes through one index
        (long lanes first, with the dequant prologue when any of them hands
        off) in one ``[l, 2048]`` device tensor (short frames as their 8 x
        256 windows flattened), then one OLA launch. A chunk starts one lane early, so its first lane's OLA sees
        the previous lane; only the PCM comes back to the host."""
        L = len(first)
        out = np.empty((L, 1024), np.float32)
        step = lane_chunk or max(L, 1)
        for s in range(0, L, step):
            a, e = max(0, s - 1), min(L, s + step)
            pcm = self._decode_span({k: v[a:e] for k, v in lanes.items()},
                                    first[a:e], bands_long)
            out[s:e] = trace.to_host(pcm[s - a:])
        return out

    def _decode_span(self, lanes, first, bands_long) -> torch.Tensor:
        """One chunk's launches; the copies they need go in ``h2d`` spans
        (those of the dequant and the OLA inside the ``enqueue`` span, in
        launch order)."""
        dev = self.pow43.device
        with trace.span("pack"):
            seqs = np.asarray(lanes["seq"])
            is_short = seqs == EIGHT_SHORT
            n_short = int(is_short.sum())
            n_long = len(seqs) - n_short
            order = np.argsort(is_short, kind="stable").astype(np.int32)
            dequant = n_long and not np.all(
                np.asarray(lanes["deq"])[~is_short])
        # One index, long lanes first, and both counts, each on the card in
        # one copy: A1 reads and writes each class's lanes through it.
        rows, counts, coeffs = trace.to_device(
            dev, order, np.array([n_long, n_short], np.int32),
            lanes["coeffs"])
        with trace.span("enqueue"):
            pcm = torch.empty((len(seqs), 2048), dtype=torch.float32,
                              device=dev)
            if n_long:
                quant = None
                if dequant:
                    quant = self.quant(*trace.to_device(
                        dev, *(lanes[k] for k in ("qbuf", "scales", "deq"))),
                        bands_long)
                aac_imdct(coeffs, self.imdct_long, quant, rows=rows,
                          n_rows=counts[0], out=pcm)
            if n_short:
                aac_imdct(coeffs, self.imdct_short, rows=rows[n_long:],
                          n_rows=counts[1], out=pcm)
            return self.ola(pcm, *trace.to_device(
                dev, seqs, lanes["shape"], lanes["prev_shape"], first))


# ---------------------------------------------------------------------------
# Counterparts of the reference's public functions
# ---------------------------------------------------------------------------


def _dense(device) -> AacDense:
    return AacDense.from_numpy(reference_tables(), device)


def dequant_select(coeffs, qbuf, scales, deq, bands_long, *,
                   device) -> np.ndarray:
    """The reference's ``dequant_select``: the entropy stage's split output
    resolved into full coefficients, the handoff lanes dequantized by A2
    (or its twin on ``"cpu"``). Arrays may carry leading lane axes."""
    coeffs = np.asarray(coeffs, np.float32)
    if (np.asarray(deq) != 0).all():
        return coeffs
    lead = coeffs.shape[:-1]
    d = _dense(device)
    dev = d.pow43.device

    def t(a, *shape):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(shape)).to(
            dev)

    out = aac_dequant(t(coeffs, -1, 1024),
                      *d.quant(t(qbuf, -1, 1024), t(scales, -1, 64),
                               t(deq, -1), bands_long))
    return out.cpu().numpy().reshape(lead + (1024,))


def imdct_frames(coeffs: np.ndarray, seqs: Sequence[int], quant=None, *,
                 device) -> List[np.ndarray]:
    """The reference's ``imdct_frames``: per-frame IMDCT outputs, [2048]
    for long-window frames and [8, 256] for EIGHT_SHORT ones. ``quant`` is
    (qbuf [n, 1024], scales [n, 64], deq [n], bands_long), the handoff of
    one channel; its dequantization runs in A1's prologue."""
    d = _dense(device)
    dev = d.pow43.device
    coeffs = np.asarray(coeffs, np.float32)
    seqs = np.asarray(seqs)
    out: List[np.ndarray] = [None] * len(coeffs)
    long_idx = np.flatnonzero(seqs != EIGHT_SHORT)
    short_idx = np.flatnonzero(seqs == EIGHT_SHORT)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if long_idx.size:
        q = None
        if quant is not None and (np.asarray(quant[2])[long_idx] == 0).any():
            qbuf, scales, deq, bands_long = quant
            q = d.quant(t(np.asarray(qbuf)[long_idx]),
                        t(np.asarray(scales)[long_idx]),
                        t(np.asarray(deq)[long_idx]), bands_long)
        y = d.imdct(t(coeffs[long_idx]), q).cpu().numpy()
        for j, i in enumerate(long_idx):
            out[i] = y[j]
    if short_idx.size:
        y = d.imdct(t(coeffs[short_idx].reshape(-1, 128))).cpu().numpy()
        y = y.reshape(-1, 8, 256)
        for j, i in enumerate(short_idx):
            out[i] = y[j]
    return out


def window_ola_batch(pcms: Sequence[np.ndarray], seqs: Sequence[int],
                     shapes: Sequence[bool], prev_shapes: Sequence[bool], *,
                     device) -> np.ndarray:
    """The reference's ``window_ola_batch``: the window/overlap-add over one
    channel's frame sequence, concatenated [n * 1024]."""
    if not len(pcms):
        return np.zeros(0, np.float32)
    d = _dense(device)
    dev = d.pow43.device
    n = len(pcms)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    flat = np.stack([np.asarray(p, np.float32).reshape(-1) for p in pcms])
    first = np.zeros(n, bool)
    first[0] = True
    out = d.ola(t(flat, np.float32), t(seqs, np.int32), t(shapes, np.int32),
                t(prev_shapes, np.int32), t(first, bool))
    return out.cpu().numpy().reshape(-1)
