"""MPEG audio Layer III entropy decode on the card: kernel M0.

M0 ``mp3_entropy`` (``csrc/mp3_entropy.cu``) decodes every Layer III frame
of a batch of clips from the clips' own bytes, one thread a frame, and
writes each granule-channel's 576 spectral values, block type and mixed
flag into the lanes M1 (:func:`ops.mp3_dense.mp3_hybrid`) reads, plus one
status a frame with the native library's codes (``sh_mp3_extract``): 0,
-1 header, -2 side info, -3 no main data, -4 bit reservoir underflow, -5
scalefactors or Huffman data; and -6 where M0 does not take a frame the
host does (another granule count than its clip's, or more channels than
its clip's lanes), so that the caller sends its clip to the host.

Layout (:func:`plan` builds it from the MPEG audio reader's frame tables):

  data     [n]        uint8, the clips' frame bytes, one span a clip
  frames   [F, 2]     int64, each frame's offset in ``data`` and size
  clips    [K, 5]     int64, each clip's first frame, frame count, first
                      output lane, channels C and granules a frame, in
                      frame order; clip k's lanes are granule-major,
                      ``C`` a granule, ``frames x granules x C`` in all
  spectra  [L, 576]   float32, bt [L] int32, mixed [L] bool, status [F]
                      int32

A clip whose statuses are all 0 has, lane for lane, the spectra, block
types and mixed flags that ``native.mp3_extract`` gives for it.

:func:`mp3_entropy` launches M0 for CUDA tensors and runs its plain twin
:func:`mp3_entropy_plain` for CPU tensors: the same frames one after
another through the port's ``codecs/mpa_layer3.py`` (side info,
scalefactors, Huffman, requantisation, stereo, reorder), the reservoir
found as M0 finds it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import _build

# Status where M0 does not take a frame the host does.
NOT_TAKEN = -6

_L1_BITS = 12
_L2_BITS = 7
_N_TABLES = 20  # big-value tables 0-17 as M0 numbers them, count1 A and B
_GAIN_MIN, _GAIN_MAX = -390, 45
_DTYPES = {"huff": torch.int16, "fl": torch.float32, "it": torch.int32}
_SAMPLE_RATES = (44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000,
                 8000)


def _codes():
    """(M0's table number, codes, lengths, values) of every Huffman table."""
    from ..codecs.mpa_common import tables

    t = tables()
    out = []
    for ti, name in [(n, n) for n in (1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                                       15)] + [(16, 16), (17, 24)]:
        codes, bits = t[f"codes_{name}"], t[f"bits_{name}"]
        wrap = {4: 2, 9: 3, 16: 4, 36: 6, 64: 8, 256: 16}[len(codes)]
        out.append((ti, codes, bits, [((i // wrap) << 4) | (i % wrap)
                                      for i in range(len(codes))]))
    for ti, sfx in ((18, "a"), (19, "b")):
        codes = t[f"quads_codes_{sfx}"]
        out.append((ti, codes, t[f"quads_bits_{sfx}"], list(range(len(codes)))))
    return out


def _huffman_tables() -> np.ndarray:
    """uint16: the first level [20, 4096] by the next 12 bits (0 no code,
    0x8000 | k the second-level table k, else length << 8 | value), then
    the second-level tables [., 128] by the 7 bits after them."""
    l1 = np.zeros((_N_TABLES, 1 << _L1_BITS), np.uint16)
    l2: List[np.ndarray] = []
    for ti, codes, bits, values in _codes():
        for code, ln, v in zip(codes, bits, values):
            code, ln = int(code), int(ln)
            if ln == 0:
                continue
            entry = (ln << 8) | v
            if ln <= _L1_BITS:
                base = code << (_L1_BITS - ln)
                l1[ti, base : base + (1 << (_L1_BITS - ln))] = entry
                continue
            rest = ln - _L1_BITS
            if rest > _L2_BITS:
                raise ValueError("a code longer than 19 bits")
            prefix = code >> rest
            if l1[ti, prefix] == 0:
                l1[ti, prefix] = 0x8000 | len(l2)
                l2.append(np.zeros(1 << _L2_BITS, np.uint16))
            sub = l2[int(l1[ti, prefix]) & 0x7FFF]
            base = (code & ((1 << rest) - 1)) << (_L2_BITS - rest)
            sub[base : base + (1 << (_L2_BITS - rest))] = entry
    return np.concatenate([l1.ravel()] + l2)


def _float_tables() -> np.ndarray:
    """float32: |i|^(4/3) for i < 8207, 2^(k/4) for k in [-390, 45], the
    MPEG-1 intensity ratios [7, 2], MPEG-2's [2, 32, 2], 1/sqrt(2); each
    as the native library computes it, one libm call and one rounding to
    float32."""
    pow43 = [math.pow(i, 4.0 / 3.0) for i in range(8207)]
    gain = [math.pow(2.0, 0.25 * k) for k in range(_GAIN_MIN, _GAIN_MAX + 1)]
    is_m1 = []
    for p in range(7):
        r = math.tan(p * math.pi / 12.0)
        is_m1 += [r / (1.0 + r), 1.0 / (1.0 + r)]
    is_m1[12:14] = [1.0, 0.0]
    is_m2 = []
    for s in (1.0 / math.sqrt(math.sqrt(2.0)), 1.0 / math.sqrt(2.0)):
        for p in range(32):
            is_m2 += ([math.pow(s, (p + 1) / 2.0), 1.0] if p & 1
                      else [1.0, math.pow(s, p / 2.0)])
    return np.array(pow43 + gain + is_m1 + is_m2 + [1.0 / math.sqrt(2.0)],
                    np.float32)


def _int_tables() -> np.ndarray:
    """int32: the scalefactor bands (long [9, 23], short [9, 40], mixed
    [9, 40] with their lengths [9] and switch points [9]), slen [16, 2],
    MPEG-2's nsfb [6, 3, 4], linbits [32], the pre-emphasis [22], the
    Layer III bit rates (MPEG-1 [15], MPEG-2/2.5 [15]), the sample rates
    [3, 3]."""
    from ..codecs.mpa_common import tables
    from ..codecs.mpa_layer3 import PRE_EMPHASIS

    t = tables()
    mixed = np.zeros((9, 40), np.int64)
    lens = []
    for r in range(9):
        m = np.asarray(t[f"sfb_mixed_{r}"])
        mixed[r, : len(m)] = m
        lens.append(len(m))
    parts = [t["sfb_long"], t["sfb_short"], mixed, lens,
             t["sfb_mixed_switch"], t["slen"], t["mpeg2_nsfb"], t["linbits"],
             PRE_EMPHASIS, t["bit_rates_mpeg1_l3"], t["bit_rates_mpeg2_l23"],
             _SAMPLE_RATES]
    return np.concatenate([np.asarray(p, np.int64).ravel()
                           for p in parts]).astype(np.int32)


@lru_cache(maxsize=None)
def tables() -> Dict[str, np.ndarray]:
    """M0's three table blocks (the layout ``csrc/mp3_entropy.cu`` names):
    ``huff`` (uint16 bits, held as int16), ``fl`` float32, ``it`` int32."""
    out = {"huff": _huffman_tables().view(np.int16), "fl": _float_tables(),
           "it": _int_tables()}
    for a in out.values():
        a.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def device_tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """:func:`tables` as tensors on ``device``, copied there once (220 KB)
    and shared by every caller; M0 only reads them."""
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in tables().items()}


@dataclass
class Plan:
    """The tables of one M0 launch (see the module docstring), where each
    clip's bytes go in ``data`` (:meth:`pack`), and where its lanes lie:
    clip i (in the caller's order) has lanes ``[lane[i], lane[i] +
    lanes[i])``, ``granules[i]`` granules of ``channels[i]`` lanes, and
    frames ``[first[i], first[i] + count[i])``. Clips of one channel count
    have adjacent lanes, the one-channel clips first."""

    frames: np.ndarray
    clips: np.ndarray
    n_lanes: int
    lane: np.ndarray
    lanes: np.ndarray
    granules: np.ndarray
    channels: np.ndarray
    first: np.ndarray
    count: np.ndarray
    start: np.ndarray  # each clip's span in its own bytes, and in data
    span: np.ndarray
    base: np.ndarray

    def pack(self, bufs: Sequence[bytes]) -> np.ndarray:
        """``data``: each clip's span of ``bufs`` at its place."""
        data = np.empty(int(self.span.sum()), np.uint8)
        for i, buf in enumerate(bufs):
            n = int(self.span[i])
            if n:
                data[self.base[i] : self.base[i] + n] = np.frombuffer(
                    buf, np.uint8, n, int(self.start[i]))
        return data

    def clean(self, status: np.ndarray) -> np.ndarray:
        """bool [K]: the clips (caller's order) whose every frame's status
        is 0, from M0's ``status`` [F]."""
        bad = np.concatenate([[0], np.cumsum(np.asarray(status) != 0)])
        return bad[self.first + self.count] == bad[self.first]


def plan(offsets: Sequence[np.ndarray], sizes: Sequence[np.ndarray],
         channels: Sequence[int], granules_per_frame: Sequence[int]) -> Plan:
    """M0's tables for clips given as the MPEG audio reader holds them:
    each clip's frame offsets and sizes in its bytes, its channel count
    and granules a frame. Each clip contributes the span of its bytes
    from its first frame to the end of its last; the frame table is built
    without a loop over frames."""
    K = len(offsets)
    channels = np.asarray(channels, np.int64).reshape(K)
    gpf = np.asarray(granules_per_frame, np.int64).reshape(K)
    order = np.argsort(channels, kind="stable")
    count = np.array([len(o) for o in offsets], np.int64)
    start = np.array([int(o[0]) if len(o) else 0 for o in offsets], np.int64)
    end = np.array([int(o[-1]) + int(s[-1]) if len(o) else 0
                    for o, s in zip(offsets, sizes)], np.int64)
    span = end - start
    granules = count * gpf
    lanes = granules * channels

    def placed(x):
        out = np.zeros(K, np.int64)
        out[order] = np.cumsum(x[order]) - x[order]
        return out

    first, lane, base = placed(count), placed(lanes), placed(span)
    F = int(count.sum())
    frames = np.empty((F, 2), np.int64)
    if F:
        clip = np.repeat(np.arange(K), count)
        # frame j of the callers' order: clip's first + its index there
        row = first[clip] + np.arange(F) - np.repeat(np.cumsum(count) - count,
                                                     count)
        frames[row, 0] = (np.concatenate(offsets).astype(np.int64)
                          - start[clip] + base[clip])
        frames[row, 1] = np.concatenate(sizes)
    clips = np.ascontiguousarray(
        np.stack([first, count, lane, channels, gpf], axis=1)[order])
    return Plan(frames, clips, int(lanes.sum()), lane, lanes, granules,
                channels, first, count, start, span, base)


def mp3_entropy(data: torch.Tensor, frames: torch.Tensor,
                clips: torch.Tensor, tabs: Dict[str, torch.Tensor],
                n_lanes: int):
    """M0: (spectra [L, 576] float32, bt [L] int32, mixed [L] bool,
    status [F] int32) for the frames and clips of :func:`plan`, on
    ``frames``' device; ``tabs`` from :func:`device_tables`. A lane of a
    frame whose status is not 0 holds no value."""
    F = frames.shape[0] if frames.dim() == 2 else -1
    if (data.dim() != 1 or data.dtype != torch.uint8
            or frames.shape != (F, 2) or frames.dtype != torch.int64
            or clips.dim() != 2 or clips.shape[1] != 5
            or clips.dtype != torch.int64 or n_lanes < 0
            or (F > 0 and clips.shape[0] == 0)):
        raise ValueError("data uint8 [n], frames int64 [F, 2], clips int64 "
                         "[K, 5] (K > 0 where F > 0), n_lanes >= 0")
    for k, v in tables().items():
        if (k not in tabs or tabs[k].shape != v.shape
                or tabs[k].dtype != _DTYPES[k]):
            raise ValueError(f"tables: {k} must be {_DTYPES[k]} {v.shape}")
    dev = frames.device
    if _build.device_type(frames) == "cpu":
        if any(x.device != dev for x in (data, clips)):
            raise ValueError("M0's tensors on different devices")
        return mp3_entropy_plain(data, frames, clips, n_lanes)
    _build.require_cuda(data, frames, clips, *tabs.values())
    spectra = torch.empty((n_lanes, 576), dtype=torch.float32, device=dev)
    bt = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    mixed = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    status = torch.empty(F, dtype=torch.int32, device=dev)
    if F == 0:
        return spectra, bt, mixed, status
    if data.numel() == 0 or data.data_ptr() % 4:
        raise ValueError("data must be non-empty and 4-byte aligned")
    err = _build.lib().mp3_entropy_launch(
        data.data_ptr(), data.numel(), frames.data_ptr(), F,
        clips.data_ptr(), clips.shape[0], tabs["huff"].data_ptr(),
        tabs["fl"].data_ptr(), tabs["it"].data_ptr(), spectra.data_ptr(),
        n_lanes, bt.data_ptr(), mixed.data_ptr(), status.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["mp3_entropy"] += 1
    _build.check("mp3_entropy", err)
    return spectra, bt, mixed, status


# ---------------------------------------------------------------------------
# Plain twin: the port's Python Layer III functions, frame by frame
# ---------------------------------------------------------------------------


def _frame_header(buf: bytes, off: int, size: int):
    """(header, main data offset, main data length) of a frame whose
    header and side info parse, with its side info; or the status."""
    from ..codecs import mpa_layer3 as l3
    from ..codecs.mpa_common import LAYER3, parse_header
    from ..core.errors import DecodeError
    from ..core.io.bits import BitReaderLtr

    if off < 0 or size < 4 or off + size > len(buf):
        return -1
    try:
        h = parse_header(int.from_bytes(buf[off : off + 4], "big"))
    except DecodeError:
        return -1
    if h.layer != LAYER3 or h.frame_size > size:
        return -1
    pos = 4 + (2 if h.has_crc else 0)
    side = h.side_info_len()
    try:
        fd = l3.read_side_info(BitReaderLtr(buf[off + pos : off + pos + side]),
                               h)
    except DecodeError:
        return -2
    md_len = h.frame_size - pos - side
    if md_len < 0:
        return -3
    return h, fd, off + pos + side, md_len


def _plain_frame(buf: bytes, fr: np.ndarray, f: int, first: int, C: int,
                 gpf: int, rows: np.ndarray, spectra, bt, mixed) -> int:
    from ..codecs import mpa_layer3 as l3
    from ..core.errors import DecodeError, EndOfStream
    from ..core.io.bits import BitReaderLtr

    got = _frame_header(buf, int(fr[f, 0]), int(fr[f, 1]))
    if isinstance(got, int):
        return got
    h, fd, md, md_len = got
    need = fd.main_data_begin
    parts, acc, j = [], 0, f - 1
    while acc < need:
        if j < first:
            return -4
        prev = _frame_header(buf, int(fr[j, 0]), int(fr[j, 1]))
        if not isinstance(prev, int):
            parts.append(buf[prev[2] : prev[2] + prev[3]])
            acc += prev[3]
        j -= 1
    reservoir = b"".join(reversed(parts))
    main = reservoir[len(reservoir) - need :] + buf[md : md + md_len]
    n_gr, n_ch = l3.NGRANULES[h.is_mpeg1], h.n_channels
    if n_gr != gpf or n_ch > C:
        return NOT_TAKEN
    br = BitReaderLtr(main)
    out = []
    try:
        for gr in range(n_gr):
            spec = [np.zeros(576, np.float32) for _ in range(2)]
            for ch in range(n_ch):
                c = fd.granules[gr][ch]
                if h.is_mpeg1:
                    part2 = l3.read_scale_factors_mpeg1(br, gr, ch, fd)
                else:
                    part2 = l3.read_scale_factors_mpeg2(
                        br, ch == 1 and h.is_intensity_stereo, c)
                part3 = c.part2_3_length - part2
                if part3 < 0:
                    return -5
                spec[ch] = l3.read_huffman_samples(br, c, part3)
                l3.requantize(h, c, spec[ch])
            if n_ch == 2:
                l3.stereo(h, fd.granules[gr], spec[0], spec[1])
            for ch in range(n_ch):
                l3.reorder(h, fd.granules[gr][ch], spec[ch])
            out.append(spec)
    except (DecodeError, EndOfStream, ValueError):
        return -5
    for gr, spec in enumerate(out):
        for ch in range(C):
            lane = rows + gr * C + ch
            spectra[lane] = spec[ch]
            if ch < n_ch:
                bt[lane] = fd.granules[gr][ch].block_type
                mixed[lane] = fd.granules[gr][ch].mixed
    return 0


def mp3_entropy_plain(data: torch.Tensor, frames: torch.Tensor,
                      clips: torch.Tensor, n_lanes: int):
    """M0's plain twin on CPU tensors; the same outputs (a lane of a frame
    whose status is not 0 holds zeros)."""
    buf = data.numpy().tobytes()
    fr = frames.numpy()
    spectra = np.zeros((n_lanes, 576), np.float32)
    bt = np.zeros(n_lanes, np.int32)
    mixed = np.zeros(n_lanes, bool)
    status = np.full(fr.shape[0], NOT_TAKEN, np.int32)
    for first, count, lane0, C, gpf in clips.numpy().tolist():
        for f in range(first, first + count):
            rows = lane0 + (f - first) * gpf * C
            if C > 2 or lane0 < 0 or rows + gpf * C > n_lanes:
                continue
            status[f] = _plain_frame(buf, fr, f, first, C, gpf, rows,
                                     spectra, bt, mixed)
    return (torch.from_numpy(spectra), torch.from_numpy(bt),
            torch.from_numpy(mixed), torch.from_numpy(status))
