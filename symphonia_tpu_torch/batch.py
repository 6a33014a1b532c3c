"""Batch decode sessions on PyTorch: files -> PCM through the port's kernels.

Port of ``symphonia_tpu/batch.py``. The host stage (probe, demuxers, native
C++ entropy extraction, the per-packet codecs) is the port's own copy of
the reference's. FLAC, MPEG audio (Layers I, II and III), AAC-LC and Ogg
Vorbis take their batch decoders, whose dense stage runs on ``device``:
the hand-written CUDA kernels on ``"cuda"`` (the default of every entry
point), their plain PyTorch twins on ``"cpu"``. A call without a device
runs on the card or raises when there is none; nothing falls back to the
CPU on its own.

One path: :func:`decode_many` probes each stream once and hands the probed
reader to its route's batch decoder (``_decode_opened``), so no stream is
opened twice; :func:`decode_bytes` is ``decode_many`` of one. A batch
decoder called directly opens its streams itself (``_open``) and then
takes the same path; its ``decode_bytes`` is its ``decode_many`` of one.

Every other stream (PCM in WAV, AIFF, CAF or MP4, ADPCM, ALAC, and codecs
in foreign containers such as FLAC in Matroska) takes the reference's own
per-packet loop (:func:`_packet_decode`, ``symphonia_tpu/batch.py:715-743``)
through the registry's decoder on the host, as in the reference; each such
stream adds one to ``packet_routes``. Only the cases where the reference
itself leaves the device for a batch codec take the host route
(:func:`_host_decode`): FLAC above 25 bits per sample, a malformed MPEG
audio stream, no native library for MPEG audio. Each use adds one to
``host_routes``.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import trace
from .core.errors import DecodeError, Unsupported
from .core.io import MediaSourceStream

from .ops import flac_dense
from .ops.aac_dense import LANE_KEYS, AacDense
from .ops.aac_dense import reference_tables as aac_tables
from .ops import mp3_dense
from .ops.mp3_dense import (BLOCK_SHORT, L12Dense, Mp3Dense, l12_tables,
                             reference_tables)
from .ops.vorbis_dense import VorbisDense, decode_packets_dense_multi

logger = logging.getLogger("symphonia_tpu_torch.batch")

# Decodes that took the exact host route, and streams that took the
# per-packet loop (see module docstring).
host_routes = 0
packet_routes = 0


def resolve_device(device) -> torch.device:
    """The device, checked: CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class DecodedAudio:
    """Bulk decode result: planar int32/float32 [channels, samples]."""

    samples: np.ndarray
    sample_rate: int
    bits_per_sample: int
    md5_ok: Optional[bool] = None


_NO_MD5 = b"\x00" * 16

# Where a merged FLAC group's MD5 is computed: on the card (F3, one chain
# a stream, all streams at once) where hashing its streams one after
# another on the host would take longer than the card's longest chain,
# that is where sum(bytes) > MD5_HOST_PER_CHAIN * max(bytes). The ratio is
# the host's rate over the whole MD5 path (_flac_md5_ok) over one F3
# chain's rate, both measured by chip_smoke.py's phase 11: 352-408 MB/s
# over the FLAC bulk cell's 128 streams against 98.8-99.0 MB/s, 3.6-4.1
# (an H100 80GB HBM3 and its host; PERF.md). A group that spans lane
# chunks spreads each stream over them in proportion (_chunk_runs), so its
# chain is max(bytes) there too, give or take a frame a chunk; the host
# hashes stereo (and 3-byte) samples slower still: phase 16, at the
# musdb_flac.tracks8 request (8 stereo tracks, 402 MB hashed over six
# chunks, the longest track 75.9 MB), took 2.54-2.72 s a request with F3
# and 5.02-5.10 s with the host's MD5 (PERF.md).
MD5_HOST_PER_CHAIN = 4.0


def _md5_on_card(nbytes: Sequence[int]) -> bool:
    return bool(nbytes) and sum(nbytes) > MD5_HOST_PER_CHAIN * max(nbytes)


def _chunk_runs(frames: Sequence[int], per_chunk: int) -> np.ndarray:
    """int64 [S, chunks]: how many of each stream's frames each lane chunk
    of a merged group holds, the chunks cut every ``per_chunk`` frames as
    ever (the last holds the rest). Each stream is spread over the chunks
    in proportion to its frames: stream s holds F_s x size / F of a
    chunk's ``size`` frames, rounded down or up, so that F3's chain in
    each chunk is one stream's share and not a whole stream. Of the
    frames a stream holds in the full chunks beyond its floor, their share
    is rounded (largest remainders first), and they are dealt out in
    stream order, chunk after chunk; the last chunk holds the rest. One
    chunk holds every stream whole, and one stream fills the chunks in
    turn: the cut of the plain concatenation."""
    F = np.asarray(frames, np.int64)
    total = int(F.sum())
    full = max(0, -(-total // per_chunk) - 1)
    if full == 0:
        return F[:, None].copy()
    # Frames a full chunk holds of each stream: q, or q + 1 (the
    # "extra" ones, k to a chunk, as the remainders add up).
    q, rem = np.divmod(F * per_chunk, total)
    extra, part = np.divmod(full * rem, total)
    need = full * (per_chunk - int(q.sum())) - int(extra.sum())
    extra[np.argsort(-part, kind="stable")[:need]] += 1
    runs = np.repeat(q[:, None], full + 1, axis=1)
    dealt = np.arange(int(extra.sum())) % full
    np.add.at(runs, (np.repeat(np.arange(len(F)), extra), dealt), 1)
    runs[:, -1] = F - runs[:, :-1].sum(1)
    return runs


def _flac_md5_ok(samples: np.ndarray, si) -> Optional[bool]:
    """STREAMINFO MD5 verification; None when the stream carries no MD5
    (the all-zero sentinel)."""
    with trace.span("verify"):
        if si.md5 == b"\x00" * 16:
            return None
        from .codecs.flac import md5_bytes_of

        return hashlib.md5(
            md5_bytes_of(samples.astype(np.int64), si.bits_per_sample)
        ).digest() == si.md5


def _verify_host(samples: np.ndarray, si) -> Optional[bool]:
    """:func:`_flac_md5_ok`, each stream it verifies counted as
    ``md5_host_streams``."""
    if si.md5 != _NO_MD5:
        trace.count("md5_host_streams", 1)
    return _flac_md5_ok(samples, si)


def _trim_bounds(total: int, track, gapless: bool) -> Tuple[int, int]:
    """The samples ``[start, end)`` of ``total`` that the gapless trim
    keeps: the encoder delay and padding (both >= 0) cut, nothing without
    ``gapless``."""
    if not gapless:
        return 0, total
    start = min(track.delay, total)
    return start, max(start, total - track.padding)


def _gapless_trim(pcm: np.ndarray, track, gapless: bool) -> np.ndarray:
    if not gapless:
        return pcm
    start, end = _trim_bounds(pcm.shape[1], track, gapless)
    return pcm[:, start:end]


def _copy_pooled(d: dict) -> dict:
    """The native extraction returns POOLED buffers that the next file's
    extraction reuses: copy before queueing."""
    return {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


class _BatchDecoder:
    """The one path of the four batch decoders: :meth:`decode_many` opens
    each stream (the decoder's ``_open``, in span ``open``) and hands the
    streams and their readers to the decoder's ``_decode_opened``, which
    the facade calls with the probe's readers (the bytes serve a stream's
    host route); ``decode_bytes`` is ``decode_many`` of one."""

    def decode_bytes(self, data: bytes) -> DecodedAudio:
        return self.decode_many([data])[0]

    def decode_file(self, path: str) -> DecodedAudio:
        with open(path, "rb") as f:
            return self.decode_bytes(f.read())

    def decode_many(self, datas: Sequence[bytes]) -> List[DecodedAudio]:
        readers = []
        for data in datas:
            with trace.span("open"):
                readers.append(self._open(MediaSourceStream(data)))
        return self._decode_opened(datas, readers)


class FlacBatchDecoder(_BatchDecoder):
    """Whole-file(s) FLAC decode through the batched dense stage: each
    opened stream's frames extracted natively, the frame lanes of every
    stream with one channel count decoded in merged lane chunks (F1, F2)
    and verified (F3 or the host); a stream the native extraction does not
    take decodes from its parsed frames, one above 25 bits on the host.

    ``lane_chunk`` bounds how many subframe lanes go to the device per
    dispatch (memory bound); any lane count is a valid kernel shape."""

    def __init__(self, *, device="cuda", lane_chunk: int = 8192,
                 verify: bool = False):
        self.device = resolve_device(device)
        self.lane_chunk = lane_chunk
        self.verify = verify

    def _extract_host(self, reader):
        """Host stage for one stream: (packed | None, blocks | None).

        ``packed`` is the native-extracted lane tensor dict; None means the
        caller takes the robust per-frame parse (native unavailable,
        malformed frames, desynced fast scan)."""
        from . import native

        si = reader.stream_info
        packed = None
        blocks = None
        total = reader.mss.byte_len()
        if native.available() and si.block_len_max and total is not None:
            mss = reader.mss
            mss.seek(reader._data_start)
            buf = mss.read_bytes(int(total - reader._data_start))
            max_frames = (
                si.n_samples // max(1, si.block_len_min) + 8
                if si.n_samples else len(buf) // 64 + 16
            )
            max_frames = min(max_frames, len(buf) // 10 + 16)
            packed = native.flac_fast_extract(buf, si, si.block_len_max,
                                              max_frames)
            if packed is not None and (packed["status"] != 0).any():
                packed = None
            if packed is not None:
                if si.n_samples:
                    if int(packed["block"].sum()) < si.n_samples:
                        packed = None
                elif packed["F"] > 0:
                    tail = len(buf) - int(packed["offsets"][-1])
                    if tail > max(4096, 8 * len(buf) // packed["F"]):
                        packed = None
            if packed is not None:
                blocks = packed["block"].astype(np.int64)

        if packed is None:
            reader._ensure_scan()
            starts = reader._frame_starts
            if len(starts) == 0:
                return None, None
            buf = reader._buf
            ends = np.empty(len(starts), dtype=np.int64)
            ends[:-1] = starts[1:]
            ends[-1] = len(buf)
            n_max = si.block_len_max or int(reader._frame_dur.max())
            if native.available():
                packed = native.flac_extract(buf, starts, ends - starts, si,
                                             n_max)
                if packed is not None and (packed["status"] != 0).any():
                    packed = None  # malformed frames: robust path
            blocks = reader._frame_dur.astype(np.int64)
        return packed, blocks

    def _decode_parsed(self, reader) -> DecodedAudio:
        """The robust path of one stream whose frames the native extraction
        did not take: each frame parsed on the host, then packed and
        decoded in lane chunks."""
        from .codecs.flac import parse_frame

        si = reader.stream_info
        frames = []
        with trace.span("extract"):
            for p in reader.packet_table().data:
                try:
                    frames.append(parse_frame(p, si))
                except DecodeError:
                    # Corrupt frame: skip the packet, as the reference
                    # decode loop does.
                    logger.warning("flac: skipping corrupt frame")
        if not frames:
            return DecodedAudio(np.zeros((si.channels, 0), np.int32),
                                si.sample_rate, si.bits_per_sample)
        C = max(f.header.n_channels for f in frames)
        frames_per_chunk = max(1, self.lane_chunk // C)
        n_max = max(si.block_len_max,
                    max(f.header.block_size for f in frames))
        outs = []
        for i in range(0, len(frames), frames_per_chunk):
            chunk = frames[i : i + frames_per_chunk]
            with trace.span("pack"):
                pk = flac_dense.pack_parsed_frames(chunk, n_max=n_max)
            out = flac_dense.decode_packed(pk, self.device)
            with trace.span("stitch"):
                for j, f in enumerate(chunk):
                    outs.append(out[j, : f.header.n_channels,
                                    : f.header.block_size])
        with trace.span("stitch"):
            pcm = np.concatenate(outs, axis=1)
        if si.n_samples:
            pcm = pcm[:, : si.n_samples]
        md5_ok = _verify_host(pcm, si) if self.verify else None
        return DecodedAudio(pcm, si.sample_rate, si.bits_per_sample, md5_ok)

    def _decode_packed_chunked(self, packed, take: np.ndarray,
                               owner: np.ndarray, streams: int,
                               md5=None) -> List[np.ndarray]:
        """Dense stage over native-packed tensors in lane chunks, then
        stitch the per-frame outputs: each merged frame's first ``take``
        samples to its stream ``owner`` (of ``streams``) -> each stream's
        int32 [C, n], in an array of its own. ``md5`` (a
        ``flac_dense.LaneMd5``) hashes each chunk's output on the
        device."""
        F, C, n_max = int(packed["F"]), int(packed["C"]), int(packed["n_max"])
        frames_per_chunk = max(1, self.lane_chunk // C)
        outs = [[] for _ in range(streams)]
        for i in range(0, F, frames_per_chunk):
            j = min(F, i + frames_per_chunk)
            with trace.span("pack"):
                sub = {k: np.asarray(packed[k]).reshape(F, C, -1)[i:j]
                       .reshape((j - i) * C, -1) for k in ("res", "coefs")}
                sub.update({k: np.asarray(packed[k]).reshape(F, C)[i:j]
                            .reshape(-1)
                            for k in ("order", "shift", "wasted")})
                sub.update(assign=np.asarray(packed["assign"])[i:j],
                           F=j - i, C=C, n_max=n_max)
                if md5 is not None:
                    sub["md5_table"] = md5.table(i, j)
            out = flac_dense.decode_packed(sub, self.device, md5)
            with trace.span("stitch"):
                for k, (s, n) in enumerate(zip(owner[i:j].tolist(),
                                               take[i:j].tolist())):
                    outs[s].append(out[k, :, :n])
        with trace.span("stitch"):
            return [np.concatenate(o, axis=1) if o
                    else np.zeros((C, 0), np.int32) for o in outs]

    @staticmethod
    def _open(mss):
        from .formats.flac import FlacReader

        return FlacReader(mss)

    def decode_files(self, paths: Sequence[str]) -> List[DecodedAudio]:
        datas = []
        for p in paths:
            with open(p, "rb") as f:
                datas.append(f.read())
        return self.decode_many(datas)

    def _decode_opened(self, datas: Sequence[bytes],
                       readers) -> List[DecodedAudio]:
        """Decode FLAC streams already opened (``readers``, one a stream)
        through MERGED device dispatches: the frame lanes of every stream
        with the same channel count share the lane chunks; per-file outputs
        are unchanged. A stream above 25 bits takes the host route, and one
        whose frames the native extraction does not take its parsed-frames
        path (:meth:`_decode_parsed`), in the callers' order, before the
        merged groups."""
        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        jobs = []  # (result idx, stream_info, packed, blocks)
        for i, (data, reader) in enumerate(zip(datas, readers)):
            si = reader.stream_info
            if si.bits_per_sample > 25:
                # 32-bit streams carry 33-bit side channels, beyond the
                # int32 lanes; the reference decodes them on the host,
                # exactly.
                results[i] = _host_decode(data, gapless=True)
                if self.verify:
                    results[i].md5_ok = _verify_host(results[i].samples, si)
                continue
            with trace.span("extract"):
                packed, blocks = self._extract_host(reader)
            if packed is None:
                results[i] = self._decode_parsed(reader)
                continue
            with trace.span("pack"):
                jobs.append((i, si, _copy_pooled(packed),
                             np.array(blocks, copy=True)))
        by_c = {}
        for job in jobs:
            by_c.setdefault(int(job[2]["C"]), []).append(job)
        for C, group in by_c.items():
            self._dispatch_merged(C, group, results)
        return results

    def _dispatch_merged(self, C: int, group, results) -> None:
        """One merged dense pass over every stream with channel count C,
        each stream spread over the lane chunks by :func:`_chunk_runs`,
        then split, trim and verify per stream: on the card (F3) where
        :func:`_md5_on_card` says so for the streams that carry an MD5,
        else on the host."""
        with trace.span("pack"):
            n_max = max(int(p["n_max"]) for _, _, p, _ in group)
            per_chunk = max(1, self.lane_chunk // C)
            runs = _chunk_runs([int(p["F"]) for _, _, p, _ in group],
                               per_chunk)
            # Each run's first frame, in its stream and in the merged order.
            start = np.cumsum(runs, axis=1) - runs
            first = (np.arange(runs.shape[1]) * per_chunk
                     + np.cumsum(runs, axis=0) - runs)
            streams, spans = [], []
            for s, (idx, si, p, blocks) in enumerate(group):
                F = int(p["F"])
                res = np.asarray(p["res"]).reshape(F, C, int(p["n_max"]))
                if int(p["n_max"]) != n_max:
                    res = np.pad(res, ((0, 0), (0, 0),
                                       (0, n_max - int(p["n_max"]))))
                blocks = np.asarray(blocks)
                n = int(blocks.sum())
                keep = min(n, si.n_samples) if si.n_samples else n
                # Each frame's samples that the trim keeps.
                done = np.cumsum(blocks) - blocks
                streams.append(dict(
                    res=res, coefs=np.asarray(p["coefs"]).reshape(F, C, 32),
                    assign=np.asarray(p["assign"])[:F], blocks=blocks,
                    take=np.clip(keep - done, 0, blocks),
                    **{k: np.asarray(p[k]).reshape(F, C)
                       for k in ("order", "shift", "wasted")}))
                spans.append((idx, si, n, first[s], runs[s]))
            parts = {k: [] for k in streams[0]}
            for c in range(runs.shape[1]):
                for s, d in enumerate(streams):
                    a, b = start[s, c], start[s, c] + runs[s, c]
                    for k, v in d.items():
                        parts[k].append(v[a:b])
            merged = {k: np.concatenate(v) for k, v in parts.items()}
            blocks_all, take = merged.pop("blocks"), merged.pop("take")
            for k in ("res", "coefs"):
                merged[k] = merged[k].reshape(-1, merged[k].shape[2])
            for k in ("order", "shift", "wasted"):
                merged[k] = merged[k].reshape(-1)
            merged.update(F=len(blocks_all), C=C, n_max=n_max)
            owner = np.repeat(np.tile(np.arange(len(group)), runs.shape[1]),
                              runs.T.reshape(-1))
            md5, on_card = self._card_md5(C, spans, blocks_all)
        pcms = self._decode_packed_chunked(merged, take, owner, len(group),
                                           md5)
        with trace.span("stitch"):
            for k, ((idx, si, *_), pcm) in enumerate(zip(spans, pcms)):
                md5_ok = (_verify_host(pcm, si)
                          if self.verify and k not in on_card else None)
                results[idx] = DecodedAudio(pcm, si.sample_rate,
                                            si.bits_per_sample, md5_ok)
        if md5 is not None:
            with trace.span("verify"):
                for k, digest in zip(on_card, md5.digests()):
                    out = results[spans[k][0]]
                    out.md5_ok = digest == spans[k][1].md5
                trace.count("md5_card_streams", len(on_card))

    def _card_md5(self, C: int, spans, blocks_all):
        """(``flac_dense.LaneMd5`` | None, the indices into ``spans`` of
        the streams it hashes): the streams with an MD5 and a frame, when
        the group verifies and :func:`_md5_on_card` takes their bytes. A
        span is (result index, STREAMINFO, samples, first, frames): the
        stream's frames lie in runs of ``frames`` frames from ``first`` in
        the merged order (one a lane chunk, or one run)."""
        if not self.verify:
            return None, []
        ks, n_hash, width = [], [], []
        for k, (_, si, n, _, frames) in enumerate(spans):
            if si.md5 != _NO_MD5 and np.sum(frames) > 0:
                ks.append(k)
                n_hash.append(min(n, si.n_samples) if si.n_samples else n)
                width.append((si.bits_per_sample + 7) // 8)
        if not _md5_on_card([h * C * w for h, w in zip(n_hash, width)]):
            return None, []
        md5 = flac_dense.LaneMd5([spans[k][3] for k in ks],
                                 [spans[k][4] for k in ks], n_hash, width,
                                 blocks_all, self.device)
        return md5, ks


def _joined(parts: List[torch.Tensor]) -> torch.Tensor:
    """``parts`` (views of one buffer) as one tensor along dim 0: a view
    where each starts where the one before ends, else a copy."""
    a = parts[0]
    if all(y.data_ptr() == x.data_ptr() + x.nbytes
           for x, y in zip(parts, parts[1:])):
        n = sum(p.shape[0] for p in parts)
        return a.as_strided((n,) + tuple(a.shape[1:]), a.stride())
    return torch.cat(parts)


class Mp3BatchDecoder(_BatchDecoder):
    """Whole-file MPEG audio decode from opened ``MpaReader``s. Layer III:
    the entropy stage, on the card (M0, :mod:`ops.mp3_entropy`, all clips
    of a call in one launch) where the device is CUDA and the native C++
    one otherwise or for a clip M0 rejects, then the granule-parallel
    dense stage (:class:`ops.mp3_dense.Mp3Dense`) over the merged clips in
    chained chunks of ``granule_chunk`` granules (a memory bound), each
    chunk's PCM laid out on the device as the clips' trimmed planar
    arrays (M3, ``mp3_place``), which come down one a clip. Layers
    I and II, one stream at a time: the native per-frame bitstream stage,
    then the frame-parallel polyphase stage
    (:class:`ops.mp3_dense.L12Dense`) in chained chunks of
    ``granule_chunk`` frames."""

    def __init__(self, *, device="cuda", granule_chunk: int = 4096,
                 gapless: bool = True):
        self.device = resolve_device(device)
        self.granule_chunk = granule_chunk
        self.gapless = gapless
        self._dense: Optional[Mp3Dense] = None
        self._l12: Optional[L12Dense] = None

    @property
    def dense(self) -> Mp3Dense:
        """Layer III's constant operators, built and uploaded at first use
        (span ``tables``)."""
        if self._dense is None:
            with trace.span("tables"):
                self._dense = Mp3Dense.from_numpy(reference_tables(),
                                                  self.device)
        return self._dense

    @property
    def l12(self) -> L12Dense:
        """Layer I/II's, as :attr:`dense`."""
        if self._l12 is None:
            with trace.span("tables"):
                self._l12 = L12Dense.from_numpy(l12_tables(), self.device)
        return self._l12

    @staticmethod
    def _extract(reader):
        """Native Layer III extraction, copied out of the pooled buffers:
        (spectra [G, C, 576], bt [G, C], mixed [G, C]) or None when the
        stream is malformed. The frames extracted are counted as
        ``mp3_frames``, the clip as ``mp3_host_streams``."""
        from . import native

        ext = native.mp3_extract(reader._buf, reader._offsets, reader._sizes,
                                 max_granules=2 * len(reader._offsets) + 2)
        if ext is None or (ext["status"] != 0).any():
            return None
        C = reader.header.n_channels
        G = ext["n_granules"]
        trace.count("mp3_frames", len(reader._offsets))
        trace.count("mp3_host_streams", 1)
        return (np.array(ext["spectra"][:G, :C], copy=True),
                np.array(ext["bt"][:G, :C], copy=True),
                np.array(ext["mixed"][:G, :C], copy=True).astype(bool))

    def _card_entropy(self, readers) -> list:
        """M0 over the Layer III clips ``readers``, one launch: for each
        clip, (spectra [G, C, 576], bt [G, C], mixed [G, C]) on the card,
        or None where a frame's status is not 0 (the clip then takes the
        host's extraction). Clips of one channel count lie in adjacent
        lanes in the callers' order, so their views are adjacent too.
        Counted: ``mp3_card_streams``, and ``mp3_frames``; the frame
        bytes M0 read and the lanes it wrote as ``mp3_card_bytes`` and
        ``mp3_card_lanes``."""
        from .ops import mp3_entropy

        if not readers:
            return []
        with trace.span("extract"):
            plan = mp3_entropy.plan(
                [r._offsets for r in readers], [r._sizes for r in readers],
                [r.header.n_channels for r in readers],
                [2 if r.header.is_mpeg1 else 1 for r in readers])
        with trace.span("pack"):
            data = plan.pack([r._buf for r in readers])
        tensors = trace.to_device(self.device, data, plan.frames, plan.clips)
        with trace.span("enqueue"):
            spectra, bt, mixed, status = mp3_entropy.mp3_entropy(
                *tensors, mp3_entropy.device_tables(self.device),
                plan.n_lanes)
        status = trace.to_host(status)
        with trace.span("extract"):
            clean = plan.clean(status)
            if trace.enabled():
                trace.count("mp3_card_streams", int(clean.sum()))
                trace.count("mp3_frames", int(plan.count[clean].sum()))
                trace.count("mp3_card_bytes", int(plan.frames[:, 1].sum()))
                trace.count("mp3_card_lanes", plan.n_lanes)
            out = []
            for i, ok in enumerate(clean.tolist()):
                if not ok:
                    out.append(None)
                    continue
                lo, hi, C = (int(plan.lane[i]),
                             int(plan.lane[i] + plan.lanes[i]),
                             int(plan.channels[i]))
                out.append((spectra[lo:hi].view(-1, C, 576),
                            bt[lo:hi].view(-1, C), mixed[lo:hi].view(-1, C)))
        return out

    def _decode_layer3(self, group) -> List[np.ndarray]:
        """Layer III clips of one channel count C (``group``: (reader,
        spectra [G_i, C, 576], bt [G_i, C], mixed [G_i, C]) a clip, host
        arrays or views of M0's output on the card) -> each clip's planar
        PCM [C, N_i], trimmed by :func:`_trim_bounds`, in an array of its
        own. The clips' granule lanes share the dense stage's chained
        chunks of ``granule_chunk`` granules, the carried state kept on
        the device; a per-granule boundary mask breaks the hybrid and
        polyphase chains at each clip's first granule, so merged output
        equals per-clip output. After each chunk's M2, M3 (``mp3_place``)
        lays the chunk's PCM into one buffer on the device, each clip as
        [C, N_i] (:func:`ops.mp3_dense.place_table`); then each clip's
        slice comes down on its own. Counted: the lanes (granule x
        channel) as ``mp3_lanes``, the short-block ones as
        ``mp3_short_lanes``; the clips M3 laid out as
        ``mp3_placed_streams``, the bytes it wrote as
        ``mp3_placed_bytes``."""
        C = int(group[0][1].shape[1])
        dev = self.device
        on_device = isinstance(group[0][1], torch.Tensor)
        with trace.span("pack"):
            join = _joined if on_device else np.concatenate
            spectra, bt, mixed = [join([g[k] for g in group])
                                  for k in (1, 2, 3)]
            counts = np.array([g[1].shape[0] for g in group], np.int64)
            boundary = np.zeros(spectra.shape[0], bool)
            starts = np.cumsum(counts) - counts
            boundary[starts[counts > 0]] = True
            table, size = mp3_dense.place_table(counts, [
                _trim_bounds(576 * int(n), g[0].default_track(), self.gapless)
                for g, n in zip(group, counts)], C)
        G = spectra.shape[0]
        if trace.enabled():
            trace.count("mp3_lanes", G * C)
            trace.count("mp3_short_lanes", int((bt == BLOCK_SHORT).sum()))
        # The table goes up with the group's boundary mask; the twin reads
        # it where numpy built it.
        cpu = dev.type == "cpu"
        bd_all, *tab = trace.to_device(dev, boundary,
                                       *([] if cpu else [table]))
        tab = torch.from_numpy(table) if cpu else tab[0]
        out = torch.empty(size, dtype=torch.float32, device=dev)
        ht = st = None
        for i in range(0, G, self.granule_chunk):
            j = min(G, i + self.granule_chunk)
            x, b, m = (spectra[i:j], bt[i:j], mixed[i:j]) if on_device else \
                trace.to_device(dev, spectra[i:j], bt[i:j], mixed[i:j])
            bd = bd_all[i:j]
            rows = mp3_dense.place_rows(table, i, j)
            with trace.span("enqueue"):
                pcm, ht, st = self.dense(x, b, m, ht, st, boundary=bd)
                mp3_dense.mp3_place(pcm, tab, out, i, rows)
        if trace.enabled():
            trace.count("mp3_placed_streams", len(group))
            trace.count("mp3_placed_bytes", 4 * size)
        res = []
        for _, _, _, n, off in table.tolist():
            clip = out[off : off + C * n].view(C, n)
            # On the CPU a tensor's host array shares its memory: each
            # caller owns its clip's.
            res.append(trace.to_host(clip.clone() if cpu else clip))
        return res

    def _decode_stream(self, data: bytes, reader) -> DecodedAudio:
        """One opened stream on its own: Layer I/II (:meth:`_decode_l12`),
        or a Layer III clip whose entropy the merged pass did not give (the
        host's extraction, then :meth:`_decode_layer3` as a group of one),
        else the counted host route."""
        from . import native
        from .codecs.mpa_common import LAYER3

        h = reader.header
        if h.layer != LAYER3:
            return self._decode_l12(data, reader)
        got = None
        if native.available():
            with trace.span("extract"):
                got = self._extract(reader)
        if got is None:
            trace.count("mp3_host_streams", 1)
            return _host_decode(data, self.gapless)
        pcm, = self._decode_layer3([(reader,) + got])
        with trace.span("stitch"):
            return DecodedAudio(pcm, h.sample_rate, 32)

    def _decode_l12(self, data: bytes, reader) -> DecodedAudio:
        """Layer I/II: the native bitstream stage frame by frame, then L1
        over chunks of ``granule_chunk`` frames with the synthesis tail
        carried on the device. The stream takes the counted host route,
        where the reference falls back to its sequential decoder, when the
        native library is missing or rejects a frame, a header does not
        parse, or a frame has another channel count or layer."""
        from . import native
        from .codecs.mpa_common import LAYER1, parse_header
        from .codecs.mpa_layer12 import (_find_sb_info,
                                                      _intensity_bound,
                                                      tables)

        if not native.available():
            return _host_decode(data, self.gapless)
        h = reader.header
        C = h.n_channels
        buf = reader._buf
        sf_table = tables()["layer12_scalefactors"]
        frames = []
        # The frames' native bitstream stage; a stream the host route takes
        # decodes inside this span.
        with trace.span("extract"):
            for off, size in zip(reader._offsets, reader._sizes):
                frame = bytes(buf[off : off + size])
                try:
                    fh = parse_header(int.from_bytes(frame[:4], "big"))
                except DecodeError:
                    return _host_decode(data, self.gapless)
                pos = 4 + (2 if fh.has_crc else 0)
                if fh.layer == LAYER1:
                    layer, T, sblimit, rows = 1, 12, 32, None
                    bound = min(_intensity_bound(fh), 32)
                else:
                    layer, T = 2, 36
                    sblimit, rows = _find_sb_info(fh)
                    bound = min(_intensity_bound(fh), sblimit)
                s = native.mpa_l12_extract(
                    layer, bytes(frame[pos : fh.frame_size]), fh.n_channels,
                    bound, sblimit, rows, sf_table)
                if s is None or fh.n_channels != C or fh.layer != h.layer:
                    return _host_decode(data, self.gapless)
                # The extraction's output is pooled: copy before the next
                # call.
                frames.append(s[:C].reshape(C, 32, T).copy())
        if not frames:
            return _host_decode(data, self.gapless)
        with trace.span("pack"):
            sb = np.stack(frames)  # [F, C, 32, T]
        parts = []
        tail = None
        for i in range(0, len(sb), self.granule_chunk):
            x, = trace.to_device(self.device, sb[i : i + self.granule_chunk])
            with trace.span("enqueue"):
                pcm, tail = self.l12(x, tail)
            parts.append(trace.to_host(pcm))
        with trace.span("stitch"):
            pcm = np.concatenate(parts).transpose(1, 0, 2).reshape(C, -1)
            pcm = _gapless_trim(pcm, reader.default_track(), self.gapless)
        return DecodedAudio(pcm, h.sample_rate, 32)

    def _open(self, mss):
        """An ``mpa_walk.MpaReader``: its frame-table walk in span
        ``scan``."""
        from .core.formats import FormatOptions
        from .mpa_walk import MpaReader

        with trace.span("scan"):
            return MpaReader(mss, FormatOptions(enable_gapless=self.gapless))

    def _decode_opened(self, datas: Sequence[bytes],
                       readers) -> List[DecodedAudio]:
        """Decode MPEG audio streams already opened (``readers``, one
        ``MpaReader`` a stream) with merged dispatches: the Layer III
        streams of one channel count take :meth:`_decode_layer3` as one
        group, so merged output equals per-file output. The other streams
        take :meth:`_decode_stream`, in the callers' order, before the
        merged groups."""
        from . import native
        from .codecs.mpa_common import LAYER3

        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        layer3 = {i: r for i, r in enumerate(readers)
                  if native.available() and r.header.layer == LAYER3}
        got = self._entropy(layer3)
        by_c = {}
        for i, (data, reader) in enumerate(zip(datas, readers)):
            if got.get(i) is None:
                results[i] = self._decode_stream(data, reader)
            else:
                by_c.setdefault(int(got[i][0].shape[1]), []).append(
                    (i, reader) + got[i])
        for group in by_c.values():
            pcms = self._decode_layer3([g[1:] for g in group])
            with trace.span("stitch"):
                for (idx, reader, *_), pcm in zip(group, pcms):
                    results[idx] = DecodedAudio(
                        pcm, reader.header.sample_rate, 32)
        return results

    def _entropy(self, readers: dict) -> dict:
        """Each Layer III stream's lanes ({index: reader} -> {index: (spectra,
        bt, mixed) or None}): M0 in one launch on the card, the native
        extraction stream by stream on the CPU."""
        if self.device.type == "cuda":
            return dict(zip(readers, self._card_entropy(list(
                readers.values()))))
        out = {}
        for i, reader in readers.items():
            try:
                with trace.span("extract"):
                    out[i] = self._extract(reader)
            except Exception:
                out[i] = None  # _decode_stream raises or routes it
        return out


def _oracle_lanes(items) -> dict:
    """Per-frame (coeffs, seq, shape, prev_shape) of the Python oracle ->
    lane arrays: host-dequantized lanes (deq = 1, zero qbuf and scales)."""
    n = len(items)
    return {
        "coeffs": (np.stack([np.asarray(it[0], np.float32) for it in items])
                   if n else np.zeros((0, 1024), np.float32)),
        "qbuf": np.zeros((n, 1024), np.int16),
        "scales": np.zeros((n, 64), np.float32),
        "deq": np.ones(n, np.int32),
        "seq": np.array([int(it[1]) for it in items], np.int32),
        "shape": np.array([int(it[2]) for it in items], np.int32),
        "prev_shape": np.array([int(it[3]) for it in items], np.int32),
    }


class AacBatchDecoder(_BatchDecoder):
    """Whole-stream AAC-LC decode from the probe's readers (any container):
    the reference's host entropy stage, then the dense stage
    (:class:`ops.aac_dense.AacDense`) over the lanes of every (file,
    channel) frame sequence of a sample-rate group at once, in chunks of
    at most ``LANE_CHUNK`` lanes (a memory bound: ~16 KB of device memory
    per lane)."""

    LANE_CHUNK = 32768

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self._dense: Optional[AacDense] = None

    @property
    def dense(self) -> AacDense:
        if self._dense is None:
            self._dense = AacDense.from_numpy(aac_tables(), self.device)
        return self._dense

    @staticmethod
    def _extract_host(fmt):
        """Host stage for one opened stream (``fmt``, the probe's reader):
        (decoder, one lane-array dict per channel, see
        ``ops.aac_dense.LANE_KEYS``).

        The native extraction's buffers are POOLED (the next stream's
        extraction reuses them), so each channel's lanes are copied out.
        Without the native library, or when a frame is malformed or carries
        another channel count, the reference's Python oracle decodes the
        coefficients instead (undecodable packets are skipped, as the
        reference's decode loop does)."""
        from . import native
        from .codecs.aac import AacDecoder

        track = _audio_track_or_raise(fmt)
        if track.codec_params.codec != "aac":
            raise DecodeError("not an AAC stream")
        dec = AacDecoder(track.codec_params)
        C = dec.spec.num_channels
        pkts = []
        while (pkt := fmt.next_packet()) is not None:
            if pkt.track_id == track.id:
                pkts.append(bytes(pkt.data))
        ext = None
        if native.available() and pkts:
            sizes = np.array([len(p) for p in pkts], np.int64)
            offs = np.zeros(len(pkts), np.int64)
            np.cumsum(sizes[:-1], out=offs[1:])
            ext = native.aac_extract(b"".join(pkts), offs, sizes,
                                     dec.rate_idx, dec.bands_long,
                                     dec.bands_short, C)
            if ext is not None and ((ext["status"] != 0).any()
                                    or (ext["nch"] != C).any()):
                ext = None
        if ext is not None:
            F = ext["F"]
            return dec, [{k: np.array(ext[k][:F, c], copy=True)
                          for k in LANE_KEYS} for c in range(C)]
        items = [[] for _ in range(C)]
        for p in pkts:
            try:
                chans = dec.decode_coeffs(p)
            except DecodeError:
                continue
            for c, item in enumerate(chans[:C]):
                items[c].append(item)
        return dec, [_oracle_lanes(it) for it in items]

    @staticmethod
    def _open(mss):
        from . import get_probe

        return get_probe().probe(mss).format

    def _decode_opened(self, datas: Sequence[bytes],
                       fmts) -> List[DecodedAudio]:
        """Decode AAC streams already opened (``fmts``, the probe's reader
        of each) with merged dispatches: the (file, channel) frame
        sequences of every stream with the same ``bands_long`` (sample-rate
        group) become one lane batch. An undecodable stream raises in the
        callers' order."""
        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        groups = {}
        for i, fmt in enumerate(fmts):
            with trace.span("extract"):
                dec, chans = self._extract_host(fmt)
            key = tuple(int(b) for b in dec.bands_long)
            groups.setdefault(key, []).append((i, dec, chans))
        for bl, group in groups.items():
            self._dispatch_merged(bl, group, results)
        return results

    def _dispatch_merged(self, bl, group, results) -> None:
        """One dense pass over every lane of the group (``first`` marks
        each sequence start), then split, and pad the channels of each
        stream to one length."""
        with trace.span("pack"):
            parts = {k: [] for k in LANE_KEYS}
            firsts = []
            for _, _, chans in group:
                for ch in chans:
                    n = len(ch["seq"])
                    if not n:
                        continue
                    for k in LANE_KEYS:
                        parts[k].append(ch[k])
                    f = np.zeros(n, bool)
                    f[0] = True
                    firsts.append(f)
            if firsts:
                lanes = {k: np.concatenate(v) for k, v in parts.items()}
                first = np.concatenate(firsts)
        out = np.zeros((0, 1024), np.float32)
        if firsts:
            out = self.dense.decode_lanes(lanes, first, bl, self.LANE_CHUNK)
        with trace.span("stitch"):
            pos = 0
            for idx, dec, chans in group:
                lens = [len(ch["seq"]) for ch in chans]
                pcm = np.zeros((len(chans), 1024 * max(lens, default=0)),
                               np.float32)
                for c, n in enumerate(lens):
                    pcm[c, : 1024 * n] = out[pos : pos + n].reshape(-1)
                    pos += n
                results[idx] = DecodedAudio(pcm, dec.spec.rate, 32)


class VorbisBatchDecoder(_BatchDecoder):
    """Whole-stream Ogg Vorbis decode from opened ``OggReader``s: the
    reference's host entropy stage (floors, residues, coupling), then the
    dense stage (:mod:`ops.vorbis_dense`): one V1 IMDCT per distinct block
    size over the packet-channel lanes of every stream, in chunks of
    ``vorbis_dense.LANE_CHUNK`` lanes, and the reference's numpy lap stitch
    per stream."""

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self.dense = VorbisDense({}, self.device)

    @staticmethod
    def _extract_host(reader):
        """Host stage for one opened stream (``reader``, an ``OggReader``):
        (track, decoder, per-packet spectra [C, n/2], block flags,
        per-packet (trim_start, trim_end)).

        The native bulk entropy call returns fresh arrays (not pooled), so
        the spectra can wait for other streams. Without the native library,
        or when a packet is malformed, the reference's Python oracle
        decodes the spectra instead, skipping undecodable packets (and
        their trims) as the reference's decode loop does."""
        from . import native
        from .codecs.vorbis import VorbisDecoder

        track = _audio_track_or_raise(reader)
        if track.codec_params.codec != "vorbis":
            raise DecodeError("not a Vorbis stream")
        dec = VorbisDecoder(track.codec_params)
        pkts, trims = [], []
        while (pkt := reader.next_packet()) is not None:
            if pkt.track_id == track.id:
                pkts.append(bytes(pkt.data))
                trims.append((pkt.trim_start, pkt.trim_end))
        ext = native.vorbis_decode_spectra(dec, pkts)
        if ext is not None and (ext[2] != 0).any():
            ext = None
        spectra, flags = [], []
        if ext is not None:
            sp_all, fl_all, _ = ext
            for i in range(len(pkts)):
                n2 = (dec.bs1 if fl_all[i] else dec.bs0) // 2
                spectra.append(sp_all[i, :, :n2])
                flags.append(bool(fl_all[i]))
            return track, dec, spectra, flags, trims
        kept = []
        for p, tr in zip(pkts, trims):
            try:
                sp, flag = dec.decode_spectra(p)
            except DecodeError:
                continue
            spectra.append(sp)
            flags.append(flag)
            kept.append(tr)
        return track, dec, spectra, flags, kept

    @staticmethod
    def _finish(track, pcm: np.ndarray, trims) -> DecodedAudio:
        """Trims (the trim_end sum from the tail, then the trim_start sum
        from the head), then Vorbis channel order -> output order."""
        from .codecs.vorbis import _CHANNEL_MAP

        total_trim_end = sum(t[1] for t in trims)
        if total_trim_end:
            pcm = pcm[:, : pcm.shape[1] - total_trim_end]
        total_trim_start = sum(t[0] for t in trims)
        if total_trim_start:
            pcm = pcm[:, total_trim_start:]
        chmap = _CHANNEL_MAP.get(pcm.shape[0], list(range(pcm.shape[0])))
        out = np.zeros_like(pcm)
        for src, dst in enumerate(chmap):
            out[dst] = pcm[src]
        return DecodedAudio(out, track.codec_params.sample_rate, 32)

    @staticmethod
    def _open(mss):
        from .formats.ogg import OggReader

        return OggReader(mss)

    def _decode_opened(self, datas: Sequence[bytes],
                       readers) -> List[DecodedAudio]:
        """Decode Vorbis streams already opened (``readers``) with merged
        dispatches: the packet-channel lanes of every stream group by
        block size across files, one IMDCT per distinct size. An
        undecodable stream raises in the callers' order."""
        got = []
        for reader in readers:
            with trace.span("extract"):
                got.append(self._extract_host(reader))
        pcms = decode_packets_dense_multi(
            [(spectra, flags, dec.bs0, dec.bs1)
             for _, dec, spectra, flags, _ in got],
            dense=self.dense)
        with trace.span("stitch"):
            return [self._finish(track, pcm, trims)
                    for (track, _, _, _, trims), pcm in zip(got, pcms)]


def _audio_track_or_raise(fmt):
    """The default audio track, or Unsupported for containers that opened
    with only non-audio tracks."""
    track = fmt.default_track()
    if track is None or track.codec_params is None:
        raise Unsupported("no audio tracks")
    return track


def _decoded(fmt, track, dec):
    """The track's packets through ``dec``, one buffer each; a corrupt
    packet is skipped, as the reference's decode loop does."""
    while (pkt := fmt.next_packet()) is not None:
        if pkt.track_id != track.id:
            continue
        try:
            buf = dec.decode(pkt)
        except DecodeError:
            continue
        yield buf


def _host_decode(data: bytes, gapless: bool) -> DecodedAudio:
    """Exact per-packet host decode of a FLAC or MPEG audio stream, for the
    cases where the reference also leaves the device (its
    ``_fallback_decode``, ``symphonia_tpu/batch.py:576-606``)."""
    global host_routes
    from . import get_codecs, get_probe
    from .core.formats import FormatOptions

    probed = get_probe().probe(
        MediaSourceStream(data), fmt_opts=FormatOptions(enable_gapless=gapless))
    fmt = probed.format
    track = _audio_track_or_raise(fmt)
    dec = get_codecs().make_audio_decoder(track.codec_params)
    host_routes += 1
    logger.info("host route for a %s stream", track.codec_params.codec)
    outs = [buf.planes().copy() for buf in _decoded(fmt, track, dec)
            if buf.frames]
    n_ch = (track.codec_params.channels.count
            if track.codec_params.channels else 1)
    pcm = (np.concatenate(outs, axis=1) if outs
           else np.zeros((n_ch, 0), np.float32))
    return DecodedAudio(pcm, track.codec_params.sample_rate,
                        track.codec_params.bits_per_sample or 32)


def _packet_decode(fmt, track, verify: bool) -> DecodedAudio:
    """The reference's per-packet loop for a stream no batch pipeline
    takes (``symphonia_tpu/batch.py:715-743``): the registry's decoder,
    corrupt packets skipped, the planes concatenated, the decoder's own
    verification (FLAC's MD5) as ``md5_ok``."""
    global packet_routes
    from . import get_codecs
    from .core.codecs import AudioDecoderOptions

    dec = get_codecs().make_audio_decoder(
        track.codec_params, AudioDecoderOptions(verify=verify))
    packet_routes += 1
    outs = [buf.planes().copy() for buf in _decoded(fmt, track, dec)]
    pcm = (np.concatenate(outs, axis=1) if outs
           else np.zeros((track.codec_params.channels.count, 0), np.int32))
    return DecodedAudio(pcm, track.codec_params.sample_rate,
                        track.codec_params.bits_per_sample or 32,
                        dec.finalize().verify_ok)


_MPA = ("mp1", "mp2", "mp3")


def _probe(data: bytes):
    """Probe one stream -> (route, format reader, track). The route is
    'flac', 'mp1'/'mp2'/'mp3' or 'vorbis' for the batch pipelines (native
    containers only, as in the reference), 'aac' in any container, else
    'packet' for the per-packet loop."""
    from . import get_probe
    from .formats.flac import FlacReader
    from .formats.mpa import MpaReader
    from .formats.ogg import OggReader

    fmt = get_probe().probe(MediaSourceStream(data)).format
    track = _audio_track_or_raise(fmt)
    codec = track.codec_params.codec
    if codec == "flac" and isinstance(fmt, FlacReader):
        route = "flac"
    elif codec in _MPA and isinstance(fmt, MpaReader):
        route = codec
    elif codec == "vorbis" and isinstance(fmt, OggReader):
        route = "vorbis"
    elif codec == "aac":  # any container: the AAC decoder takes the reader
        route = "aac"
    else:
        route = "packet"
    return route, fmt, track


def decode_bytes(data: bytes, *, device="cuda", verify: bool = False
                 ) -> DecodedAudio:
    """Decode one stream of any format and codec the port reads:
    :func:`decode_many` of one."""
    return decode_many([data], device=device, verify=verify)[0]


def decode_file(path: str, *, device="cuda", verify: bool = False
                ) -> DecodedAudio:
    with open(path, "rb") as f:
        data = f.read()
    return decode_bytes(data, device=device, verify=verify)


def decode_many(datas: Sequence[bytes], *, device="cuda",
                verify: bool = False) -> List[DecodedAudio]:
    """Decode a batch of streams, merging device work across files.

    The serving entry point: each stream is probed once, and its probed
    reader goes to its route's batch decoder (FLAC, MP3 Layer III, AAC,
    Vorbis), whose streams share merged dispatches; nothing opens a stream
    again. Layer I/II streams, and streams that no batch pipeline takes
    (through the per-packet loop), decode one by one in input order while
    the batch is probed, before the groups, as in the reference
    (``symphonia_tpu/batch.py:645-666``). Output order matches input order.
    Fail-fast: an undecodable stream raises, and the first to raise is
    the reference's.

    Each call is one request of :mod:`trace` (root span ``decode_many``)
    while ``torch.profiler`` records."""
    with trace.span("decode_many"):
        resolve_device(device)
        with trace.span("setup"):
            decoders = {"flac": FlacBatchDecoder(device=device, verify=verify),
                        "mp3": Mp3BatchDecoder(device=device),
                        "aac": AacBatchDecoder(device=device),
                        "vorbis": VorbisBatchDecoder(device=device)}
        groups = {}  # route -> [(index, data, reader)]
        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        for i, data in enumerate(datas):
            with trace.span("probe"):
                route, fmt, track = _probe(data)
            if route == "packet":
                results[i] = _packet_decode(fmt, track, verify)
            elif route in ("mp1", "mp2"):
                results[i] = decoders["mp3"]._decode_l12(data, fmt)
            else:
                groups.setdefault(route, []).append((i, data, fmt))
        for route, dec in decoders.items():
            if route in groups:
                idx, ds, fmts = zip(*groups[route])
                for i, out in zip(idx, dec._decode_opened(ds, fmts)):
                    results[i] = out
        return results
