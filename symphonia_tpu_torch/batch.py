"""Batch decode sessions on PyTorch: files -> PCM through the port's kernels.

Port of ``symphonia_tpu/batch.py``. The host stage (probe, demuxers, native
C++ entropy extraction, the per-packet codecs) is the port's own copy of
the reference's. FLAC, MPEG audio (Layers I, II and III), AAC-LC and Ogg
Vorbis take their batch decoders, whose dense stage runs on ``device``:
the hand-written CUDA kernels on ``"cuda"`` (the default of every entry
point), their plain PyTorch twins on ``"cpu"``. A call without a device
runs on the card or raises when there is none; nothing falls back to the
CPU on its own.

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
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.errors import DecodeError, Unsupported
from .core.io import MediaSourceStream

from .ops import flac_dense
from .ops.aac_dense import LANE_KEYS, AacDense
from .ops.aac_dense import reference_tables as aac_tables
from .ops.mp3_dense import L12Dense, Mp3Dense, l12_tables, reference_tables
from .ops.vorbis_dense import (VorbisDense, decode_packets_dense,
                               decode_packets_dense_multi)

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


def _flac_md5_ok(samples: np.ndarray, si) -> Optional[bool]:
    """STREAMINFO MD5 verification; None when the stream carries no MD5
    (the all-zero sentinel)."""
    if si.md5 == b"\x00" * 16:
        return None
    from .codecs.flac import md5_bytes_of

    return hashlib.md5(
        md5_bytes_of(samples.astype(np.int64), si.bits_per_sample)
    ).digest() == si.md5


def _gapless_trim(pcm: np.ndarray, track, gapless: bool) -> np.ndarray:
    if not gapless:
        return pcm
    total = pcm.shape[1]
    start = min(track.delay, total)
    end = max(start, total - track.padding)
    return pcm[:, start:end]


def _copy_pooled(d: dict) -> dict:
    """The native extraction returns POOLED buffers that the next file's
    extraction reuses: copy before queueing."""
    return {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


class FlacBatchDecoder:
    """Whole-file(s) FLAC decode through the batched dense stage.

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

    def decode_bytes(self, data: bytes, _reader=None,
                     _extracted=None) -> DecodedAudio:
        from .codecs.flac import parse_frame
        from .formats.flac import FlacReader

        reader = (_reader if _reader is not None
                  else FlacReader(MediaSourceStream(data)))
        si = reader.stream_info
        if si.bits_per_sample > 25:
            # 32-bit streams carry 33-bit side channels, beyond the int32
            # lanes; the reference decodes them on the host, exactly.
            out = _host_decode(data, gapless=True)
            if self.verify:
                out.md5_ok = _flac_md5_ok(out.samples, si)
            return out
        packed, blocks = (_extracted if _extracted is not None
                          else self._extract_host(reader))
        empty = DecodedAudio(np.zeros((si.channels, 0), np.int32),
                             si.sample_rate, si.bits_per_sample)
        if packed is None and blocks is None:  # no frames found at all
            return empty
        if packed is not None:
            pcm = self._decode_packed_chunked(packed, blocks)
        else:
            frames = []
            for p in reader.packet_table().data:
                try:
                    frames.append(parse_frame(p, si))
                except DecodeError:
                    # Corrupt frame: skip the packet, as the reference
                    # decode loop does.
                    logger.warning("flac: skipping corrupt frame")
            if not frames:
                return empty
            C = max(f.header.n_channels for f in frames)
            frames_per_chunk = max(1, self.lane_chunk // C)
            n_max = max(si.block_len_max,
                        max(f.header.block_size for f in frames))
            outs = []
            for i in range(0, len(frames), frames_per_chunk):
                chunk = frames[i : i + frames_per_chunk]
                pk = flac_dense.pack_parsed_frames(chunk, n_max=n_max)
                out = flac_dense.decode_packed(pk, self.device)
                for j, f in enumerate(chunk):
                    outs.append(out[j, : f.header.n_channels,
                                    : f.header.block_size])
            pcm = np.concatenate(outs, axis=1)
        if si.n_samples:
            pcm = pcm[:, : si.n_samples]
        md5_ok = _flac_md5_ok(pcm, si) if self.verify else None
        return DecodedAudio(pcm, si.sample_rate, si.bits_per_sample, md5_ok)

    def _decode_packed_chunked(self, packed, blocks: np.ndarray) -> np.ndarray:
        """Dense stage over native-packed tensors in lane chunks, then
        stitch the per-frame outputs."""
        F, C, n_max = int(packed["F"]), int(packed["C"]), int(packed["n_max"])
        frames_per_chunk = max(1, self.lane_chunk // C)
        lanes = {k: np.asarray(packed[k]).reshape(F, C, -1)
                 for k in ("res", "coefs")}
        per_lane = {k: np.asarray(packed[k]).reshape(F, C)
                    for k in ("order", "shift", "wasted")}
        outs = []
        for i in range(0, F, frames_per_chunk):
            j = min(F, i + frames_per_chunk)
            sub = {k: v[i:j].reshape((j - i) * C, -1)
                   for k, v in lanes.items()}
            sub.update({k: v[i:j].reshape(-1) for k, v in per_lane.items()})
            sub.update(assign=np.asarray(packed["assign"])[i:j],
                       F=j - i, C=C, n_max=n_max)
            out = flac_dense.decode_packed(sub, self.device)
            for k in range(j - i):
                outs.append(out[k, :, : int(blocks[i + k])])
        return np.concatenate(outs, axis=1)

    def decode_file(self, path: str) -> DecodedAudio:
        with open(path, "rb") as f:
            return self.decode_bytes(f.read())

    def decode_files(self, paths: Sequence[str]) -> List[DecodedAudio]:
        datas = []
        for p in paths:
            with open(p, "rb") as f:
                datas.append(f.read())
        return self.decode_many(datas)

    def decode_many(self, datas: Sequence[bytes]) -> List[DecodedAudio]:
        """Decode several FLAC streams through MERGED device dispatches:
        frame lanes of every stream with the same channel count share the
        lane chunks; per-file outputs are unchanged. Streams whose host
        stage yields no packed lanes take their per-file path."""
        from .formats.flac import FlacReader

        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        jobs = []  # (result idx, stream_info, packed, blocks)
        for i, data in enumerate(datas):
            try:
                reader = FlacReader(MediaSourceStream(data))
            except Exception:
                reader = None  # decode_bytes raises the reader's error
            if reader is None or reader.stream_info.bits_per_sample > 25:
                results[i] = self.decode_bytes(data)
                continue
            packed, blocks = self._extract_host(reader)
            if packed is None:
                # Robust per-file path, reusing the scan just done.
                results[i] = self.decode_bytes(
                    data, _reader=reader, _extracted=(packed, blocks))
                continue
            jobs.append((i, reader.stream_info, _copy_pooled(packed),
                         np.array(blocks, copy=True)))
        by_c = {}
        for job in jobs:
            by_c.setdefault(int(job[2]["C"]), []).append(job)
        for C, group in by_c.items():
            self._dispatch_merged(C, group, results)
        return results

    def _dispatch_merged(self, C: int, group, results) -> None:
        """One merged dense pass over every stream with channel count C,
        then split, trim and verify per stream."""
        n_max = max(int(p["n_max"]) for _, _, p, _ in group)
        parts = {k: [] for k in ("res", "coefs", "order", "shift",
                                 "wasted", "assign")}
        blocks_l = []
        spans = []
        total_f = 0
        for idx, si, p, blocks in group:
            F = int(p["F"])
            res = np.asarray(p["res"]).reshape(F, C, int(p["n_max"]))
            if int(p["n_max"]) != n_max:
                res = np.pad(res, ((0, 0), (0, 0),
                                   (0, n_max - int(p["n_max"]))))
            parts["res"].append(res.reshape(F * C, n_max))
            parts["coefs"].append(np.asarray(p["coefs"]).reshape(F * C, 32))
            for k in ("order", "shift", "wasted"):
                parts[k].append(np.asarray(p[k]).reshape(F * C))
            parts["assign"].append(np.asarray(p["assign"])[:F])
            blocks_l.append(np.asarray(blocks))
            spans.append((idx, si, int(np.asarray(blocks).sum())))
            total_f += F
        merged = {k: np.concatenate(v) for k, v in parts.items()}
        merged.update(F=total_f, C=C, n_max=n_max)
        pcm_all = self._decode_packed_chunked(merged, np.concatenate(blocks_l))
        pos = 0
        for idx, si, n in spans:
            pcm = pcm_all[:, pos : pos + n]
            pos += n
            if si.n_samples:
                pcm = pcm[:, : si.n_samples]
            md5_ok = _flac_md5_ok(pcm, si) if self.verify else None
            results[idx] = DecodedAudio(pcm, si.sample_rate,
                                        si.bits_per_sample, md5_ok)


class Mp3BatchDecoder:
    """Whole-file MPEG audio decode. Layer III: native C++ entropy stage,
    then the granule-parallel dense stage (:class:`ops.mp3_dense.Mp3Dense`)
    in chained chunks of ``granule_chunk`` granules (a memory bound).
    Layers I and II: the native per-frame bitstream stage, then the
    frame-parallel polyphase stage (:class:`ops.mp3_dense.L12Dense`) in
    chained chunks of ``granule_chunk`` frames."""

    def __init__(self, *, device="cuda", granule_chunk: int = 4096,
                 gapless: bool = True):
        self.device = resolve_device(device)
        self.granule_chunk = granule_chunk
        self.gapless = gapless
        self._dense: Optional[Mp3Dense] = None
        self._l12: Optional[L12Dense] = None

    @property
    def dense(self) -> Mp3Dense:
        if self._dense is None:
            self._dense = Mp3Dense.from_numpy(reference_tables(), self.device)
        return self._dense

    @property
    def l12(self) -> L12Dense:
        if self._l12 is None:
            self._l12 = L12Dense.from_numpy(l12_tables(), self.device)
        return self._l12

    def _reader(self, data: bytes):
        from .core.formats import FormatOptions
        from .formats.mpa import MpaReader

        return MpaReader(MediaSourceStream(data),
                         FormatOptions(enable_gapless=self.gapless))

    @staticmethod
    def _extract(reader):
        """Native Layer III extraction, copied out of the pooled buffers:
        (spectra [G, C, 576], bt [G, C], mixed [G, C]) or None when the
        stream is malformed."""
        from . import native

        ext = native.mp3_extract(reader._buf, reader._offsets, reader._sizes,
                                 max_granules=2 * len(reader._offsets) + 2)
        if ext is None or (ext["status"] != 0).any():
            return None
        C = reader.header.n_channels
        G = ext["n_granules"]
        return (np.array(ext["spectra"][:G, :C], copy=True),
                np.array(ext["bt"][:G, :C], copy=True),
                np.array(ext["mixed"][:G, :C], copy=True).astype(bool))

    def _dense_chunked(self, spectra, bt, mixed, boundary=None) -> np.ndarray:
        """[G, C, 576] spectra -> [G, C, 576] PCM, chunk by chunk with the
        carried state kept on the device."""
        G, C = spectra.shape[:2]
        dev = self.device
        parts = []
        ht = st = None
        for i in range(0, G, self.granule_chunk):
            j = min(G, i + self.granule_chunk)
            bd = (None if boundary is None
                  else torch.from_numpy(boundary[i:j]).to(dev))
            out, ht, st = self.dense(
                torch.from_numpy(np.ascontiguousarray(spectra[i:j])).to(dev),
                torch.from_numpy(np.ascontiguousarray(bt[i:j])).to(dev),
                torch.from_numpy(np.ascontiguousarray(mixed[i:j])).to(dev),
                ht, st, boundary=bd)
            parts.append(out.cpu().numpy())
        return (np.concatenate(parts, axis=0) if parts
                else np.zeros((0, C, 576), np.float32))

    def decode_bytes(self, data: bytes) -> DecodedAudio:
        from . import native
        from .codecs.mpa_common import LAYER3

        reader = self._reader(data)
        h = reader.header
        if h.layer != LAYER3:
            return self._decode_l12(data, reader)
        if not native.available():
            return _host_decode(data, self.gapless)
        got = self._extract(reader)
        if got is None:
            return _host_decode(data, self.gapless)
        pcm = self._dense_chunked(*got)
        C = h.n_channels
        pcm = pcm.transpose(1, 0, 2).reshape(C, -1)
        pcm = _gapless_trim(pcm, reader.default_track(), self.gapless)
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
            # The extraction's output is pooled: copy before the next call.
            frames.append(s[:C].reshape(C, 32, T).copy())
        if not frames:
            return _host_decode(data, self.gapless)
        sb = np.stack(frames)  # [F, C, 32, T]
        parts = []
        tail = None
        for i in range(0, len(sb), self.granule_chunk):
            pcm, tail = self.l12(torch.from_numpy(
                sb[i : i + self.granule_chunk]).to(self.device), tail)
            parts.append(pcm.cpu().numpy())
        pcm = np.concatenate(parts).transpose(1, 0, 2).reshape(C, -1)
        pcm = _gapless_trim(pcm, reader.default_track(), self.gapless)
        return DecodedAudio(pcm, h.sample_rate, 32)

    def decode_file(self, path: str) -> DecodedAudio:
        with open(path, "rb") as f:
            return self.decode_bytes(f.read())

    def decode_many(self, datas: Sequence[bytes]) -> List[DecodedAudio]:
        """Merged-dispatch MP3 decode: granule lanes of every Layer III
        stream with the same channel count share the dense-stage chunks; a
        per-granule boundary mask breaks the hybrid and polyphase chains at
        file starts, so merged output equals per-file output. Streams that
        are not native-extractable Layer III take their per-file path."""
        from . import native
        from .codecs.mpa_common import LAYER3

        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        jobs = []  # (idx, reader, spectra, bt, mixed)
        for i, data in enumerate(datas):
            got = None
            try:
                if native.available():
                    reader = self._reader(data)
                    if reader.header.layer == LAYER3:
                        got = self._extract(reader)
            except Exception:
                got = None  # decode_bytes raises or routes the stream
            if got is None:
                results[i] = self.decode_bytes(data)
            else:
                jobs.append((i, reader) + got)
        by_c = {}
        for job in jobs:
            by_c.setdefault(int(job[2].shape[1]), []).append(job)
        for C, group in by_c.items():
            self._dispatch_merged(C, group, results)
        return results

    def _dispatch_merged(self, C: int, group, results) -> None:
        spectra = np.concatenate([g[2] for g in group])
        bt = np.concatenate([g[3] for g in group])
        mixed = np.concatenate([g[4] for g in group])
        counts = [g[2].shape[0] for g in group]
        boundary = np.zeros(spectra.shape[0], bool)
        starts = np.cumsum([0] + counts[:-1])
        boundary[starts[np.asarray(counts) > 0]] = True
        pcm_all = self._dense_chunked(spectra, bt, mixed, boundary)
        pos = 0
        for (idx, reader, _, _, _), n_g in zip(group, counts):
            pcm = pcm_all[pos : pos + n_g].transpose(1, 0, 2).reshape(C, -1)
            pos += n_g
            pcm = _gapless_trim(pcm, reader.default_track(), self.gapless)
            results[idx] = DecodedAudio(pcm, reader.header.sample_rate, 32)


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


class AacBatchDecoder:
    """Whole-stream AAC-LC decode: the reference's host entropy stage, then
    the dense stage (:class:`ops.aac_dense.AacDense`) over the lanes of
    every (file, channel) frame sequence of a sample-rate group at once, in
    chunks of at most ``LANE_CHUNK`` lanes (a memory bound: ~16 KB of
    device memory per lane)."""

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
    def _extract_host(data: bytes):
        """Host stage for one stream: (decoder, one lane-array dict per
        channel, see ``ops.aac_dense.LANE_KEYS``).

        The native extraction's buffers are POOLED (the next stream's
        extraction reuses them), so each channel's lanes are copied out.
        Without the native library, or when a frame is malformed or carries
        another channel count, the reference's Python oracle decodes the
        coefficients instead (undecodable packets are skipped, as the
        reference's decode loop does)."""
        from . import get_probe
        from . import native
        from .codecs.aac import AacDecoder

        fmt = get_probe().probe(MediaSourceStream(data)).format
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

    def decode_bytes(self, data: bytes) -> DecodedAudio:
        dec, chans = self._extract_host(data)
        results: List[Optional[DecodedAudio]] = [None]
        self._dispatch_merged(dec.bands_long, [(0, dec, chans)], results)
        return results[0]

    def decode_file(self, path: str) -> DecodedAudio:
        with open(path, "rb") as f:
            return self.decode_bytes(f.read())

    def decode_many(self, datas: Sequence[bytes]) -> List[DecodedAudio]:
        """Merged-dispatch AAC decode: the (file, channel) frame sequences
        of every stream with the same ``bands_long`` (sample-rate group)
        become one lane batch; output per file equals ``decode_bytes``. An
        undecodable stream raises what ``decode_bytes`` raises for it."""
        results: List[Optional[DecodedAudio]] = [None] * len(datas)
        groups = {}
        for i, data in enumerate(datas):
            dec, chans = self._extract_host(data)
            key = tuple(int(b) for b in dec.bands_long)
            groups.setdefault(key, []).append((i, dec, chans))
        for bl, group in groups.items():
            self._dispatch_merged(bl, group, results)
        return results

    def _dispatch_merged(self, bl, group, results) -> None:
        """One dense pass over every lane of the group (``first`` marks
        each sequence start), then split, and pad the channels of each
        stream to one length."""
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
        out = np.zeros((0, 1024), np.float32)
        if firsts:
            out = self.dense.decode_lanes(
                {k: np.concatenate(v) for k, v in parts.items()},
                np.concatenate(firsts), bl, self.LANE_CHUNK)
        pos = 0
        for idx, dec, chans in group:
            lens = [len(ch["seq"]) for ch in chans]
            pcm = np.zeros((len(chans), 1024 * max(lens, default=0)),
                           np.float32)
            for c, n in enumerate(lens):
                pcm[c, : 1024 * n] = out[pos : pos + n].reshape(-1)
                pos += n
            results[idx] = DecodedAudio(pcm, dec.spec.rate, 32)


class VorbisBatchDecoder:
    """Whole-stream Ogg Vorbis decode: the reference's host entropy stage
    (floors, residues, coupling), then the dense stage
    (:mod:`ops.vorbis_dense`): one V1 IMDCT per distinct block size over
    the packet-channel lanes of every stream, in chunks of
    ``vorbis_dense.LANE_CHUNK`` lanes, and the reference's numpy lap stitch
    per stream."""

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self.dense = VorbisDense({}, self.device)

    @staticmethod
    def _extract_host(data: bytes):
        """Host stage for one stream: (track, decoder, per-packet spectra
        [C, n/2], block flags, per-packet (trim_start, trim_end)).

        The native bulk entropy call returns fresh arrays (not pooled), so
        the spectra can wait for other streams. Without the native library,
        or when a packet is malformed, the reference's Python oracle
        decodes the spectra instead, skipping undecodable packets (and
        their trims) as the reference's decode loop does."""
        from . import native
        from .codecs.vorbis import VorbisDecoder
        from .formats.ogg import OggReader

        reader = OggReader(MediaSourceStream(data))
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

    def decode_bytes(self, data: bytes) -> DecodedAudio:
        track, dec, spectra, flags, trims = self._extract_host(data)
        pcm = decode_packets_dense(spectra, flags, dec.bs0, dec.bs1,
                                   dense=self.dense)
        return self._finish(track, pcm, trims)

    def decode_file(self, path: str) -> DecodedAudio:
        with open(path, "rb") as f:
            return self.decode_bytes(f.read())

    def decode_many(self, datas: Sequence[bytes]) -> List[DecodedAudio]:
        """Merged-dispatch Vorbis decode: the packet-channel lanes of every
        stream group by block size across files, one IMDCT per distinct
        size; output per file equals ``decode_bytes``. An undecodable
        stream raises what ``decode_bytes`` raises for it."""
        got = [self._extract_host(d) for d in datas]
        pcms = decode_packets_dense_multi(
            [(spectra, flags, dec.bs0, dec.bs1)
             for _, dec, spectra, flags, _ in got],
            dense=self.dense)
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
    elif codec == "aac":  # any container: the AAC decoder re-probes
        route = "aac"
    else:
        route = "packet"
    return route, fmt, track


def decode_bytes(data: bytes, *, device="cuda", verify: bool = False
                 ) -> DecodedAudio:
    """Decode one stream of any format and codec the port reads: FLAC, MPEG
    audio (Layer I, II or III), AAC-LC and Ogg Vorbis through their batch
    decoders on ``device``, every other stream through the per-packet
    loop."""
    resolve_device(device)
    route, fmt, track = _probe(data)
    if route == "flac":
        return FlacBatchDecoder(device=device, verify=verify).decode_bytes(data)
    if route in _MPA:
        return Mp3BatchDecoder(device=device).decode_bytes(data)
    if route == "aac":
        return AacBatchDecoder(device=device).decode_bytes(data)
    if route == "vorbis":
        return VorbisBatchDecoder(device=device).decode_bytes(data)
    return _packet_decode(fmt, track, verify)


def decode_file(path: str, *, device="cuda", verify: bool = False
                ) -> DecodedAudio:
    with open(path, "rb") as f:
        data = f.read()
    return decode_bytes(data, device=device, verify=verify)


def decode_many(datas: Sequence[bytes], *, device="cuda",
                verify: bool = False) -> List[DecodedAudio]:
    """Decode a batch of streams, merging device work across files.

    The serving entry point: streams are probed and grouped by codec;
    FLAC, MP3 Layer III, AAC and Vorbis groups each share merged
    dispatches. Layer I/II streams, and streams that no batch pipeline
    takes (through the per-packet loop), decode one by one in input order
    while the batch is probed, before the groups, as in the reference
    (``symphonia_tpu/batch.py:645-666``). Output order matches input order.
    Fail-fast: an undecodable stream raises what ``decode_bytes`` raises
    for it, and the first to raise is the reference's."""
    resolve_device(device)
    routes = []
    results: List[Optional[DecodedAudio]] = [None] * len(datas)
    mpa = Mp3BatchDecoder(device=device)
    for i, data in enumerate(datas):
        route, fmt, track = _probe(data)
        routes.append(route)
        if route == "packet":
            results[i] = _packet_decode(fmt, track, verify)
        elif route in ("mp1", "mp2"):
            results[i] = mpa.decode_bytes(data)
    for codecs, dec in (
            (("flac",), FlacBatchDecoder(device=device, verify=verify)),
            (("mp3",), mpa),
            (("aac",), AacBatchDecoder(device=device)),
            (("vorbis",), VorbisBatchDecoder(device=device))):
        idx = [i for i, r in enumerate(routes) if r in codecs]
        if idx:
            for i, out in zip(idx, dec.decode_many([datas[i] for i in idx])):
                results[i] = out
    return results
