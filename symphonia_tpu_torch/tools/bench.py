"""Benchmark of the port: aggregate sustained decode throughput on one card.

Port of the repository's ``bench.py``, function by function under its
names. Prints the stage line and the pipelined line on stderr, the card on
a line of its own, then ONE JSON line: ``{"metric", "value", "unit",
"vs_baseline"}``.

It measures the two pipeline stages of the headline codecs separately and
reports the sustained *pipelined* throughput min(host, device) per codec,
aggregated as the harmonic mean over FLAC, MP3 and AAC (the host entropy
pre-scan of one batch runs while the card decodes the previous one):

  FLAC: native C++ frame scan + Rice extraction (host) | F1 ``flac_lpc``
        with its helper ``flac_lane_order``, then F2 ``flac_decorrelate``
        (card, bit-exact).
  MP3:  native C++ entropy stage: Huffman/reservoir/stereo/reorder (host) |
        M1 ``mp3_hybrid``, then M2 ``mp3_synth`` (card).
  AAC:  native C++ raw_data_block entropy (host) | A1 ``aac_imdct`` with
        its dequant prologue, then A3 ``aac_ola`` (card).
  Vorbis (device stage only, outside the aggregate): V1 ``vorbis_imdct``.

The breadth stages (Vorbis, ALAC, ADPCM and Layer II through the port's
per-packet surface) are in the stage line only, as in ``bench.py``.

Each device stage takes ``bench.py``'s seeded numpy inputs, moves them to
the card, makes one warm-up call (the kernels' nvcc build included,
returned apart as its third value), then times ``iters`` calls on one
stream with CUDA events, the best of three. Host stages are the best wall
time of ``repeats`` calls. Every input comes from the repository: the
tracked ``.bench_cache/`` files, and in-memory streams from the port's
test encoders where ``bench.py`` reads media from an installed package
(MP3: an 8 s stereo Layer III stream; Vorbis: an 8 s stereo stream).

It differs from ``bench.py`` in four points:
  * a stage that fails raises (``bench.py`` prints the failure and counts
    the stage as 0);
  * it prints the card's name and power limit (``nvidia-smi``) before the
    JSON line;
  * ``vs_baseline`` is null: ``bench.py``'s divisor is a target set for
    another accelerator, not a measurement on this card;
  * it describes this card only: its metric names the card.

    python -m symphonia_tpu_torch.tools.bench
"""

from __future__ import annotations

import functools
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..batch import resolve_device

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / ".bench_cache"
# Seconds of the in-memory MP3 and Vorbis streams (bench.py's 8 s files).
STREAM_SECONDS = 8


def _gen_flac(seconds: int = 8) -> bytes:
    path = CACHE / f"bench_{seconds}s.flac"
    if path.exists():
        return path.read_bytes()
    from ..testing.flac_builder import build_flac_file, random_walk

    CACHE.mkdir(exist_ok=True)
    ch = random_walk(44100 * seconds, 16, seed=7, ch=2)
    data = build_flac_file(ch, block_size=4096, stereo_mode="left_side",
                           kind="fixed", order=2, partition_order=2)
    path.write_bytes(data)
    return data


def _device_time(call, dev: torch.device, iters: int):
    """(best, first): one warm-up call, timed apart as ``first`` (the
    kernels' nvcc build included), then the best of three timings of
    ``iters`` calls: CUDA events on the card, the wall clock on the CPU."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    call()
    sync()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                call()
            b.record()
            sync()
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best, first


def _to(dev: torch.device, arrays: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# FLAC
# ---------------------------------------------------------------------------


def bench_flac_host(repeats: int = 30):
    """Host stage: scan + entropy extraction. Returns (audio_s, wall_s)."""
    from .. import native
    from ..core.io import MediaSourceStream
    from ..formats.flac import FlacReader

    data = _gen_flac()
    r = FlacReader(MediaSourceStream(data))
    audio = r.stream_info.n_samples / r.stream_info.sample_rate
    buf = r._buf if r._buf is not None else data[r._data_start:]
    if r._buf is None:
        r._ensure_scan()
        buf = r._buf
    si = r.stream_info
    max_frames = min(si.n_samples // max(1, si.block_len_min) + 8
                     if si.n_samples else len(buf) // 64 + 16,
                     len(buf) // 10 + 16)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        packed = native.flac_fast_extract(buf, si, 4096, max_frames)
        if packed is None:  # no AVX-512: single-pass scalar path
            packed = native.flac_stream_extract(buf, si, 4096, max_frames)
        best = min(best, time.perf_counter() - t0)
        if not (packed["F"] > 0 and (packed["status"] == 0).all()):
            raise RuntimeError("flac_host: extraction failed")
    return audio, best


def flac_device_inputs(n_frames: int = 8192, block: int = 4096,
                       order: int = 8) -> dict:
    """``bench.py``'s FLAC device inputs: 2 * n_frames lanes of ``block``
    residuals with dense order-``order`` coefficients, shift 12, no wasted
    bits, and a random stereo assignment a frame."""
    rng = np.random.default_rng(0)
    L = 2 * n_frames
    res = rng.integers(-2000, 2000, size=(L, block)).astype(np.int32)
    coefs = np.zeros((L, 32), dtype=np.int32)
    coefs[:, :order] = rng.integers(-(2**13), 2**13, size=(L, order))
    return {"res": res, "coefs": coefs,
            "order": np.full(L, order, np.int32),
            "shift": np.full(L, 12, np.int32),
            "wasted": np.zeros(L, np.int32),
            "assign": rng.integers(0, 4, size=n_frames).astype(np.int32)}


def flac_device_call(t: dict) -> torch.Tensor:
    """One pass of the FLAC device stage on tensors of
    :func:`flac_device_inputs`: F1 (the wasted-bits shift fused), then F2
    -> int32 [2 * n_frames, block]."""
    from ..ops import flac_dense

    block = t["res"].shape[1]
    x = flac_dense.lpc_reconstruct_batch(t["res"], t["coefs"], t["order"],
                                         t["shift"], block, t["wasted"])
    return flac_dense.decorrelate_batch(x.reshape(-1, 2, block),
                                        t["assign"]).reshape(-1, block)


def bench_flac_device(n_frames: int = 8192, block: int = 4096,
                      order: int = 8, iters: int = 8, device="cuda"):
    """Device stage: the full dense pipeline, ``iters`` calls timed.
    Returns (audio_s, wall_s, first_call_s)."""
    dev = resolve_device(device)
    t = _to(dev, flac_device_inputs(n_frames, block, order))
    wall, first = _device_time(lambda: flac_device_call(t), dev, iters)
    return n_frames * block / 44100 * iters, wall, first


# ---------------------------------------------------------------------------
# MP3
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _gen_mp3(seconds: int = STREAM_SECONDS) -> bytes:
    """An in-memory stereo 44.1 kHz Layer III stream of ``seconds`` from a
    fixed seed (the port's copy of the repository's test encoder)."""
    from ..testing.mp3_builder import build_mpeg1_l3_stream

    return build_mpeg1_l3_stream(-(-44100 * seconds // 1152), n_ch=2,
                                 seed=20261016)


def bench_mp3_host(repeats: int = 30):
    return _mp3_host(_gen_mp3(), repeats)


def _mp3_host(data: bytes, repeats: int):
    from .. import native
    from ..core.formats import FormatOptions
    from ..core.io import MediaSourceStream
    from ..formats.mpa import MpaReader

    r = MpaReader(MediaSourceStream(data), FormatOptions(enable_gapless=False))
    audio = len(r._offsets) * r.header.duration / r.header.sample_rate
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = native.mp3_extract(r._buf, r._offsets, r._sizes,
                                 max_granules=2 * len(r._offsets) + 2)
        best = min(best, time.perf_counter() - t0)
        if not out["n_granules"] > 0:
            raise RuntimeError("mp3_host: no granule extracted")
    return audio, best


def mp3_device_inputs(n_granules: int = 24576) -> dict:
    """``bench.py``'s MP3 device inputs: stereo granules of random spectra,
    random block types, none mixed."""
    rng = np.random.default_rng(1)
    spectra = (rng.standard_normal((n_granules, 2, 576)) * 0.05).astype(
        np.float32)
    bt = rng.integers(0, 4, size=(n_granules, 2)).astype(np.int32)
    return {"x": spectra, "bt": bt, "mixed": np.zeros((n_granules, 2), bool)}


def mp3_device_dense(dev: torch.device):
    from ..ops.mp3_dense import Mp3Dense, reference_tables

    return Mp3Dense.from_numpy(reference_tables(), dev)


def mp3_device_call(dense, t: dict):
    """One pass of the MP3 device stage from stream start: M1, then M2 ->
    (pcm [G, 2, 576], hybrid_tail, synth_tail)."""
    return dense(t["x"], t["bt"], t["mixed"])


def bench_mp3_device(n_granules: int = 24576, iters: int = 8, device="cuda"):
    dev = resolve_device(device)
    dense = mp3_device_dense(dev)
    t = _to(dev, mp3_device_inputs(n_granules))
    wall, first = _device_time(lambda: mp3_device_call(dense, t), dev, iters)
    return n_granules * 576 / 44100 * iters, wall, first


# ---------------------------------------------------------------------------
# AAC-LC
# ---------------------------------------------------------------------------


def _gen_adts(seconds: int = 8) -> bytes:
    """242 kbps-class stereo AAC-LC bench content.

    Laplacian-magnitude spectra over the full 40-sfb range, encoded with
    per-band minimum-bits codebook selection (how real encoders section a
    spectrum — zero bands cost nothing, small bands use quad books, escapes
    only where needed). At a fixed bitrate this carries MORE decode work per
    second than the old force-cb11 coding (which spent bits on cheap (0,0)
    pairs), so it is the conservative stressor.
    """
    path = CACHE / f"bench_{seconds}s_v2.adts"
    if path.exists():
        return path.read_bytes()
    from ..testing.aac_builder import build_adts, build_raw_block, swb_tables

    CACHE.mkdir(exist_ok=True)
    rng = np.random.default_rng(9)
    long_bands, _ = swb_tables(44100)
    limit = int(long_bands[40])

    def spec():
        q = np.zeros(1024, np.int64)
        n = int(limit * 0.55)
        idx = rng.choice(limit, size=n, replace=False)
        v = np.rint(rng.laplace(0.0, 4.0, size=n)).astype(np.int64)
        q[idx] = np.clip(v, -60, 60)
        return q

    n_frames = 44100 * seconds // 1024 + 1
    frames = [build_raw_block([spec(), spec()], [0, 0], 40, 140, 44100)
              for _ in range(n_frames)]
    data = build_adts(frames, 44100, 2)
    path.write_bytes(data)
    return data


def bench_aac_host(repeats: int = 50):
    """Host stage: native C++ raw_data_block entropy + dequant."""
    from .. import native
    from ..codecs.aac import subband_info
    from ..core.io import MediaSourceStream
    from ..formats.adts import AdtsReader

    data = _gen_adts()
    r = AdtsReader(MediaSourceStream(data))
    pkts = []
    while True:
        p = r.next_packet()
        if p is None:
            break
        pkts.append(bytes(p.data))
    buf = b"".join(pkts)
    sizes = np.array([len(p) for p in pkts], np.int64)
    offs = np.zeros(len(pkts), np.int64)
    np.cumsum(sizes[:-1], out=offs[1:])
    ri, bl, bs = subband_info(44100)
    audio = len(pkts) * 1024 / 44100
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = native.aac_extract(buf, offs, sizes, ri, bl, bs, 2)
        best = min(best, time.perf_counter() - t0)
        if not (out["status"] == 0).all():
            raise RuntimeError("aac_host: extraction failed")
    return audio, best


def aac_device_inputs(n_frames: int = 8192) -> dict:
    """``bench.py``'s AAC device inputs: the host handoff's int16 quants and
    64 scales a frame, every lane ONLY_LONG with window shape 0 and handed
    off for dequantization (``deq`` 0), none a sequence start."""
    rng = np.random.default_rng(2)
    qbuf = rng.integers(-60, 61, size=(n_frames, 1024)).astype(np.int16)
    scales = np.abs(rng.standard_normal((n_frames, 64)) * 0.01).astype(
        np.float32)
    zeros = np.zeros(n_frames, np.int32)
    return {"qbuf": qbuf, "scales": scales, "deq": zeros,
            "coeffs": np.zeros((n_frames, 1024), np.float32),
            "seq": zeros, "shape": zeros, "prev_shape": zeros,
            "first": np.zeros(n_frames, bool)}


def aac_device_dense(dev: torch.device):
    from ..ops.aac_dense import AacDense, reference_tables

    return AacDense.from_numpy(reference_tables(), dev)


def aac_bands_long(rate: int = 44100):
    """The long-window scale-factor band edges of ``rate``: the same
    ``subband_info`` that gives ``bench.py``'s ``sfb_map``."""
    from ..codecs.aac import subband_info

    return subband_info(rate)[1]


def aac_device_call(dense, t: dict, bands_long) -> torch.Tensor:
    """One pass of the AAC device stage: A1 with its dequant prologue (the
    pow43 table times the band's scale), then A3 -> [n_frames, 1024]."""
    quant = dense.quant(t["qbuf"], t["scales"], t["deq"], bands_long)
    pcm = dense.imdct(t["coeffs"], quant)
    return dense.ola(pcm, t["seq"], t["shape"], t["prev_shape"], t["first"])


def bench_aac_device(n_frames: int = 8192, iters: int = 4, device="cuda"):
    """Device stage: dequantization of the host handoff's int16 quants
    (same pow43-table f32 multiply as the host, bit-identical) fused with
    the IMDCT (A1), then the batched window/OLA (A3)."""
    dev = resolve_device(device)
    dense = aac_device_dense(dev)
    bl = aac_bands_long()
    t = _to(dev, aac_device_inputs(n_frames))
    wall, first = _device_time(lambda: aac_device_call(dense, t, bl), dev,
                               iters)
    return n_frames * 1024 / 44100 * iters, wall, first


def vorbis_device_inputs(n_lanes: int = 8192, n: int = 2048) -> dict:
    """``bench.py``'s Vorbis device inputs: ``n_lanes`` long-block spectra
    of n/2 coefficients."""
    rng = np.random.default_rng(7)
    return {"x": rng.standard_normal((n_lanes, n // 2)).astype(np.float32)}


def vorbis_device_matrix(dev: torch.device, n: int = 2048) -> torch.Tensor:
    from ..codecs.vorbis import imdct_matrix

    return torch.from_numpy(np.ascontiguousarray(imdct_matrix(n))).to(dev)


def vorbis_device_call(t: dict, m: torch.Tensor) -> torch.Tensor:
    """One pass of the Vorbis device stage: V1 -> [n_lanes, n]."""
    from ..ops.vorbis_dense import vorbis_imdct

    return vorbis_imdct(t["x"], m)


def bench_vorbis_device(n_lanes: int = 8192, iters: int = 8, device="cuda"):
    """Device stage: the grouped long-block IMDCT ([L, n/2] -> [L, n]) that
    carries the Vorbis dense stage (``ops/vorbis_dense.py`` imdct_group;
    the lap stitch is host-side)."""
    n = 2048
    dev = resolve_device(device)
    m = vorbis_device_matrix(dev, n)
    t = _to(dev, vorbis_device_inputs(n_lanes, n))
    wall, first = _device_time(lambda: vorbis_device_call(t, m), dev, iters)
    # Each long-block lane laps into n/2 fresh output samples.
    return n_lanes * (n // 2) / 44100 * iters, wall, first


# ---------------------------------------------------------------------------
# Breadth codec stages: per-packet decode throughput for Vorbis / ALAC /
# ADPCM / Layer II. Reported in the stderr stage line only, NOT in the
# aggregate (defined over FLAC/MP3/AAC). These time the full open + decode
# AudioDecoder surface (probe, demux, native per-packet dispatch).
# ---------------------------------------------------------------------------


def _bench_stream_surface(data: bytes, repeats: int):
    """Best-of-N wall time of probe + per-packet decode of a whole stream."""
    import symphonia_tpu_torch as sym
    from ..core.io import MediaSourceStream

    best = float("inf")
    audio_s = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        mss = MediaSourceStream(data)
        fmt = sym.get_probe().probe(mss).format
        tr = fmt.default_track()
        dec = sym.get_codecs().make_audio_decoder(tr.codec_params)
        n = 0
        while True:
            pkt = fmt.next_packet()
            if pkt is None:
                break
            try:
                n += dec.decode(pkt).frames
            except sym.DecodeError:
                continue
        best = min(best, time.perf_counter() - t0)
        audio_s = n / (tr.codec_params.sample_rate or 1)
    return audio_s, best


@functools.lru_cache(maxsize=1)
def _gen_vorbis(seconds: int = STREAM_SECONDS) -> bytes:
    """An in-memory stereo 44.1 kHz Ogg Vorbis stream of ``seconds``, blocks
    of 256 and 2048, from a fixed seed."""
    from ..testing.vorbis_stream import build_vorbis

    return build_vorbis(44100, 8, 11, float(seconds), 20261016)


def bench_vorbis_host(repeats: int = 8):
    """Vorbis per-packet surface on an 8 s stereo stream."""
    return _bench_stream_surface(_gen_vorbis(), repeats)


def _gen_alac(seconds: int = 8):
    from ..testing import alac_builder as ab

    path = CACHE / f"bench_{seconds}s_alac.pkl"
    n = 44100 * seconds
    if path.exists():
        frames = pickle.loads(path.read_bytes())
    else:
        CACHE.mkdir(exist_ok=True)
        rng = np.random.default_rng(3)
        chans = [np.clip(np.cumsum(rng.integers(-300, 301, size=n)), -30000,
                         30000).astype(np.int64) for _ in range(2)]
        cookie = dict(frame_length=4096, bit_depth=16, pb=40, mb=10, kb=14)
        frames = []
        for i in range(0, n - 4095, 4096):
            seg = [c[i : i + 4096] for c in chans]
            frames.append(ab.encode_frame_compressed(seg, cookie, order=4))
        path.write_bytes(pickle.dumps(frames))
    return frames, ab.build_cookie(4096, 16, 2, 44100), len(frames) * 4096


def bench_alac_host(repeats: int = 8):
    """ALAC per-packet decode (native/alac_decode.cpp path)."""
    from ..codecs.alac import AlacDecoder
    from ..core.audio import Channels
    from ..core.codecs import AudioCodecParameters
    from ..core.packet import Packet

    frames, cookie_bytes, n = _gen_alac()
    params = AudioCodecParameters(
        codec="alac", sample_rate=44100, bits_per_sample=16,
        channels=Channels.from_count(2), extra_data=cookie_bytes)
    pkts = [Packet(track_id=0, ts=i * 4096, dur=4096, data=f)
            for i, f in enumerate(frames)]
    best = float("inf")
    for _ in range(repeats):
        dec = AlacDecoder(params)
        t0 = time.perf_counter()
        for p in pkts:
            dec.decode(p)
        best = min(best, time.perf_counter() - t0)
    return n / 44100.0, best


def bench_adpcm_host(repeats: int = 8):
    """IMA-WAV ADPCM per-packet surface (native/adpcm_loops.cpp path)."""
    from ..testing.adpcm_builder import (ima_encode, make_adpcm_wav,
                                         smooth_signal)

    n = 22050 * 8
    sig = smooth_signal(n, 11)
    payload, ba = ima_encode(sig)
    wav = make_adpcm_wav(payload, 0x11, ba, 505, n)
    return _bench_stream_surface(wav, repeats)


def bench_l2_host(repeats: int = 8):
    """MPEG-1 Layer II per-packet surface (native/mpa_layer12.cpp path)."""
    path = CACHE / "bench_l2.mp2"
    if not path.exists():
        from ..codecs.mpa_layer12 import QUANT_CLASS, SB_INFO, SB_QUANT_INFO
        from ..testing.mpa_l12_builder import build_l2_frame

        CACHE.mkdir(exist_ok=True)
        rng = np.random.default_rng(5)
        frames = []
        for _ in range(300):  # ~7.8 s at 44.1 kHz (match the other stages)
            alloc = [int(rng.integers(1, 4)) for _ in range(27)] + [0, 0, 0]
            sf0 = [int(rng.integers(0, 60)) for _ in range(30)]
            samples = {}
            sblimit, rows = SB_INFO[1]
            for sb in range(sblimit):
                ci = alloc[sb]
                if not ci:
                    continue
                c, d, grouping, bits, nlevels = QUANT_CLASS[
                    SB_QUANT_INFO[rows[sb]][1][ci]]
                for gr in range(12):
                    if grouping:
                        samples[(sb, gr)] = int(rng.integers(0, nlevels ** 3))
                    else:
                        samples[(sb, gr)] = [int(rng.integers(0, nlevels))
                                             for _ in range(3)]
            frames.append(build_l2_frame(alloc, sf0, samples)[0])
        path.write_bytes(b"".join(frames))
    return _bench_stream_surface(path.read_bytes(), repeats)


def stand_in_cost(mp3: bytes, ogg: bytes, passes: int = 5,
                  repeats: int = 8) -> dict:
    """Realtime x of the MP3 host stage and the Vorbis breadth stage on
    ``mp3`` and ``ogg`` (``bench.py``'s inputs, ``house_lo.mp3`` and
    ``house_lo.ogg``, where a machine has them) and on this bench's
    in-memory stand-ins, each the best of ``passes`` interleaved passes of
    ``repeats`` calls; and each stand-in's figure over its file's
    (``*_ratio``). A ratio above 1 says the stand-in makes the stage, and
    with ``mp3_host`` the aggregate, read faster than ``bench.py``'s input
    would. Host only: the card is not used."""
    runs = {"mp3_file": lambda: _mp3_host(mp3, repeats),
            "mp3_stand_in": lambda: _mp3_host(_gen_mp3(), repeats),
            "vorbis_file": lambda: _bench_stream_surface(ogg, repeats),
            "vorbis_stand_in": lambda: _bench_stream_surface(_gen_vorbis(),
                                                             repeats)}
    best = {k: (0.0, float("inf")) for k in runs}
    for _ in range(passes):
        for k, fn in runs.items():
            audio, wall = fn()
            if wall < best[k][1]:
                best[k] = (audio, wall)
    out = {k: audio / wall for k, (audio, wall) in best.items()}
    out["audio_s"] = {k: audio for k, (audio, _) in best.items()}
    for codec in ("mp3", "vorbis"):
        out[f"{codec}_ratio"] = (out[f"{codec}_stand_in"]
                                 / out[f"{codec}_file"])
    return out


# ---------------------------------------------------------------------------
# The aggregate and the run
# ---------------------------------------------------------------------------

HEADLINE = ("flac", "mp3", "aac")


def aggregate(stages: dict):
    """(pipelined, rtx): min(host, device) realtime x per headline codec,
    and their harmonic mean over an equal-audio-share workload of the
    three. A stage at 0 makes the aggregate 0 (reporting the max of the
    survivors would inflate it)."""
    pipelined = {
        codec: min(stages[f"{codec}_host"], stages[f"{codec}_device"])
        for codec in HEADLINE
    }
    if all(v > 0 for v in pipelined.values()):
        rtx = len(pipelined) / sum(1.0 / v for v in pipelined.values())
    else:
        rtx = 0.0
    return pipelined, rtx


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    CPU's name when the run is on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main(*, device="cuda", passes: int = 20, min_passes: int = 5,
         sizes: dict | None = None) -> dict:
    """Run every stage, print the stage line, the pipelined line, the card
    and the JSON line, and return ``stages``, ``pipelined``, ``value``,
    ``first_call_s`` (each device stage's warm-up call), ``card`` and
    ``line`` (the JSON line's object).

    The pass counts are ``bench.py``'s by default: host passes adaptive (at
    least ``min_passes``, at most ``passes``; they stop once four passes in
    a row improved no stage by 1%), four passes of the breadth stages, then
    after the device stages a late re-sample of the host stages (at most
    ten) and three breadth passes. Each of the last three counts is also
    at most ``passes``, so that ``passes`` alone shortens a run. ``sizes``
    maps a device stage's name to keyword arguments of its function (lane
    counts, ``iters``)."""
    dev = resolve_device(device)
    sizes = sizes or {}
    mod = sys.modules[__name__]
    stages, first_call = {}, {}
    host_stages = [(name, getattr(mod, f"bench_{name}"))
                   for name in ("flac_host", "mp3_host", "aac_host")]
    device_stages = [(name, getattr(mod, f"bench_{name}"))
                     for name in ("flac_device", "mp3_device", "aac_device",
                                  "vorbis_device")]
    # Interleaved multi-pass sampling: a shared host's noise comes in
    # multi-second bursts, so a single best-of-N burst can land entirely
    # inside a noisy phase. Spreading passes over time and taking the
    # global best recovers the steady-state number (still plain best-of-N
    # wall time, just sampled wider).
    best = {name: (0.0, float("inf")) for name, _ in host_stages}

    def _sample_host(passes, min_passes, stale_cap):
        stale = 0
        for _pass in range(passes):
            improved = False
            for name, fn in host_stages:
                audio, wall = fn(repeats=12)
                if wall < best[name][1] * 0.99:
                    improved = True
                if wall < best[name][1]:
                    best[name] = (audio, wall)
            stale = 0 if improved else stale + 1
            if _pass >= min_passes - 1 and stale >= stale_cap:
                break
            if _pass < passes - 1:
                time.sleep(2.5)

    def _host_stage_results():
        for name, _fn in host_stages:
            audio, wall = best[name]
            stages[name] = audio / wall if wall > 0 and audio else 0.0

    _sample_host(passes, min_passes, stale_cap=4)
    _host_stage_results()
    # Breadth stages: stderr-visible only, a few passes, the global best.
    breadth = [(name, getattr(mod, f"bench_{name}"))
               for name in ("vorbis_host", "alac_host", "adpcm_host",
                            "l2_host")]
    bbest = {name: (0.0, float("inf")) for name, _ in breadth}

    def _sample_breadth(n_passes, pause):
        for _pass in range(n_passes):
            for name, fn in breadth:
                audio, wall = fn()
                if wall < bbest[name][1]:
                    bbest[name] = (audio, wall)
            if pause and _pass < n_passes - 1:
                time.sleep(pause)

    def _breadth_stage_results():
        for name, _fn in breadth:
            audio, wall = bbest[name]
            stages[name] = audio / wall if wall > 0 and audio else 0.0

    _sample_breadth(min(4, passes), 2.0)
    _breadth_stage_results()
    for name, fn in device_stages:
        audio, wall, first_call[name] = fn(device=dev, **sizes.get(name, {}))
        stages[name] = audio / wall if wall > 0 else 0.0
    # Late host re-sample: a capture that started inside a noise burst gets
    # a second, time-separated shot at a quiet window. Best-of merging
    # means these passes can only improve the numbers.
    _sample_host(min(10, passes), min_passes=2, stale_cap=3)
    _host_stage_results()
    _sample_breadth(min(3, passes), 0.0)
    _breadth_stage_results()

    pipelined, rtx = aggregate(stages)
    print("device stages' first calls (s, the kernels' build included): "
          + str({k: round(v, 3) for k, v in first_call.items()}),
          file=sys.stderr)
    print("stage realtime-x: "
          + str({k: round(v, 1) for k, v in stages.items()}), file=sys.stderr)
    print("pipelined: "
          + ", ".join(f"{k} {v:.0f}x" for k, v in pipelined.items()),
          file=sys.stderr)
    card = card_line(dev)
    print(f"card: {card}", flush=True)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")
    line = {
        "metric": f"aggregate sustained decode realtime-x on one {name}, "
                  "host entropy pipelined with device dense stage "
                  "(FLAC bit-exact int-LPC + MP3 Layer III + AAC-LC)",
        "value": round(rtx, 1),
        "unit": "x realtime",
        "vs_baseline": None,
    }
    print(json.dumps(line), flush=True)
    return {"stages": stages, "pipelined": pipelined, "value": rtx,
            "first_call_s": first_call, "card": card, "line": line}


if __name__ == "__main__":
    main()
