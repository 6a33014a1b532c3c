#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (symphonia_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. environment: CUDA card, native host library, nvcc build of csrc/*.cu;
  2. each kernel (F1 flac_lpc with its helper, F2 flac_decorrelate,
     M1 mp3_hybrid, M2 mp3_synth, A1 aac_imdct, A2 aac_dequant, A3 aac_ola, V1
     vorbis_imdct, L1 mpa_l12_synth, V2 vorbis_lap, P1 pcm_unpack) against
     its plain PyTorch twin on the card at the main path's shapes, with
     CUDA-event times for both; the MP3 dense stage against the reference's
     numpy oracle on a small input, and chained over two calls against one
     call; M1 (a warp a run of granules, the product blocked in registers)
     also where its runs end (G = 1, 2, 3 and off a multiple of the run, C =
     1, boundaries at g = 0 and at a run's first and last granule, a block
     type with no matrix), equal bit for bit at every run length, with its
     device time by run length at three sizes, its registers, spills and
     blocks per SM; A3 (a block a lane, four samples a thread) bit for bit
     at 1, 2, 3 and 257 lanes with sequence starts everywhere, nowhere and
     at random and with every lane EIGHT_SHORT, its registers, spills and
     blocks per SM; A1 and V1 (half of each IMDCT product, mirrored in the
     epilogue) with a +0.0 and a -0.0 input row whose outputs must all be
     +0.0, bit for bit against their dense twins (A1 long, with and without
     its prologue, and short, V1 n = 2048; the other V1 sizes reported),
     beside cuBLAS on the dense and on the half product, with both bounds
     and the tile's registers, spills and blocks per SM; M2 and L1 (the
     factored polyphase synthesis) within 2e-5 of their twins and of the
     numpy oracle, with the error relative to the peak, chained calls
     within 1e-6 of one call (bit-equality reported), beside cuBLAS on the
     reference's dense product, with the factored and the dense bound and
     the kernel's registers, spills and blocks per SM; A1 through a row
     map (a random permutation of the lanes, n_rows at 3/4 of them and at
     0, long with its prologue at [16384, 1024] and short at [8192, 128])
     bit for bit against A1 on the same lanes gathered, every other output
     row untouched, timed beside A1 on as many contiguous rows; A2 bit for bit
     against ``native.aac_dequant_host``, A3 against the reference's
     sequential ``window_ola_chain``; V1 at both ends of the Vorbis block
     sizes (64 and 8192); L1 for Layer I and II, chained over
     calls (Layer I chunks of 1 and 2 frames included) against one call,
     and against the reference's numpy polyphase; V2 vorbis_lap bit for bit
     at [16384, 2048] and [4096, 64]; F1 bit for bit on dense random
     coefficients, on two packer-shaped draws (coefficients zero beyond
     the order: the entry step's orders 0-12, and a mix of LPC-12, LPC-32,
     fixed-2 and verbatim lanes like phase 3's) and on a ragged shape (L =
     8229, n = 4107, rows 16 wider, every tap count) with a lane's taps
     on 2 and 4 threads, its helper flac_lane_order (tap counts and
     the lane order) against the plain tensor functions, its bound the
     larger of bytes and the taps' integer multiply-adds at the rate a
     micro-kernel measures in this run,
     with its registers, spills and blocks per SM; P1 bit for bit at
     [16384, 16384] for each of its 18 codecs and at shapes that leave its
     vector path (rows off the load's alignment, a view at storage offset
     1, one row, rows shorter than a group, every byte value), with its
     registers, spills and blocks per SM; beside each kernel's time, the
     least time the card could take for its work (``bound_ms``) and, where
     one PyTorch call computes the same function, that call's time
     (``library_ms``);
  3. the slice: ``symphonia_tpu_torch.batch.decode_many`` on a mixed
     FLAC + MP3 Layer III + AAC-LC + Ogg Vorbis + MPEG Layer I/II batch
     with per-packet entries (PCM in WAV, AIFF, CAF and MP4, IMA and MS
     ADPCM, ALAC in CAF, FLAC in Matroska), built from a fixed seed with the
     repo's test encoders, on the card by default: FLAC bit-exact to the
     source with STREAMINFO MD5 verified, MP3, AAC, Vorbis and Layer I/II
     against the port's CPU-twin path, the lossless per-packet entries bit
     for bit against their sources and ADPCM within 1% of its source's
     RMS, no host route, ``packet_routes`` equal to the per-packet
     entries, every kernel of the path launched, V1 for each of the four
     Vorbis block sizes and L1 for Layer I and II (A2 is not on the decode
     path, as in the reference, and is checked in phase 2 only);
  4. ``pcm_batch``, P1's path: the PCM entries of phase 3 demuxed with the
     port's readers, each codec's packets padded into one [B, max_bytes]
     uint8 batch and unpacked by ``ops.pcm.decode_pcm_batch`` on the card,
     then de-interleaved and trimmed per packet: bit for bit against
     ``decode_pcm_np`` packet by packet, against the twin, and against the
     sources;
  5. ``rice_bench``, R1's path: ``symphonia_tpu_torch.tools.
     bench_rice_device.main()`` at its defaults (8192 lanes of 4096
     symbols, k = 4), then R1 (a register bit reader a lane, stores staged
     a warp's tile at a time) bit for bit against its twin on the card
     (residuals and end cursors), the encoded values and the reference's
     scalar oracle on a few lanes, at that shape and at FLAC partitions
     ([131072, 256], k 0..14 by lane), each with its device, back-to-back
     and enqueue times and its bound; the reader's edge cases (cursors
     anywhere in a word, into the last word, past 32 W, near 2^32, runs of
     zeros, k = 0, 1, 30, 31 and outside 0..31, n = 0, 1, 33, 95, B = 1,
     31, 33) with the words at storage offsets 0-3; its registers, spills
     and blocks per SM;
  6. the entry step: ``symphonia_tpu_torch.entry.decode_step`` (the
     reference's combined four-codec step, K14) on the card at full width
     (8192 FLAC frames of 4096 samples, 4096 stereo MP3 granules, 16384 AAC
     frames, 16384 Vorbis blocks of 2048) under
     ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises)
     against ``decode_step_plain`` on the card: FLAC, AAC and Vorbis bit
     for bit, MP3 within 1e-5, F1 and its helper, F2, M1, M2, A1, A2, A3,
     V1 and V2 launched; ``entry.capture_step``'s CUDA graph (the four
     codec stages as four branches) and the step captured on one stream,
     each replay bit for bit against the eager step, the graph's launches
     those of an eager step; the eager and both replays' times in turns,
     each stage's, the kernels' summed device time (``torch.profiler``),
     the bound and its share of the replay; then a small step with
     EIGHT_SHORT handoff lanes, in which A2 dequantizes them;
  7. ``bench``: ``symphonia_tpu_torch.tools.bench.main()`` at the bench's
     stage sizes with fewer host passes: its eleven stages and the
     pipelined aggregate above 0, every kernel of its device stages
     launched, its stage line and JSON line printed; then each device
     stage's first output against its plain twin on the card at the same
     shapes (FLAC bit for bit at 16384 lanes of 4096 with dense order-8
     coefficients, MP3 within 2e-5, AAC within 1e-5 with A1's dequant
     prologue bit for bit, Vorbis within 1e-5);
  8. ``soak``: ``symphonia_tpu_torch.tools.soak.main`` for 30 s from the
     run's seed on the card (any exception outside the error taxonomy, a
     native crash or a CUDA error fails it), F1, F2, M1, M2, A1, A3 and V1
     launched; the first 24 inputs that decoded, decoded again on the CPU
     (integer samples bit for bit, float within 2e-5 x max(1, peak)); and
     the soak's edge inputs (one FLAC frame, one MP3 frame or none, one AAC
     lane, a few Vorbis packets, each also cut short) alone and merged,
     card against CPU;
  9. ``multichip``: ``symphonia_tpu_torch.entry.dryrun_multichip``, the
     combined step sharded over a (dp, tp) mesh of ranks (one process
     each, ``torch.distributed``), with the halos where the step couples
     lanes: one rank under NCCL at phase 6's full width, eight gloo ranks
     sharing the card at the reference's sizes (dp = 4, tp = 2), four at
     full width (dp = 2, tp = 2) and six (dp = 3, lanes that 3 does not
     divide); each held to the unsharded step on the card (FLAC bit for
     bit, MP3, AAC and Vorbis within 1e-5, bit-equality printed) and to
     the plain twins' step on the card on the same inputs (FLAC and Vorbis
     bit for bit, MP3 and AAC within 1e-5: cuBLAS, the plain AAC product,
     sums in an order that depends on the row count, which the phase
     shows at the reference's sizes), with each rank's copy of its
     lanes to the card and its step (CUDA events) and its gather time
     beside the card's name and power limit, F1 and its helper, F2, M1,
     M2, A1, A2, A3, V1 and V2 launched (summed over ranks);
 10. ``golden``: the reference's golden PCM anchor (``tests/golden_pcm.npz``)
     on the card: its corpus, built by ``testing.golden_corpus``, decoded
     by ``decode_many`` on the card (run after phase 3), integer entries
     bit-exact and float entries within 1e-5, pygame's two real-media
     files decoded where they exist and named as absent where not;
 11. ``md5``: F3 ``flac_md5`` against ``hashlib`` for every stream at the
     FLAC bulk cell's shape (128 mono 16-bit streams of the LibriSpeech
     pool's lengths, 6,410 frames of 4,096) and on stereo 24-bit streams
     of varying block size, trimmed and split over three lane chunks; its
     time beside its chain bound (the longest stream's blocks x 64 steps
     at the step latency this run measures), its
     registers, spills and launches; the host path (``_flac_md5_ok``) over
     the same 128 streams, one F3 chain alone, and their rates' ratio, the
     rule's ``MD5_HOST_PER_CHAIN``;
 12. ``mp3_entropy``: M0 against ``native.mp3_extract`` on a seeded pool
     of 64 clips of the fma_mp3 configuration (the benchmark's generator)
     and on the test encoders' streams (``testing/mp3_entropy_streams``:
     MPEG-1, 2 and 2.5, intensity stereo, CRC, linbits tables, mixed-block
     flags, a reservoir underflow at the start, flipped bits), each alone
     and all in one launch: statuses, block types and mixed flags equal,
     spectra bit for bit; its time at the fma_mp3.shard32 request's shape
     (32 clips, 36,800 frames) beside its bytes bound and the native
     extraction of the same clips, its registers, local memory and
     ptxas's report of its stack and spills;
 13. ``mp3_place``: M3 at the fma_mp3.shard32 request's shape (32 stereo
     clips of 2,300 granules, 73,600 in all, in chunks of 4,096, trims at
     every delay mod 4) bit for bit against its twin on the card and the
     host's concatenate, transpose and trim of the same PCM; its time for
     the request's 18 launches (CUDA events, and replayed in a graph)
     beside its bytes bound, its registers, local memory, blocks per SM
     and ptxas's report;
 14. ``mp3_speech``: the MP3 path at the commonvoice_mp3.online request
     (one 48 kHz mono 64 kbit/s clip near the pool's mean of ~5 s, ~212
     frames of 192 bytes, the reservoir reaching back over several
     frames): M0 over a 16-clip pool and over the request against
     ``native.mp3_extract`` bit for bit; on its output M1 and M2 at C = 1
     in one chunk against their twins, M3 against its twin and the host
     layout bit for bit, the chain's clip against ``decode_many``'s bit
     for bit; each kernel's time beside its bound, M1 at every run length;
 15. ``mpa_walk``: the frame-table walk on the host (no kernel) over a
     fma_mp3.shard32 request's 32 clips and a 16-clip commonvoice_mp3
     pool: the verbatim ``MpaReader`` and ``mpa_walk.MpaReader`` built,
     the ``MediaSourceStream`` read and the compiled walk alone, in ms a
     clip, and both readers' frame tables equal;
 16. ``musdb_flac``: the stereo FLAC path at the musdb_flac.tracks8
     request (8 tracks of 200-312 s at 44.1 kHz, two at 24 bits):
     ``decode_many(verify=True)`` equal to the source sample for sample,
     every MD5 verified; the request timed with its MD5 placed by the
     rule, on the card and on the host; F2 bit-equal to its twin at
     [4096, 2, 4096]; F3 at two channels, 2 and 3 bytes a sample, across
     lane chunks, against hashlib.
Launch counts are read per path (each run from counts of 0): every kernel
of a path must launch on it, and every kernel on some path. The line
before the last is a JSON object of per-kernel results; the last is
``{"ok": true, "device": {...}}``. Exits non-zero and prints no result
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SR = 44100
FLAC_SECONDS = 10
MP3_FRAMES = 1149  # 30 s of MPEG-1 Layer III at 44.1 kHz (1152 per frame)
N_FLAC_ENTRIES = 64

# (stereo mode, subframe kind, bits per sample, builder keyword arguments)
FLAC_SPECS = [
    ("independent", "lpc", 16, dict(order=12)),
    ("left_side", "lpc", 16, dict(order=32)),
    ("right_side", "fixed", 16, dict(order=2, wasted=3)),
    ("mid_side", "verbatim", 16, dict()),
    ("mid_side", "lpc", 24, dict(order=8)),
]
MP3_SPECS = [(2, s) for s in range(16)] + [(1, 100), (1, 101)]
AAC_SECONDS = 30
AAC_CYCLE = (0, 0, 0, 1, 2, 3)  # ONLY_LONG x3, LONG_START, EIGHT_SHORT, STOP
# (sample rate, content, seed): stereo CPE streams cycling the window
# sequences with random window shapes; one at 48 kHz, which shares the
# 44.1 kHz scalefactor bands and so their dispatch; one at 24 kHz, a
# second bands_long group and dispatch; one with intensity bands in
# channel 1, whose lanes the host dequantizes (deq = 1) beside channel 0's
# handoff lanes.
AAC_SPECS = ([(44100, "cycle", s) for s in range(6)]
             + [(48000, "cycle", 6), (44100, "intensity", 7),
                (24000, "cycle", 8)])
VORBIS_SECONDS = 30
# (sample rate, short and long block exponents, seed): stereo streams with
# blocks of 256/2048 (libvorbis's usual pair at 44.1 kHz) and one at 48 kHz
# with 512/4096, so the batch has four IMDCT block-size groups.
VORBIS_SPECS = [(44100, 8, 11, s) for s in range(6)] + [(48000, 9, 12, 6)]
# (kind, frames, seed): stereo 30 s streams of MPEG-1 Layer II (1152
# samples a frame at 44.1 kHz), MPEG-1 Layer I (384) and MPEG-2 LSF Layer
# II (1152 at 22.05 kHz).
MPA_L12_SPECS = ([("l2", 1149, s) for s in range(4)]
                 + [("l1", 3445, 4), ("l1", 3445, 5), ("l2_lsf", 574, 6)])
# The per-packet entries (kind, seed): PACKET_SECONDS each, 44.1 kHz stereo
# for PCM in WAV (16-, 24-, 8-, 32-bit and float), AIFF (16-bit big
# endian), CAF (16-bit) and MP4 (QuickTime ``sowt``); 22.05 kHz mono IMA
# and MS ADPCM in WAV; 44.1 kHz mono ALAC in CAF; 44.1 kHz stereo FLAC in
# Matroska (FLAC_SECONDS); CAF_SECONDS of CAF.
PACKET_SECONDS = 30
# The CAF reader gives one packet a frame, as the reference's does: 1 s.
CAF_SECONDS = 1
PACKET_SPECS = [("wav_s16", 0), ("wav_s16", 1), ("wav_s24", 2),
                ("wav_u8", 3), ("wav_s32", 4), ("wav_f32", 5),
                ("aiff_s16be", 6), ("caf_lpcm", 7), ("ima_adpcm", 8),
                ("ms_adpcm", 9), ("alac_caf", 10), ("flac_mkv", 11),
                ("pcm_mp4", 12)]
LOSSY_PACKET = ("ima_adpcm", "ms_adpcm")
# P1's full width ([B, N] bytes) and R1's (the bench tool's defaults).
PCM_SIZE = (16384, 16384)
RICE_SIZE = dict(B=8192, n=4096, k=4)
# R1's second shape, as many Rice partitions as phase 6's 8192 FLAC frames
# of 4096 samples give at partition order 4 (k 0..14 by lane).
RICE_MIXED_SIZE = dict(B=131072, n=256)

# Kernel -> (route, source, the TPU program it replaces)
KERNEL_INFO = {
    # F1's helper: the tap count and lane order that the recurrence of
    # :44 does without (it multiplies all 32 coefficients for every lane).
    "flac_lane_order": ("cuda", "symphonia_tpu_torch/csrc/flac_dense.cu",
                        "symphonia_tpu/ops/flac_dense.py:44"),
    "flac_lpc": ("cuda", "symphonia_tpu_torch/csrc/flac_dense.cu",
                 "symphonia_tpu/ops/flac_dense.py:44"),
    "flac_decorrelate": ("cuda", "symphonia_tpu_torch/csrc/flac_dense.cu",
                         "symphonia_tpu/ops/flac_dense.py:84"),
    # F3 replaces no device program: the reference hashes on the host.
    "flac_md5": ("cuda", "symphonia_tpu_torch/csrc/flac_dense.cu",
                 "none (symphonia_tpu/batch.py:_flac_md5_ok, host)"),
    # M0 replaces no device program: the reference extracts Layer III on
    # the host.
    "mp3_entropy": ("cuda", "symphonia_tpu_torch/csrc/mp3_entropy.cu",
                    "none (native/mp3_entropy.cpp sh_mp3_extract, host)"),
    "mp3_hybrid": ("cuda", "symphonia_tpu_torch/csrc/mp3_dense.cu",
                   "symphonia_tpu/ops/mp3_dense.py:346"),
    "mp3_synth": ("cuda", "symphonia_tpu_torch/csrc/mp3_dense.cu",
                  "symphonia_tpu/ops/mp3_dense.py:346"),
    # M3 replaces no device program: the reference concatenates, transposes
    # and trims Layer III PCM on the host.
    "mp3_place": ("cuda", "symphonia_tpu_torch/csrc/mp3_place.cu",
                  "none (symphonia_tpu/batch.py, host stitch)"),
    # A1 replaces K6 (:87, prologue on) and K7 (:112, prologue off).
    "aac_imdct": ("cuda", "symphonia_tpu_torch/csrc/aac_dense.cu",
                  "symphonia_tpu/ops/aac_dense.py:87"),
    "aac_dequant": ("cuda", "symphonia_tpu_torch/csrc/aac_dense.cu",
                    "symphonia_tpu/ops/aac_dense.py:51"),
    "aac_ola": ("cuda", "symphonia_tpu_torch/csrc/aac_dense.cu",
                "symphonia_tpu/ops/aac_dense.py:209"),
    "vorbis_imdct": ("cuda", "symphonia_tpu_torch/csrc/vorbis_dense.cu",
                     "symphonia_tpu/ops/vorbis_dense.py:21"),
    "mpa_l12_synth": ("cuda", "symphonia_tpu_torch/csrc/mp3_dense.cu",
                      "symphonia_tpu/ops/mp3_dense.py:273"),
    # V2 replaces the Vorbis lap of the combined decode step (K14, lines
    # 117-121 of the program at :62).
    "vorbis_lap": ("cuda", "symphonia_tpu_torch/csrc/vorbis_dense.cu",
                   "__graft_entry__.py:62"),
    # P1 replaces K12 (decode_pcm_batch_jax and its _combine_bytes_int,
    # :174); R1 replaces K13.
    "pcm_unpack": ("cuda", "symphonia_tpu_torch/csrc/pcm.cu",
                   "symphonia_tpu/ops/pcm.py:197"),
    "rice_decode": ("cuda", "symphonia_tpu_torch/csrc/rice_device.cu",
                    "symphonia_tpu/ops/rice_device.py:40"),
}
# Kernels that decode_many does not run (K9 serves dequant_select and the
# entry step's short lanes; V2 is the entry step's lap; P1 and R1 have
# their own paths, as in the reference): not required in phase 3.
OFF_PATH = ("aac_dequant", "vorbis_lap", "pcm_unpack", "rice_decode")
# The entry step's kernels (phase 6); A2 resolves the short lanes' handoff
# on the card in every step (no host test decides whether it runs).
STEP_PATH = ("flac_lane_order", "flac_lpc", "flac_decorrelate", "mp3_hybrid",
             "mp3_synth", "aac_imdct", "aac_dequant", "aac_ola",
             "vorbis_imdct", "vorbis_lap")
# Phase 10's path (decode_many on the golden corpus): every kernel of
# decode_many but V1, whose entry (house_lo.ogg) may be absent.
GOLDEN_PATH = ("flac_lane_order", "flac_lpc", "flac_decorrelate",
               "mp3_entropy", "mp3_hybrid", "mp3_synth", "mp3_place",
               "aac_imdct", "aac_ola", "mpa_l12_synth")
# Phase 6's full width: FLAC frames, samples, MP3 granules, AAC frames,
# Vorbis blocks and block size.
STEP_SIZE = dict(F=8192, N=4096, G=4096, A=16384, V=16384, n1=2048)

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device memory and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def _paths() -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def _lpc_coefs(order: int, seed: int):
    """Coefficients the encoder can code (15-bit precision, shift 12) that
    predict a smooth signal well: x[n-1] plus a zero-sum perturbation over
    the remaining taps, the last tap nonzero."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 41, size=order - 1) * rng.choice([-1, 1], order - 1)
    d[0] -= d.sum()
    return [4096] + [int(v) for v in d]


def build_flac(i: int):
    """One FLAC test stream -> (bytes, planar int64 source samples)."""
    _paths()
    from symphonia_tpu_torch.testing.flac_builder import (build_flac_file,
                                                          random_walk)

    mode, kind, bps, kw = FLAC_SPECS[i]
    n = SR * FLAC_SECONDS
    if kw.get("wasted"):
        w = kw["wasted"]
        chans = [c << w for c in random_walk(n, bps - w, seed=SEED + i, ch=2)]
        args = dict(kind=kind, order=kw["order"], wasted=w)
    else:
        chans = random_walk(n, bps, seed=SEED + i, ch=2)
        args = dict(kind=kind)
        if kind == "lpc":
            args.update(lpc_coefs=_lpc_coefs(kw["order"], SEED + i),
                        lpc_shift=12, lpc_precision=15)
        elif kind == "fixed":
            args.update(order=kw["order"])
    data = build_flac_file(chans, sample_rate=SR, bps=bps, block_size=4096,
                           stereo_mode=mode, **args)
    return data, np.stack(chans)


def build_mp3(i: int) -> bytes:
    _paths()
    from symphonia_tpu_torch.testing.mp3_builder import build_mpeg1_l3_stream

    n_ch, seed = MP3_SPECS[i]
    return build_mpeg1_l3_stream(MP3_FRAMES, n_ch=n_ch, seed=SEED + seed)


def build_aac(i: int) -> bytes:
    _paths()
    from symphonia_tpu_torch.testing.aac_builder import (
        build_adts, build_raw_block, random_quant_spectrum)

    rate, content, seed = AAC_SPECS[i]
    rng = np.random.default_rng(SEED + 200 + seed)
    frames = []
    for f in range(AAC_SECONDS * rate // 1024):
        if content == "intensity":  # aac_builder sets IS bands on long windows
            quants = [random_quant_spectrum(rng, 40, rate) for _ in range(2)]
            frames.append(build_raw_block(quants, [0, 0], 40, 140, rate,
                                          special_books1={5: 14}))
            continue
        seq = AAC_CYCLE[f % len(AAC_CYCLE)]
        max_sfb = 12 if seq == 2 else 40
        quants = [random_quant_spectrum(rng, max_sfb, rate, seq)
                  for _ in range(2)]
        frames.append(build_raw_block(quants, [seq, seq], max_sfb, 140, rate,
                                      shape=int(rng.integers(0, 2))))
    return build_adts(frames, rate, 2)


def build_mpa_l12(kind: str, frames: int, seed: int) -> bytes:
    """A stereo Layer I or II stream of ``frames`` frames from the repo's
    Layer I/II test builders (``tests/test_layer12.py``): random allocations,
    scalefactors and samples per frame."""
    _paths()
    from symphonia_tpu_torch.testing.mpa_l12_builder import (_rand_l2_frame,
                                                             build_l1_frame)

    rng = np.random.default_rng(seed)
    out = []
    for f in range(frames):
        if kind == "l1":
            # Twelve coded subbands a channel keep a stereo frame in size.
            allocs = [[int(rng.choice([0, 2, 4, 8, 15])) if sb < 12 else 0
                       for sb in range(32)] for _ in range(2)]
            raws = [[[int(rng.integers(0, 1 << a)) if a else 0
                      for _ in range(12)] for a in ch] for ch in allocs]
            sfi = [[int(rng.integers(0, 60)) for _ in range(32)]
                   for _ in range(2)]
            out.append(build_l1_frame(raws, allocs, sfi, n_ch=2)[0])
        else:
            out.append(_rand_l2_frame(seed * 100003 + f, n_ch=2,
                                      mpeg2=kind == "l2_lsf")[0])
    return b"".join(out)


def _alac_caf(chans, frame_len: int, rate: int) -> bytes:
    """Mono ALAC (order-2 compressed frames) in CAF: desc, kuki, pakt and
    data chunks, as ``tests/test_golden_pcm.py``'s ALAC entry is built."""
    import struct

    from symphonia_tpu_torch.testing.alac_builder import (
        build_cookie, encode_frame_compressed)

    cookie = dict(frame_length=frame_len, bit_depth=16, pb=40, mb=10, kb=14)
    n = len(chans[0])
    frames = [encode_frame_compressed([chans[0][i : i + frame_len]], cookie,
                                      order=2)
              for i in range(0, n, frame_len)]
    desc = struct.pack(">d", float(rate)) + b"alac" + struct.pack(
        ">IIIII", 0, 0, frame_len, 1, 16)
    pakt = struct.pack(">qqii", len(frames), n, 0, 0)
    for f in frames:
        size, varint = len(f), bytearray()
        while True:
            varint.insert(0, size & 0x7F)
            size >>= 7
            if not size:
                break
        for i in range(len(varint) - 1):
            varint[i] |= 0x80
        pakt += bytes(varint)
    cookie_bytes = build_cookie(frame_len, 16, 1, rate)
    payload = b"".join(frames)
    return (b"caff" + struct.pack(">HH", 1, 0)
            + b"desc" + struct.pack(">q", len(desc)) + desc
            + b"kuki" + struct.pack(">q", len(cookie_bytes)) + cookie_bytes
            + b"pakt" + struct.pack(">q", len(pakt)) + pakt
            + b"data" + struct.pack(">q", len(payload) + 4)
            + struct.pack(">I", 0) + payload)


def _flac_mkv(chans, rate: int) -> bytes:
    """FLAC frames (fixed order 2, mid/side, blocks of 4096) in Matroska,
    one SimpleBlock a frame, a cluster every 64 frames."""
    _paths()
    from symphonia_tpu_torch.core.io import MediaSourceStream
    from symphonia_tpu_torch.formats.flac import FlacReader
    from symphonia_tpu_torch.testing.flac_builder import build_flac_file
    from symphonia_tpu_torch.testing.mkv_builder import build_mkv, simple_block

    flac = build_flac_file(chans, sample_rate=rate, bps=16, block_size=4096,
                           stereo_mode="mid_side", kind="fixed", order=2)
    reader = FlacReader(MediaSourceStream(flac))
    frames = []
    while (pkt := reader.next_packet()) is not None:
        frames.append(bytes(pkt.data))
    ms = [int(i * 4096 * 1000 / rate) for i in range(len(frames))]
    clusters = [(ms[i], [simple_block(1, ms[j] - ms[i], [frames[j]])
                         for j in range(i, min(i + 64, len(frames)))])
                for i in range(0, len(frames), 64)]
    return build_mkv("A_FLAC", flac[:42], clusters, rate=rate,
                     ch=len(chans), bit_depth=16)


def build_packet(kind: str, seed: int):
    """One per-packet entry of phase 3 -> (bytes, planar source samples)."""
    _paths()
    from symphonia_tpu_torch.testing import (adpcm_builder, aiff_caf_builder,
                                             mp4_builder, wav_builder)
    from symphonia_tpu_torch.testing.flac_builder import random_walk

    rng = np.random.default_rng(SEED + 500 + seed)
    n = SR * PACKET_SECONDS
    if kind in LOSSY_PACKET:
        rate = SR // 2
        sig = np.clip(np.cumsum(rng.integers(-400, 401, size=rate
                                             * PACKET_SECONDS)),
                      -30000, 30000).astype(np.int32)
        if kind == "ima_adpcm":
            payload, align = adpcm_builder.ima_encode(sig)
            data = adpcm_builder.make_adpcm_wav(payload, 0x11, align, 505,
                                                len(sig), rate=rate)
        else:
            payload, align = adpcm_builder.ms_encode(sig)
            data = adpcm_builder.make_adpcm_wav(payload, 0x02, align, 500,
                                                len(sig), rate=rate)
        return data, sig[None]
    if kind == "alac_caf":
        chans = random_walk(n, 16, seed=SEED + seed, ch=1)
        return _alac_caf(chans, 4096, SR), np.stack(chans)
    if kind == "flac_mkv":
        chans = random_walk(SR * FLAC_SECONDS, 16, seed=SEED + seed, ch=2)
        return _flac_mkv(chans, SR), np.stack(chans)
    if kind == "wav_f32":
        frames = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
        return wav_builder.make_wav(frames, rate=SR, fmt_tag=3), frames.T
    bits = {"wav_s24": 24, "wav_u8": 8, "wav_s32": 32}.get(kind, 16)
    frames = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, 2))
    if kind.startswith("wav"):
        data = wav_builder.make_wav(frames, rate=SR, bits=bits)
    elif kind == "aiff_s16be":
        data = aiff_caf_builder.make_aiff(frames, rate=SR)
    elif kind == "caf_lpcm":
        frames = frames[: SR * CAF_SECONDS]
        data = aiff_caf_builder.make_caf(frames, rate=SR)
    else:  # pcm_mp4
        data = mp4_builder.build_pcm_m4a(frames.T.astype(np.int16),
                                         fourcc=b"sowt", rate=SR,
                                         frames_per_chunk=4096)
    return data, frames.T


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def enqueue_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call to enqueue ``fn`` (no sync inside
    the loop): where it nears ``cuda_ms``, the host's launch cost, not the
    kernel, sets the measured time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call with the host's launch cost taken
    out: ``reps`` calls captured in one CUDA graph, its replay timed with
    CUDA events. Where ``cuda_ms`` nears ``enqueue_ms``, this is the
    kernel's own time."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, macs: float) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``macs``
    fp32 multiply-adds (two operations each): the larger of the two
    times at the published peaks, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * macs / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_int(nbytes: float, macs: float, macs_per_s: float) -> dict:
    """As :func:`bound` for 32 x 32 + 64-bit integer multiply-adds, which
    the card issues at another rate than fp32: ``macs_per_s`` is the rate
    this run measured (:func:`imad_rate`)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = macs / macs_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def imad_rate() -> float:
    """The card's 32 x 32 + 64-bit multiply-adds a second, measured by the
    micro-kernel of independent IMAD.WIDE chains in csrc/flac_dense.cu."""
    import torch

    from symphonia_tpu_torch.ops import _build

    blocks, iters = 132 * 8, 8192
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    fn = _build.lib().flac_imad_rate_launch

    def run():
        _build.check("imad_rate", fn(out.data_ptr(), blocks, iters,
                                     torch.cuda.current_stream().cuda_stream))

    return blocks * 256 * iters * 8 / cuda_ms(run, 3) * 1e3


# The work of each kernel from its inputs' shapes (bytes, multiply-adds).
# F1's multiply-adds are those of the taps each lane has (32 less its
# trailing zero coefficients: what the result needs whatever ``order`` says).
def work_flac_lpc(coefs, L: int, n: int):
    from symphonia_tpu_torch.ops.flac_dense import active_taps

    taps = active_taps(coefs).sum().item()
    return 2 * L * n * 4 + L * 35 * 4, float(taps) * n


def work_flac_lane_order(L: int):
    return L * 32 * 4 + 2 * L * 4, 0.0


def work_flac_decorrelate(F: int, n: int):
    return 2 * F * 2 * n * 4 + F * 4, 0.0


def work_mp3_hybrid(G: int, C: int):
    return 2 * G * C * 576 * 4 + G * C * 5 + G, G * C * 32 * 36 * 18.0


# M2 and L1 compute the factored polyphase synthesis (mp3_dense.cu): per
# 32-sample slot, the matrixing's 32 folded rows (16 multiply-adds each, on
# 16 sums or differences: 32 additions, counted as 16 multiply-adds), its
# row 16 (32) and the 16-tap FIR (16 x 32), from N [64, 32] and W [16,
# 32], with the carried tail read and the outgoing one written; the other
# 31 rows of N are mirrored. dense=True counts the reference's product
# with the combined matrix [(T + 15) * 32, 32T].
SYNTH_MACS_PER_SLOT = 32 * 16 + 16 + 32 + 16 * 32


def _work_synth(frames: int, C: int, T: int, dense: bool) -> tuple:
    n = 32 * T
    nbytes = 2 * frames * C * n * 4 + 2 * C * 480 * 4
    if dense:
        return nbytes + (n + 480) * n * 4, float(frames) * C * (n + 480) * n
    return (nbytes + (64 + 16) * 32 * 4,
            float(frames) * C * T * SYNTH_MACS_PER_SLOT)


def work_mp3_synth(G: int, C: int, dense: bool = False):
    nbytes, macs = _work_synth(G, C, 18, dense)
    return nbytes + G, macs  # + the boundary mask


# A1 and V1 compute half of the dense IMDCT product and mirror the rest
# (simt_gemm.cuh): their work is the half product's, n x n multiply-adds a
# row from n rows of the matrix; dense=True counts the dense product's, for
# comparison with a kernel that computes all of it.
def work_aac_imdct(L: int, n: int, prologue: bool, dense: bool = False):
    rows = 2 * n if dense else n
    nbytes = L * n * 4 + rows * n * 4 + L * 2 * n * 4
    if prologue:
        nbytes += L * n * 2 + L * 64 * 4 + L * 4 + (1024 + 8192) * 4
    return nbytes, float(L) * rows * n


def work_aac_dequant(L: int):
    return L * 1024 * 10 + L * 64 * 4 + L * 4 + (1024 + 8192) * 4, 0.0


def work_aac_ola(L: int):
    return L * 2048 * 4 + L * 1024 * 4 + L * 13 + 2 * 4 * 2 * 1024 * 4, 0.0


def work_vorbis_imdct(L: int, n: int, dense: bool = False):
    k = n // 2
    rows = n if dense else k
    return L * k * 4 + rows * k * 4 + L * n * 4, float(L) * rows * k


def work_mpa_l12_synth(F: int, C: int, T: int, dense: bool = False):
    return _work_synth(F, C, T, dense)


def work_vorbis_lap(V: int, n1: int):
    return V * n1 * 4 + n1 // 2 * 4 + V * n1 // 2 * 4, 0.0


def work_pcm_unpack(B: int, N: int, bps: int):
    return B * N + 4 * B * (N // bps), 0.0


def work_rice_decode(W: int, B: int, n: int):
    return W * 4 + B * (8 + 4) + B * n * 4 + B * 8, 0.0


def phase_env() -> dict:
    import torch

    _paths()
    from symphonia_tpu_torch import native
    from symphonia_tpu_torch.ops import _build

    if not native.available():
        raise RuntimeError("native host library unavailable (g++ build)")
    # The port's kernels do their own fp32 arithmetic; the plain twins that
    # phase 2 compares them with use torch.matmul, which must be true fp32
    # too (TF32 keeps ~10 mantissa bits, far outside the MP3 bar).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    _build.lib()
    load_s = time.perf_counter() - t0
    info = {
        "card": card_line(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_build_s": _build.build_seconds, "load_s": round(load_s, 3),
        "twin_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "twin_matmul_precision": torch.get_float32_matmul_precision(),
    }
    print("phase 1 environment:", json.dumps(info), flush=True)
    return info


# The per-case times of F1, in this order (the last two: a lane's taps on
# 2 and 4 threads; ``ms`` is the split the wrapper chooses).
F1_CASE_FIELDS = ("ms", "plain_ms", "library_ms", "bound_ms", "enqueue_ms",
                  "parts2_ms", "parts4_ms")


def _f1_inputs(rng, case: str, L: int, n: int, stride: int):
    """F1's inputs (res [L, stride], coefs, order, shift, wasted) as CPU
    tensors: samples +-2^25, coefficients +-2^14, shifts 0-15, wasted 0-3.
    ``dense``: all 32 coefficients random whatever the order (0-32).
    ``packer_step``: orders 0-12 as ``entry.example_batch`` draws them,
    coefficients zero beyond the order, as the packer leaves them.
    ``packer_mix``: lanes like phase 3's streams, LPC-12, LPC-32, fixed-2
    (coefficients 2, -1, shift 0) and verbatim (no coefficient).
    ``ragged``: lane l has l % 33 coefficients."""
    import torch

    res = rng.integers(-2**25, 2**25, size=(L, stride), dtype=np.int32)
    coefs = rng.integers(-2**14, 2**14, size=(L, 32), dtype=np.int32)
    shift = rng.integers(0, 16, size=L, dtype=np.int32)
    wasted = rng.integers(0, 4, size=L, dtype=np.int32)
    if case == "dense":
        order = rng.integers(0, 33, size=L, dtype=np.int32)
    else:
        order = {"packer_step": lambda: rng.integers(0, 13, size=L),
                 "packer_mix": lambda: rng.choice([12, 32, 2, 0], size=L),
                 "ragged": lambda: np.arange(L) % 33}[case]().astype(np.int32)
        coefs[np.arange(32)[None, :] >= order[:, None]] = 0
        if case == "packer_mix":
            coefs[order == 2, :2] = [2, -1]
            shift[order == 2] = 0
    return [torch.from_numpy(a) for a in (res, coefs, order, shift, wasted)]


def _lane_order_case(fd, coefs) -> dict:
    """F1's helper against its twin: the tap counts equal, the order a
    permutation of the lanes with no tap count rising along it (the order
    within one count is free)."""
    import torch

    L = coefs.shape[0]
    taps, perm = fd.lane_order(coefs)
    want = fd.active_taps(coefs)
    torch.cuda.synchronize()
    along = taps[perm.long()]
    if not (torch.equal(taps, want) and torch.equal(
            perm.sort().values, torch.arange(L, dtype=torch.int32,
                                             device=coefs.device))
            and bool((along[1:] <= along[:-1]).all())):
        raise AssertionError("flac_lane_order differs from its twin")
    return dict(
        max_abs_err=0, shape=[L, 32], library_ms=None,
        **bound(*work_flac_lane_order(L)),
        ms=cuda_ms(lambda: fd.lane_order(coefs), 20),
        plain_ms=cuda_ms(lambda: fd.lane_permutation(fd.active_taps(coefs)),
                         20),
        enqueue_ms=enqueue_ms(lambda: fd.lane_order(coefs), 20))


def phase_kernels(L: int = 16384, n: int = 4112, G: int = 4096) -> dict:
    """Each kernel against its twin on the card at the main path's shapes."""
    import torch

    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import flac_dense as fd
    from symphonia_tpu_torch.ops import mp3_dense as md

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out = {}

    # F1, bit for bit against its twin (the sums wrap, and both sides must
    # wrap identically): dense random coefficients with orders 0-32; two
    # packer-shaped draws (coefficients zero beyond ``order``), the entry
    # step's orders 0-12 and a mix like phase 3's streams; a ragged shape.
    rate = imad_rate()
    f1_ms, f1_work = {}, {}
    for case in ("dense", "packer_step", "packer_mix", "ragged"):
        Lc, nc = (L // 2 + 37, n - 5) if case == "ragged" else (L, n)
        args = [t.to(dev) for t in _f1_inputs(
            rng, case, Lc, nc, nc + 16 if case == "ragged" else nc)]
        res, coefs, order, shift, wasted = args

        def kernel():
            return fd.lpc_reconstruct_batch(res, coefs, order, shift, nc,
                                            wasted=wasted)

        def plain():
            return fd.apply_wasted_bits(fd.lpc_reconstruct_plain(
                res, coefs, order, shift, nc), wasted)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(
                f"flac_lpc {case} differs from its twin: "
                f"{int((got.long() - ref.long()).abs().max())}")
        if case == "ragged":
            for parts in (2, 4):  # both splits of a lane's taps
                if not torch.equal(ref, fd.lpc_reconstruct_batch(
                        res, coefs, order, shift, nc, wasted=wasted,
                        parts=parts)):
                    raise AssertionError(f"flac_lpc ragged, {parts} threads "
                                         "a lane, differs from its twin")
            continue
        f1_work[case] = bound_int(*work_flac_lpc(coefs, Lc, nc), rate)
        f1_ms[case] = (cuda_ms(kernel, 5),
                       cuda_ms(plain, 1) if case == "dense" else None, None,
                       f1_work[case]["bound_ms"], enqueue_ms(kernel, 10),
                       *(cuda_ms(lambda: fd.lpc_reconstruct_batch(
                           res, coefs, order, shift, nc, wasted=wasted,
                           parts=parts), 5) for parts in (2, 4)))
        if case == "packer_mix":
            out["flac_lane_order"] = _lane_order_case(fd, coefs)
        if case == "dense":
            f1_half = cuda_ms(lambda: fd.lpc_reconstruct_batch(
                res[: L // 2], coefs[: L // 2], order[: L // 2],
                shift[: L // 2], nc, wasted=wasted[: L // 2]), 5)
            dense_out = got
    out["flac_lpc"] = dict(
        max_abs_err=0, shape=[L, n], library_ms=None, **f1_work["dense"],
        ms=f1_ms["dense"][0], plain_ms=f1_ms["dense"][1],
        enqueue_ms=f1_ms["dense"][4], half_lanes_ms=f1_half,
        imad_macs_per_s=rate, ms_by_case_fields=F1_CASE_FIELDS,
        ms_by_case=_by_case(f1_ms),
        bound_by_case={k: v["bound_by"] for k, v in f1_work.items()},
        attributes=_attributes(
            (f"parts{p}", _build.lib().flac_lpc_attributes, (p,))
            for p in (2, 4)))
    got = dense_out

    # F2 on F1's output as frames [L/2, 2, n], all four assignments.
    x = got.reshape(L // 2, 2, n)
    assign = torch.from_numpy(rng.integers(0, 4, size=L // 2,
                                           dtype=np.int32)).to(dev)
    got2 = fd.decorrelate_batch(x, assign)
    ref2 = fd.decorrelate_plain(x, assign)
    torch.cuda.synchronize()
    if not torch.equal(got2, ref2):
        raise AssertionError("flac_decorrelate differs from its twin")
    out["flac_decorrelate"] = dict(
        max_abs_err=int((got2.long() - ref2.long()).abs().max()),
        shape=[L // 2, 2, n], library_ms=None,
        **bound(*work_flac_decorrelate(L // 2, n)),
        ms=cuda_ms(lambda: fd.decorrelate_batch(x, assign), 20),
        plain_ms=cuda_ms(lambda: fd.decorrelate_plain(x, assign), 5))

    # M1 -> M2 at G granules, C = 2: every block type and mixed flag, a
    # boundary mask, nonzero carried tails; spectra at x0.1.
    C = 2
    dense = md.Mp3Dense.from_numpy(md.reference_tables(), dev)
    xs = torch.from_numpy((rng.standard_normal((G, C, 576)) * 0.1)
                          .astype(np.float32)).to(dev)
    bt_np = rng.integers(0, 4, size=(G, C)).astype(np.int32)
    bt = torch.from_numpy(bt_np).to(dev)
    mixed = torch.from_numpy((bt_np == 2) & (rng.random((G, C)) < 0.5)).to(dev)
    bd_np = rng.random(G) < 0.01
    bd_np[0] = False
    boundary = torch.from_numpy(bd_np).to(dev)
    ht0 = torch.from_numpy((rng.standard_normal((C, 32, 18)) * 0.1)
                           .astype(np.float32)).to(dev)
    st0 = torch.from_numpy((rng.standard_normal((C, 480)) * 0.1)
                           .astype(np.float32)).to(dev)
    hyb_args = (xs, bt, mixed, boundary, ht0, dense.hybrid, dense.cs,
                dense.ca, dense.finv)
    S, tail = md.mp3_hybrid(*hyb_args)
    S_ref, tail_ref = md.mp3_hybrid_plain(*hyb_args)
    e_m1 = max(float((S - S_ref).abs().max()),
               float((tail - tail_ref).abs().max()))
    syn_args = (S, dense.matrixing, dense.window, st0, boundary)
    pcm, st = md.mp3_synth(*syn_args)
    pcm_ref, st_ref = md.mp3_synth_plain(*syn_args)
    torch.cuda.synchronize()
    if not (torch.isfinite(pcm).all() and torch.isfinite(st).all()):
        raise AssertionError("mp3_synth: not finite")
    e_m2 = max(float((pcm - pcm_ref).abs().max()),
               float((st - st_ref).abs().max()))
    e_m2_rel = e_m2 / float(pcm_ref.abs().max())
    # The whole chain, kernels vs twins on the CPU, at the parity bar.
    chain = dense(xs, bt, mixed, ht0, st0, boundary=boundary)
    dense_cpu = md.Mp3Dense.from_numpy(md.reference_tables(), "cpu")
    chain_cpu = dense_cpu(*(t.cpu() for t in (xs, bt, mixed, ht0, st0)),
                          boundary=boundary.cpu())
    e_chain = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(chain, chain_cpu))
    # M2 at the edges: one and three granules, a boundary at g = 0 (the
    # carried tail unused) and mid-batch, against its twin.
    for g_e, cuts in ((1, [0]), (3, [0, 2]), (9, [4])):
        bd_e = torch.zeros(g_e, dtype=torch.bool, device=dev)
        bd_e[cuts] = True
        e_args = (S[:g_e].contiguous(), dense.matrixing, dense.window, st0,
                  bd_e)
        e_m2 = max([e_m2] + [float((a - b).abs().max()) for a, b in zip(
            md.mp3_synth(*e_args), md.mp3_synth_plain(*e_args))])
    if max(e_m1, e_m2, e_chain) > 2e-5:
        raise AssertionError(f"mp3 kernels vs twins: M1 {e_m1} M2 {e_m2} "
                             f"chain {e_chain} > 2e-5")
    # Two chained calls against one call (the reference's 1e-6 bar).
    h = G // 2 + 3
    first = dense(xs[:h], bt[:h], mixed[:h], ht0, st0, boundary=boundary[:h])
    second = dense(xs[h:], bt[h:], mixed[h:], first[1], first[2],
                   boundary=boundary[h:])
    joined = torch.cat([first[0], second[0]])
    e_chunks = max(float((joined - chain[0]).abs().max()),
                   float((second[1] - chain[1]).abs().max()),
                   float((second[2] - chain[2]).abs().max()))
    if e_chunks > 1e-6:
        raise AssertionError(f"mp3 chained calls vs one call: {e_chunks}")
    chunks_bits = (_bits_equal(joined, chain[0])
                   and _bits_equal(second[2], chain[2]))
    e_m1_edges = _m1_edge_cases(md, dense, rng, dev)
    e_m1 = max(e_m1, e_m1_edges)
    # Device time by run length (granules a warp takes in a row), at G, a
    # quarter of it and a short call: the wrapper's rule (md.run_length)
    # rests on these.
    cuts = [tuple(t[:g].contiguous() for t in hyb_args[:4]) + hyb_args[4:]
            for g in (G // 4, 64)]
    by_run = {f"G{a[0].shape[0]}_run{r}": [graph_ms(
        lambda: md.mp3_hybrid(*a, run=r), 20)]
        for a in [hyb_args] + cuts for r in md.RUN_LENGTHS}
    out["mp3_hybrid"] = dict(
        max_abs_err=e_m1, shape=[G, C, 576], library_ms=None,
        **bound(*work_mp3_hybrid(G, C)),
        ms=cuda_ms(lambda: md.mp3_hybrid(*hyb_args), 20),
        plain_ms=cuda_ms(lambda: md.mp3_hybrid_plain(*hyb_args), 5),
        enqueue_ms=enqueue_ms(lambda: md.mp3_hybrid(*hyb_args), 20),
        graph_ms=graph_ms(lambda: md.mp3_hybrid(*hyb_args), 20),
        run=md.run_length(G, C), short_run=md.run_length(64, C),
        graph_ms_by_run=_by_case(by_run),
        bits_equal_twin=(_bits_equal(S, S_ref)
                         and _bits_equal(tail, tail_ref)),
        max_abs_err_edge_shapes=e_m1_edges,
        attributes=_attributes((("mp3_hybrid",
                                 _build.lib().mp3_hybrid_attributes, ()),)))
    # The library call: cuBLAS fp32 on the reference's dense product with
    # the combined polyphase matrix (its time, not its overlap-add).
    poly_t = torch.from_numpy(md._polyphase_combined_matrix()).to(dev).t()
    out["mp3_synth"] = dict(
        max_abs_err=e_m2, max_rel_err=e_m2_rel, shape=[G, C, 576],
        library_ms=cuda_ms(lambda: torch.matmul(S, poly_t), 20),
        **bound(*work_mp3_synth(G, C)),
        dense_bound_ms=bound(*work_mp3_synth(G, C, dense=True))["bound_ms"],
        ms=cuda_ms(lambda: md.mp3_synth(*syn_args), 20),
        plain_ms=cuda_ms(lambda: md.mp3_synth_plain(*syn_args), 20),
        enqueue_ms=enqueue_ms(lambda: md.mp3_synth(*syn_args), 20),
        graph_ms=graph_ms(lambda: md.mp3_synth(*syn_args), 20))

    # The reference's own oracle: the stateful numpy per-granule chain.
    g_small = 6
    x_s = xs[:g_small].cpu().numpy()
    bt_s, mx_s = bt_np[:g_small], mixed[:g_small].cpu().numpy()
    states = [md.GranuleDenseState() for _ in range(C)]
    expect = np.stack([np.stack([
        md.granule_dense_np(x_s[g, c].copy(), int(bt_s[g, c]), bool(mx_s[g, c]),
                         states[c]) for c in range(C)]) for g in range(g_small)])
    small = dense(xs[:g_small].contiguous(), bt[:g_small].contiguous(),
                  mixed[:g_small].contiguous())[0].cpu().numpy()
    e_oracle = float(np.abs(small - expect).max())
    if e_oracle > 2e-5:
        raise AssertionError(f"mp3 dense vs numpy oracle: {e_oracle}")
    print("phase 2 kernels vs twins:", json.dumps(
        {**_rounded(out),
         "mp3_chain_vs_cpu_twin": e_chain, "mp3_vs_numpy_oracle": e_oracle,
         "mp3_chunks_vs_one_call": e_chunks,
         "mp3_chunks_bits_equal_one_call": chunks_bits}), flush=True)
    return out


def _m1_edge_cases(md, dense, rng, dev) -> float:
    """M1 against its twin at the shapes where its runs end: G = 1, 2, 3,
    G not a multiple of the run, C = 1, a boundary at g = 0, at the first
    and at the last granule of a run, a block type outside 0..3 (the zero
    matrix), with and without a carried tail, at every run length and the
    wrapper's own. Returns the largest error (bar 2e-5); S and the tail
    must not depend on the run by any bit."""
    import torch

    worst = 0.0
    for G, C, cuts, carried in ((1, 2, [], True), (1, 1, [0], True),
                                (2, 2, [1], False), (3, 1, [], True),
                                (11, 2, [0, 4, 7], True),
                                (37, 1, [8, 15, 16, 36], False),
                                (64, 2, [32], True)):
        x = torch.from_numpy((rng.standard_normal((G, C, 576)) * 0.1)
                             .astype(np.float32)).to(dev)
        bt_np = rng.integers(0, 4, size=(G, C)).astype(np.int32)
        mixed = torch.from_numpy((bt_np == 2)
                                 & (rng.random((G, C)) < 0.5)).to(dev)
        bt_np[G // 2, 0] = 5  # no matrix: zeros
        bt_np[0, C - 1] = -1
        bt = torch.from_numpy(bt_np).to(dev)
        boundary = torch.zeros(G, dtype=torch.bool, device=dev)
        boundary[cuts] = True
        ht0 = (torch.from_numpy((rng.standard_normal((C, 32, 18)) * 0.1)
                                .astype(np.float32)).to(dev)
               if carried else None)
        args = (x, bt, mixed, boundary if cuts else None, ht0, dense.hybrid,
                dense.cs, dense.ca, dense.finv)
        S_ref, tail_ref = md.mp3_hybrid_plain(*args)
        S0, tail0 = md.mp3_hybrid(*args)
        torch.cuda.synchronize()
        err = max(float((S0 - S_ref).abs().max()),
                  float((tail0 - tail_ref).abs().max()))
        if not (err <= 2e-5):
            raise AssertionError(f"mp3_hybrid [{G}, {C}, 576], boundaries "
                                 f"{cuts}: {err} > 2e-5")
        for run in md.RUN_LENGTHS:
            S, tail = md.mp3_hybrid(*args, run=run)
            if not (_bits_equal(S, S0) and _bits_equal(tail, tail0)):
                raise AssertionError(f"mp3_hybrid [{G}, {C}, 576] at run "
                                     f"{run} differs from the default run")
        worst = max(worst, err)
    return worst


def _rounded(out: dict) -> dict:
    """Per-kernel results with their times rounded for printing."""
    return {k: {kk: (round(vv, 4) if kk.endswith("ms") and vv is not None
                     else vv) for kk, vv in v.items()}
            for k, v in out.items()}


def _by_case(times: dict) -> dict:
    """Per-case ms (kernel, plain twin, library call or None, bound),
    rounded for printing."""
    return {k: [None if v is None else round(v, 4) for v in vals]
            for k, vals in times.items()}


def _bits_equal(a, b) -> bool:
    """Bit for bit (signs of zero included); both float32 of one shape."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _zeros_positive(y) -> bool:
    """Every zero of ``y`` is +0.0 (sign bit clear)."""
    import torch

    return not bool(torch.signbit(y[y == 0]).any())


# The per-case times of A1 and V1, in this order.
IMDCT_CASE_FIELDS = ("ms", "plain_ms", "library_ms", "library_half_ms",
                     "bound_ms", "dense_bound_ms", "enqueue_ms")


def _imdct_case(kernel, plain, x, m, work, work_dense) -> tuple:
    """A1 or V1 at one shape: the kernel, its twin, cuBLAS fp32 on the
    dense product (the reference's function) and on the half product that
    the kernel computes (``m``'s rows K/2 .. 3K/2 - 1), both bounds, and
    the host's time to enqueue one kernel call."""
    import torch

    K = x.shape[1]
    m_t, half_t = m.t(), m[K // 2: K // 2 + K].t()
    return (cuda_ms(kernel, 10), cuda_ms(plain, 10),
            cuda_ms(lambda: torch.matmul(x, m_t), 10),
            cuda_ms(lambda: torch.matmul(x, half_t), 10),
            bound(*work)["bound_ms"], bound(*work_dense)["bound_ms"],
            enqueue_ms(kernel, 20))


# The per-case times of L1, in this order.
SYNTH_CASE_FIELDS = ("ms", "plain_ms", "library_ms", "bound_ms",
                     "dense_bound_ms", "enqueue_ms", "graph_ms")


def _attributes(entries) -> dict:
    """Registers a thread, local-memory (spill) bytes a thread and resident
    blocks an SM of each (name, C function, arguments), from the CUDA
    runtime (cudaFuncGetAttributes, the occupancy query); a spill fails."""
    import ctypes

    from symphonia_tpu_torch.ops import _build

    out = {}
    for name, fn, args in entries:
        vals = (ctypes.c_int * 3)()
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(
            ctypes.c_int)]
        fn.restype = ctypes.c_int
        _build.check(f"{name} attributes", fn(*args, vals))
        out[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm"),
                             vals))
        if out[name]["local_bytes"]:
            raise AssertionError(f"{name}: ptxas spilled ({out[name]})")
    return out


def _synth_attributes() -> dict:
    """M2's and L1's synthesis kernel at T = 18, 12 and 36."""
    from symphonia_tpu_torch.ops import _build

    fn = _build.lib().mp3_synth_attributes
    return _attributes((f"T{T}", fn, (T,)) for T in (18, 12, 36))


def _tile_attributes() -> dict:
    """A1 with and without its prologue, each on contiguous rows and
    through a row map, and V1 (the IMDCT tile)."""
    from symphonia_tpu_torch.ops import _build

    lib = _build.lib()
    return _attributes((
        ("aac_imdct_prologue", lib.aac_imdct_attributes, (1,)),
        ("aac_imdct", lib.aac_imdct_attributes, (0,)),
        ("aac_imdct_prologue_row_map", lib.aac_imdct_attributes, (3,)),
        ("aac_imdct_row_map", lib.aac_imdct_attributes, (2,)),
        ("vorbis_imdct", lib.vorbis_imdct_attributes, ())))


def _a1_row_map_cases(dense, rng, x, quant, xs) -> dict:
    """A1 through a row map (the entry step's split of long and short
    lanes): a random permutation of the lanes with ``n_rows`` at 3/4 of
    them and at 0, into an output whose other rows must keep their bits;
    the lanes it names bit for bit against A1 on the same lanes gathered.
    Long: ``x`` [L, 1024] with the prologue's ``quant``; short: ``xs`` [S,
    128] as S / 8 lanes of eight windows. The time beside A1's on as many
    contiguous rows (the first 3/4 of them, no index)."""
    import torch

    from symphonia_tpu_torch.ops import aac_dense as ad

    dev = x.device
    xl = xs.reshape(-1, 1024)  # the short windows as lanes
    cases = {"long_prologue": (x, dense.imdct_long, quant),
             "short": (xl, dense.imdct_short, None)}
    res = {}
    for case, (xc, m, q) in cases.items():
        lanes_n = xc.shape[0]
        n = m.shape[1]
        rows = torch.from_numpy(
            rng.permutation(lanes_n).astype(np.int32)).to(dev)
        part = 3 * lanes_n // 4
        for count in (part, 0):
            n_rows = torch.tensor(count, dtype=torch.int32, device=dev)
            out = torch.empty((lanes_n, 2048), dtype=torch.float32,
                              device=dev)
            out.view(torch.int32).fill_(0x7FC01234)  # NaN bits no row gives
            sentinel = out.clone()
            ad.aac_imdct(xc, m, q, rows=rows, n_rows=n_rows, out=out)
            lanes = rows[:count].long()
            qg = None if q is None else (
                tuple(t[lanes] for t in q[:3]) + tuple(q[3:]))
            want = sentinel.clone()
            if count:
                want[lanes] = ad.aac_imdct(
                    xc[lanes].reshape(-1, n), m, qg).reshape(count, 2048)
            torch.cuda.synchronize()
            if not _bits_equal(out, want):
                raise AssertionError(
                    f"aac_imdct {case} through a row map of {count} lanes: "
                    "not bit-equal to A1 on the lanes gathered, or a row "
                    "outside the map written")
        qc = None if q is None else (
            tuple(t[:part] for t in q[:3]) + tuple(q[3:]))
        xcont = xc[:part].reshape(-1, n)
        n_rows = torch.tensor(part, dtype=torch.int32, device=dev)
        ms = [cuda_ms(lambda: ad.aac_imdct(xc, m, q, rows=rows,
                                           n_rows=n_rows, out=out), 10),
              cuda_ms(lambda: ad.aac_imdct(xcont, m, qc), 10)]
        ms += [cuda_ms(lambda: ad.aac_imdct(xcont, m, qc), 10),
               cuda_ms(lambda: ad.aac_imdct(xc, m, q, rows=rows,
                                            n_rows=n_rows, out=out), 10)]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        res[case] = {
            "lanes": lanes_n, "mapped_lanes": part, "rows_of_n": list(
                xcont.shape), "bits_equal_gathered": True,
            "untouched_outside": True,
            "ms": [ms[0], ms[3]], "contiguous_ms": [ms[1], ms[2]],
            "ratio": (ms[0] + ms[3]) / (ms[1] + ms[2]),
            "zero_rows_ms": cuda_ms(lambda: ad.aac_imdct(
                xc, m, q, rows=rows, n_rows=zero, out=out), 10)}
    return res


def phase_aac_kernels(L: int = 16384, S: int = 8192) -> dict:
    """A1-A3 against their twins on the card at the main path's shapes."""
    import torch

    from symphonia_tpu_torch import native
    from symphonia_tpu_torch.codecs.aac import subband_info
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import aac_dense as ad

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    dense = ad.AacDense.from_numpy(ad.reference_tables(), dev)
    _, bands_long, _ = subband_info(44100)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # Handoff operands at the entropy stage's scales, 80% handoff rows:
    # Laplacian quants with ~1 escape per row up to +-8191 and the int16
    # extremes, scales 2^((sf - 100) / 4), zero past the last band. The
    # other rows carry stale quants and scales whose product overflows.
    coeffs = (rng.standard_normal((L, 1024)) * 0.1).astype(np.float32)
    qbuf = np.clip(np.rint(rng.laplace(0.0, 4.0, (L, 1024))), -60, 60)
    qbuf = qbuf.astype(np.int16)
    esc = rng.random((L, 1024)) < 1e-3
    qbuf[esc] = rng.integers(-8191, 8192, int(esc.sum()))
    qbuf[0, :6] = [8191, -8191, 8190, -8190, 32767, -32768]
    scales = np.exp2((rng.integers(60, 100, (L, 64)) - 100) / 4.0)
    scales = scales.astype(np.float32)
    scales[:, 49:] = 0.0
    deq = (rng.random(L) >= 0.8).astype(np.int32)
    qbuf[deq != 0] = 8191
    scales[deq != 0] = 3e38
    # Rows 1 and 2 give exact zeros: row 1 is +0.0 (with the prologue a
    # handoff row of negative quants in bands of scale 0, which dequantize
    # to +0.0), row 2 is -0.0, whose products are zeros of both signs.
    coeffs[1], coeffs[2] = 0.0, -0.0
    deq[1], qbuf[1], scales[1] = 0, -5, 0.0
    deq[2] = 1
    x = t(coeffs)
    quant = dense.quant(t(qbuf), t(scales), t(deq), bands_long)
    short = (rng.standard_normal((S, 128)) * 0.1).astype(np.float32)
    short[1], short[2] = 0.0, -0.0
    xs = t(short)
    out, errs, bits = {}, {}, {}

    # A1: long with the prologue, long without, short. Bar: 1e-5 of the
    # larger of 1 and the twin's peak (escape quants push outputs far
    # above the builder streams' ~0.12; sums of 1024 fp32 terms in another
    # order differ in proportion to the output). Every zero output must be
    # +0.0 (the mirror writes 0 - z), and the mirrored half product must
    # equal the dense twin (cuBLAS) bit for bit: the AAC matrices satisfy
    # the mirror identity exactly.
    a1 = {"long_prologue": (x, dense.imdct_long, quant),
          "long": (x, dense.imdct_long, None),
          "short": (xs, dense.imdct_short, None)}
    a1_ms = {}
    for case, args in a1.items():
        got = ad.aac_imdct(*args)
        ref = ad.aac_imdct_plain(*args)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            raise AssertionError(f"aac_imdct {case}: not finite")
        err = float((got - ref).abs().max())
        bar = 1e-5 * max(1.0, float(ref.abs().max()))
        if err > bar:
            raise AssertionError(f"aac_imdct {case}: {err} > {bar}")
        if not (_zeros_positive(got) and bool((got[1:3] == 0).all())):
            raise AssertionError(f"aac_imdct {case}: a zero row's outputs "
                                 "are not all +0.0")
        bits[f"aac_imdct_{case}"] = _bits_equal(got, ref)
        if not bits[f"aac_imdct_{case}"]:
            raise AssertionError(f"aac_imdct {case}: not bit-equal to its "
                                 "dense twin")
        errs[f"aac_imdct_{case}"] = err
        a1_ms[case] = _imdct_case(
            lambda: ad.aac_imdct(*args), lambda: ad.aac_imdct_plain(*args),
            args[0], args[1],
            work_aac_imdct(*args[0].shape, case == "long_prologue"),
            work_aac_imdct(*args[0].shape, case == "long_prologue",
                           dense=True))
    out["aac_imdct"] = dict(
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("aac_imdct")),
        shape=[L, 1024],
        **dict(zip(IMDCT_CASE_FIELDS[:4], a1_ms["long_prologue"][:4])),
        **bound(*work_aac_imdct(L, 1024, True)),
        dense_bound_ms=a1_ms["long_prologue"][5],
        ms_by_case_fields=IMDCT_CASE_FIELDS, ms_by_case=_by_case(a1_ms),
        row_map=_a1_row_map_cases(dense, rng, x, quant, xs))

    # A2: bit for bit with its twin and with the host twin of the device
    # dequantization (native.aac_dequant_host).
    got = ad.aac_dequant(x, *quant)
    twin = ad.aac_dequant_plain(x, *quant)
    host = native.aac_dequant_host(
        {"coeffs": coeffs[:, None], "qbuf": qbuf[:, None],
         "scales": scales[:, None], "deq": deq[:, None]},
        bands_long)[:, 0]
    torch.cuda.synchronize()
    if not (_bits_equal(got, twin) and _bits_equal(got, t(host))):
        raise AssertionError("aac_dequant differs from its twin or the "
                             "host dequantization")
    out["aac_dequant"] = dict(
        max_abs_err=float((got - t(host)).abs().max()), shape=[L, 1024],
        library_ms=None, **bound(*work_aac_dequant(L)),
        ms=cuda_ms(lambda: ad.aac_dequant(x, *quant), 20),
        plain_ms=cuda_ms(lambda: ad.aac_dequant_plain(x, *quant), 5))

    # A3 at L lanes: every window sequence and shape pair, sequence starts
    # at random; bit for bit with its twin.
    pcm = t((rng.standard_normal((L, 2048)) * 0.05).astype(np.float32))
    lanes = [t(rng.integers(0, 4, L).astype(np.int32)),
             t(rng.integers(0, 2, L).astype(np.int32)),
             t(rng.integers(0, 2, L).astype(np.int32)),
             t(rng.random(L) < 0.01)]
    got = dense.ola(pcm, *lanes)
    twin = ad.aac_ola_plain(pcm, *lanes, *dense.ola_tables)
    torch.cuda.synchronize()
    if not _bits_equal(got, twin):
        raise AssertionError("aac_ola differs from its twin")
    # ... and with the reference's sequential chain over a few sequences
    # of all four window sequences (valid transitions) and both shapes.
    n_seq, n_fr = 6, 14
    cyc = [0, 1, 2, 3]
    flat = (rng.standard_normal((n_seq * n_fr, 2048)) * 0.05).astype(
        np.float32)
    seqs = np.array([cyc[(f + k) % 4] for k in range(n_seq)
                     for f in range(n_fr)], np.int32)
    shapes = rng.integers(0, 2, n_seq * n_fr).astype(np.int32)
    prevs = np.roll(shapes, 1)
    first = np.arange(n_seq * n_fr) % n_fr == 0
    prevs[first] = rng.integers(0, 2, n_seq)
    small = dense.ola(t(flat), t(seqs), t(shapes), t(prevs),
                      t(first)).cpu().numpy()
    for k in range(n_seq):
        sl = slice(k * n_fr, (k + 1) * n_fr)
        pcms = [p.reshape(8, 256) if q == 2 else p
                for p, q in zip(flat[sl], seqs[sl])]
        chain = ad.window_ola_chain(pcms, seqs[sl], shapes[sl].astype(bool),
                                 prevs[sl].astype(bool))
        if not np.array_equal(small[sl].reshape(-1), chain):
            raise AssertionError(f"aac_ola differs from window_ola_chain "
                                 f"(sequence {k})")
    # ... and at a few lanes: L = 1, 2, 3 and 257, sequence starts
    # everywhere, nowhere (but lane 0) and at random, and every lane
    # EIGHT_SHORT.
    for Le in (1, 2, 3, 257):
        for starts in ("all", "none", "random"):
            for all_short in (False, True):
                e_seq = (np.full(Le, 2) if all_short
                         else rng.integers(0, 4, Le)).astype(np.int32)
                e_first = {"all": np.ones(Le, bool),
                           "none": np.zeros(Le, bool),
                           "random": rng.random(Le) < 0.3}[starts]
                e_args = (t((rng.standard_normal((Le, 2048)) * 0.05)
                            .astype(np.float32)), t(e_seq),
                          t(rng.integers(0, 2, Le).astype(np.int32)),
                          t(rng.integers(0, 2, Le).astype(np.int32)),
                          t(e_first))
                if not _bits_equal(dense.ola(*e_args), ad.aac_ola_plain(
                        *e_args, *dense.ola_tables)):
                    raise AssertionError(
                        f"aac_ola differs from its twin at L = {Le}, "
                        f"starts {starts}, all short {all_short}")
    out["aac_ola"] = dict(
        max_abs_err=float((got - twin).abs().max()), shape=[L, 2048],
        library_ms=None, **bound(*work_aac_ola(L)),
        ms=cuda_ms(lambda: dense.ola(pcm, *lanes), 20),
        plain_ms=cuda_ms(lambda: ad.aac_ola_plain(
            pcm, *lanes, *dense.ola_tables), 5),
        enqueue_ms=enqueue_ms(lambda: dense.ola(pcm, *lanes), 20),
        graph_ms=graph_ms(lambda: dense.ola(pcm, *lanes), 20),
        bits_equal_twin=True, edge_lanes=[1, 2, 3, 257],
        attributes=_attributes((("aac_ola",
                                 _build.lib().aac_ola_attributes, ()),)))
    print("phase 2 aac kernels vs twins:", json.dumps(
        {**_rounded(out),
         **errs, "bits_equal_twin": bits, "zero_outputs_positive": True,
         "aac_ola_vs_window_ola_chain": "equal"}), flush=True)
    return out


def phase_vorbis_l12_kernels(L: int = 16384, F: int = 4096) -> dict:
    """V1, L1 and V2 against their twins on the card: V1 at the main path's
    block sizes and at both ends of the Vorbis range, L1 for Layer I and
    II at F frames, chained over calls against one call, and against the
    reference's numpy polyphase on a few frames, V2 at the entry step's
    width and at n1 = 64."""
    import torch

    from symphonia_tpu_torch.codecs.vorbis import vorbis_window
    from symphonia_tpu_torch.ops import mp3_dense as md
    from symphonia_tpu_torch.ops import vorbis_dense as vd

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    out, errs = {}, {}

    # V1: spectra at the tamed builder streams' scale (|x| < 1e3), rows 1
    # and 2 +0.0 and -0.0. Bar: the Vorbis bar, 1e-6 of the larger of 1 and
    # the twin's peak; every zero output +0.0. Bit for bit with the dense
    # twin where the matrix satisfies the mirror identity exactly (n <=
    # 4096; asserted at 2048, the main path's size); at 8192 1618 entries
    # miss it by one ulp, and the bits are reported, not asserted.
    dense = vd.VorbisDense({}, dev)
    v1_ms, bits = {}, {}
    for n, lanes in ((2048, L), (256, L), (64, 4096), (8192, 2048)):
        spec = (rng.standard_normal((lanes, n // 2)) * 100.0).astype(
            np.float32)
        spec[1], spec[2] = 0.0, -0.0
        x = torch.from_numpy(spec).to(dev)
        m = dense.matrix(n)
        got = vd.vorbis_imdct(x, m)
        ref = vd.vorbis_imdct_plain(x, m)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and got.shape == (lanes, n)):
            raise AssertionError(f"vorbis_imdct n={n}: shape or not finite")
        err = float((got - ref).abs().max())
        bar = 1e-6 * max(1.0, float(ref.abs().max()))
        if err > bar:
            raise AssertionError(f"vorbis_imdct n={n}: {err} > {bar}")
        if not (_zeros_positive(got) and bool((got[1:3] == 0).all())):
            raise AssertionError(f"vorbis_imdct n={n}: a zero row's outputs "
                                 "are not all +0.0")
        bits[f"vorbis_imdct_{n}"] = _bits_equal(got, ref)
        if n == 2048 and not bits[f"vorbis_imdct_{n}"]:
            raise AssertionError("vorbis_imdct n=2048: not bit-equal to its "
                                 "dense twin")
        errs[f"vorbis_imdct_{n}"] = err
        v1_ms[f"{lanes}x{n // 2}->{n}"] = _imdct_case(
            lambda: vd.vorbis_imdct(x, m), lambda: vd.vorbis_imdct_plain(x, m),
            x, m, work_vorbis_imdct(lanes, n),
            work_vorbis_imdct(lanes, n, dense=True))
    main = v1_ms[f"{L}x1024->2048"]
    out["vorbis_imdct"] = dict(
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("vorbis")),
        shape=[L, 1024], **dict(zip(IMDCT_CASE_FIELDS[:4], main[:4])),
        **bound(*work_vorbis_imdct(L, 2048)), dense_bound_ms=main[5],
        ms_by_case_fields=IMDCT_CASE_FIELDS, ms_by_case=_by_case(v1_ms))

    # L1 at F frames of C = 2 channels, subband samples at x0.1 with a
    # carried tail; bar 2e-5 (the reference's).
    C = 2
    l12 = md.L12Dense.from_numpy(md.l12_tables(), dev)
    fac = (l12.matrixing, l12.window)
    l1_ms = {}
    for T in (36, 12):
        sb = torch.from_numpy((rng.standard_normal((F, C, 32, T)) * 0.1)
                              .astype(np.float32)).to(dev)
        t0 = torch.from_numpy((rng.standard_normal((C, 480)) * 0.1)
                              .astype(np.float32)).to(dev)
        pcm, tail = md.mpa_l12_synth(sb, *fac, t0)
        pcm_ref, tail_ref = md.l12_synth_plain(sb, *fac, t0)
        torch.cuda.synchronize()
        if not (torch.isfinite(pcm).all() and torch.isfinite(tail).all()):
            raise AssertionError(f"mpa_l12_synth T={T}: not finite")
        err = max(float((pcm - pcm_ref).abs().max()),
                  float((tail - tail_ref).abs().max()))
        if err > 2e-5:
            raise AssertionError(f"mpa_l12_synth T={T}: {err} > 2e-5")
        errs[f"mpa_l12_synth_{T}"] = err
        errs[f"mpa_l12_synth_{T}_rel"] = err / float(pcm_ref.abs().max())
        # Chained calls (Layer I: chunks of 1 and 2 frames first, where the
        # tail reaches past the chunk) against the one call above.
        cuts = [1, 3, F // 2] if T == 12 else [F // 2 + 3]
        parts, st, a = [], t0, 0
        for b in cuts + [F]:
            p, st = md.mpa_l12_synth(sb[a:b], *fac, st)
            parts.append(p)
            a = b
        joined = torch.cat(parts)
        e_chain = max(float((joined - pcm).abs().max()),
                      float((st - tail).abs().max()))
        if e_chain > 1e-6:
            raise AssertionError(f"mpa_l12_synth T={T} chained: {e_chain}")
        errs[f"mpa_l12_synth_{T}_chunks_vs_one_call"] = e_chain
        bits[f"mpa_l12_synth_{T}_chunks_vs_one_call"] = (
            _bits_equal(joined, pcm) and _bits_equal(st, tail))
        # The reference's numpy polyphase over six frames of channel 0.
        small = md.mpa_l12_synth(sb[:6].contiguous(), *fac, None)[0]
        expect = md.polyphase_response_np(np.concatenate(
            list(sb[:6, 0].cpu().numpy()), axis=1))[: 6 * 32 * T]
        e_np = float(np.abs(small[:, 0].reshape(-1).cpu().numpy()
                            - expect).max())
        if e_np > 2e-5:
            raise AssertionError(f"mpa_l12_synth T={T} vs numpy: {e_np}")
        errs[f"mpa_l12_synth_{T}_vs_numpy"] = e_np
        # The library call: cuBLAS fp32 on the reference's dense product,
        # the combined matrix's K axis in sb's order (k*T + t).
        m = md._polyphase_combined_matrix(T)
        poly_t = torch.from_numpy(np.ascontiguousarray(
            m.reshape(-1, T, 32).transpose(0, 2, 1).reshape(m.shape))).to(
                dev).t()
        sb2 = sb.reshape(F * C, 32 * T)
        l1_ms[f"T{T}"] = (
            cuda_ms(lambda: md.mpa_l12_synth(sb, *fac, t0), 20),
            cuda_ms(lambda: md.l12_synth_plain(sb, *fac, t0), 20),
            cuda_ms(lambda: torch.matmul(sb2, poly_t), 20),
            bound(*work_mpa_l12_synth(F, C, T))["bound_ms"],
            bound(*work_mpa_l12_synth(F, C, T, dense=True))["bound_ms"],
            enqueue_ms(lambda: md.mpa_l12_synth(sb, *fac, t0), 20),
            graph_ms(lambda: md.mpa_l12_synth(sb, *fac, t0), 20))
    out["mpa_l12_synth"] = dict(
        max_abs_err=max(errs[f"mpa_l12_synth_{T}"] for T in (12, 36)),
        shape=[F, C, 32, 36], ms=l1_ms["T36"][0], plain_ms=l1_ms["T36"][1],
        library_ms=l1_ms["T36"][2], **bound(*work_mpa_l12_synth(F, C, 36)),
        dense_bound_ms=l1_ms["T36"][4], graph_ms=l1_ms["T36"][6],
        ms_by_case_fields=SYNTH_CASE_FIELDS, ms_by_case=_by_case(l1_ms))

    # V2 on V1's output scale: bit for bit with its twin (each product and
    # the sum rounded once, in the reference's order), at the entry step's
    # width and at Vorbis's smallest block.
    v2_ms = {}
    for n1, V in ((2048, L), (64, 4096)):
        tt = torch.from_numpy((rng.standard_normal((V, n1)) * 100.0)
                              .astype(np.float32)).to(dev)
        w = torch.from_numpy(vorbis_window(n1)).to(dev)
        got = vd.vorbis_lap(tt, w)
        ref = vd.vorbis_lap_plain(tt, w)
        torch.cuda.synchronize()
        if not _bits_equal(got, ref):
            raise AssertionError(f"vorbis_lap [{V}, {n1}] differs from its "
                                 f"twin: {float((got - ref).abs().max())}")
        v2_ms[f"{V}x{n1}"] = (cuda_ms(lambda: vd.vorbis_lap(tt, w), 20),
                              cuda_ms(lambda: vd.vorbis_lap_plain(tt, w), 20),
                              None, bound(*work_vorbis_lap(V, n1))["bound_ms"])
    main = f"{L}x2048"
    out["vorbis_lap"] = dict(
        max_abs_err=0.0, shape=[L, 2048], ms=v2_ms[main][0],
        plain_ms=v2_ms[main][1], library_ms=None,
        **bound(*work_vorbis_lap(L, 2048)),
        ms_by_case=_by_case(v2_ms))
    print("phase 2 vorbis and layer I/II kernels vs twins:", json.dumps(
        {**_rounded(out),
         **errs, "bits_equal_twin": bits, "zero_outputs_positive": True,
         "imdct_tile": _tile_attributes(),
         "synth_kernel": _synth_attributes()}), flush=True)
    return out


# P1's kernels whose registers, spills and blocks an SM phase 2 reports:
# (name, bytes a sample, finish, vector path).
PCM_ATTRIBUTE_CASES = (("s16le", 2, 0, 1), ("s24le", 3, 0, 1),
                       ("s32le", 4, 0, 1), ("u8", 1, 1, 1),
                       ("mulaw", 1, 2, 1), ("alaw", 1, 3, 1),
                       ("s16le_scalar", 2, 0, 0), ("s24le_scalar", 3, 0, 0))


def _pcm_edge_shapes(dev, g):
    """Batches the vector path must not mishandle: rows that start off its
    alignment (N = 16387: N % 4 and n % 4 nonzero for every sample width),
    a contiguous view at storage offset 1, one row (whose tail groups are
    partial), rows shorter than a group, and all 256 byte values."""
    import torch

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=g)

    every_byte = torch.arange(256, dtype=torch.uint8, device=dev)
    return {"[37, 16387]": rand(37, 16387),
            "[64, 4096] at offset 1": rand(64 * 4096 + 1)[1:].view(64, 4096),
            "[1, 16387]": rand(1, 16387), "[1, 16384]": rand(1, 16384),
            "[300, 24]": rand(300, 24), "[5, 3]": rand(5, 3),
            "[3, 256] every byte": every_byte.repeat(3, 1)}


def phase_pcm_kernel(B: int = PCM_SIZE[0], N: int = PCM_SIZE[1]) -> dict:
    """P1 against its twin on the card at [B, N] random bytes for each of
    its 18 codecs, bit for bit (float32 compared as int32 bits: random
    bytes hold NaNs), and at the shapes of ``_pcm_edge_shapes``. N = 16384
    leaves a trailing byte for 24-bit codecs. The library call (one PyTorch
    call computing the same function) exists for s16le, s32le and f32le: a
    reinterpreting view and a copy."""
    import torch

    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import pcm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    x = torch.randint(0, 256, (B, N), dtype=torch.uint8, device=dev,
                      generator=g)
    library = {
        "pcm_s16le": lambda: x.view(torch.int16).to(torch.int32),
        "pcm_s32le": lambda: x.view(torch.int32).clone(),
        "pcm_f32le": lambda: x.view(torch.float32).clone(),
    }
    edges = _pcm_edge_shapes(dev, g)
    by_codec = {}
    for codec, (bps, _, _) in pcm.DEVICE_CODECS.items():
        for name, e in edges.items():
            got = pcm.decode_pcm_batch(e, codec)
            ref = pcm.decode_pcm_batch_plain(e, codec)
            if got.shape != ref.shape or not torch.equal(
                    got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"pcm_unpack {codec} at {name} differs "
                                     "from its twin")
        got = pcm.decode_pcm_batch(x, codec)
        ref = pcm.decode_pcm_batch_plain(x, codec)
        torch.cuda.synchronize()
        if got.shape != (B, N // bps) or got.dtype != ref.dtype or not (
                torch.equal(got.view(torch.int32), ref.view(torch.int32))):
            raise AssertionError(f"pcm_unpack {codec} differs from its twin")
        if codec in library and not torch.equal(
                got.view(torch.int32), library[codec]().view(torch.int32)):
            raise AssertionError(f"pcm_unpack {codec} differs from the "
                                 "library call")
        del got, ref
        # Kernel and library call in turns (kernel, library, kernel): the
        # kernel's time is the mean of its two.
        ms = cuda_ms(lambda: pcm.decode_pcm_batch(x, codec), 20)
        lib_ms = cuda_ms(library[codec], 20) if codec in library else None
        ms = 0.5 * (ms + cuda_ms(lambda: pcm.decode_pcm_batch(x, codec), 20))
        by_codec[codec] = dict(
            ms=ms, library_ms=lib_ms,
            plain_ms=cuda_ms(lambda: pcm.decode_pcm_batch_plain(x, codec), 3),
            **bound(*work_pcm_unpack(B, N, bps)))
    # The scalar path at full size (a view at storage offset 1).
    off1 = torch.randint(0, 256, (B * N + 1,), dtype=torch.uint8, device=dev,
                         generator=g)[1:].view(B, N)
    scalar_ms = {c: cuda_ms(lambda: pcm.decode_pcm_batch(off1, c), 10)
                 for c in ("pcm_s16le", "pcm_s24le", "pcm_s32le")}
    main = by_codec["pcm_s16le"]
    fn = _build.lib().pcm_unpack_attributes
    out = {"pcm_unpack": dict(
        max_abs_err=0, shape=[B, N], ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"],
        ms_by_case=_by_case({c: [v["ms"], v["plain_ms"], v["library_ms"],
                                 v["bound_ms"]]
                             for c, v in by_codec.items()}),
        share_of_bound={c: round(v["bound_ms"] / v["ms"], 3)
                        for c, v in by_codec.items()},
        scalar_path=_by_case({c: [v] for c, v in scalar_ms.items()}),
        edge_shapes=list(edges),
        attributes=_attributes((name, fn, (bps, 0, fin, vec))
                               for name, bps, fin, vec in
                               PCM_ATTRIBUTE_CASES))}
    print("phase 2 pcm_unpack vs twin (ms: kernel, plain, library, bound):",
          json.dumps(_rounded(out)), flush=True)
    return out


def build_golden_corpus():
    """Phase 10's corpus: ``testing.golden_corpus.corpus()``."""
    _paths()
    from symphonia_tpu_torch.testing import golden_corpus

    return golden_corpus.corpus()


def build_inputs():
    """FLAC, MP3, AAC, Vorbis, Layer I/II and per-packet streams from the
    fixed seed, and phase 10's golden corpus, built in worker processes
    (the slowest first)."""
    _paths()
    from symphonia_tpu_torch.testing.vorbis_stream import build_vorbis

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        flac_f = [pool.submit(build_flac, i) for i in range(len(FLAC_SPECS))]
        packet_f = [pool.submit(build_packet, kind, seed)
                    for kind, seed in PACKET_SPECS]
        l12_f = [pool.submit(build_mpa_l12, kind, n, SEED + 400 + s)
                 for kind, n, s in MPA_L12_SPECS]
        vorbis_f = [pool.submit(build_vorbis, rate, e0, e1, VORBIS_SECONDS,
                                SEED + 300 + s)
                    for rate, e0, e1, s in VORBIS_SPECS]
        aac_f = [pool.submit(build_aac, i) for i in range(len(AAC_SPECS))]
        mp3_f = [pool.submit(build_mp3, i) for i in range(len(MP3_SPECS))]
        golden_f = pool.submit(build_golden_corpus)
        flacs = [f.result() for f in flac_f]
        l12s = [f.result() for f in l12_f]
        vorbis = [f.result() for f in vorbis_f]
        aacs = [f.result() for f in aac_f]
        mp3s = [f.result() for f in mp3_f]
        packets = [f.result() for f in packet_f]
        golden = golden_f.result()
    return (flacs, mp3s, aacs, vorbis, l12s, packets,
            time.perf_counter() - t0, golden)


def _spy(cls, name: str, seen: set, key):
    """Wrap ``cls.name`` to add ``key(*args)`` to ``seen`` on each call;
    returns the original, for restoring."""
    real = getattr(cls, name)

    def spy(*args, **kw):
        seen.add(key(*args))
        return real(*args, **kw)

    setattr(cls, name, spy)
    return real


def phase_slice(inputs) -> dict:
    import torch

    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops.mp3_dense import L12Dense
    from symphonia_tpu_torch.ops.vorbis_dense import VorbisDense

    flacs, mp3s, aacs, vorbis, l12s, packets, build_s = inputs[:7]
    # The batch: FLAC entries cycle over the distinct streams, the other
    # codecs' streams interleave, so input order is exercised across codecs.
    items = [("flac", i % len(flacs)) for i in range(N_FLAC_ENTRIES)]
    for j in range(len(mp3s)):
        items.insert(3 * j + 1, ("mp3", j))
    for j in range(len(aacs)):
        items.insert(7 * j + 2, ("aac", j))
    for j in range(len(vorbis)):
        items.insert(5 * j + 3, ("vorbis", j))
    for j in range(len(l12s)):
        items.insert(9 * j + 4, ("l12", j))
    for j in range(len(packets)):
        items.insert(8 * j + 5, ("packet", j))
    src = {"flac": [f[0] for f in flacs], "mp3": mp3s, "aac": aacs,
           "vorbis": vorbis, "l12": l12s, "packet": [p[0] for p in packets]}
    datas = [src[kind][i] for kind, i in items]
    audio_s = 0.0

    # Which V1 block sizes and L1 frame widths the decode ran.
    sizes, widths = set(), set()
    real_imdct = _spy(VorbisDense, "imdct", sizes, lambda _, x, n: n)
    real_l12 = _spy(L12Dense, "forward", widths,
                    lambda _, sb, *a: sb.shape[3])
    try:
        torch.cuda.synchronize()
        batch.host_routes = batch.packet_routes = 0
        _build.reset_launches()
        t0 = time.perf_counter()
        outs = batch.decode_many(datas, verify=True)  # the card, by default
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        routes = batch.host_routes
        packet_routes = batch.packet_routes
    finally:
        VorbisDense.imdct = real_imdct
        L12Dense.forward = real_l12

    if routes != 0:
        raise AssertionError(f"host_routes == {routes}")
    if packet_routes != len(packets):
        raise AssertionError(f"packet_routes == {packet_routes} for "
                             f"{len(packets)} per-packet entries")
    if any(v <= 0 for k, v in launches.items() if k not in OFF_PATH):
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{launches}")
    if launches["aac_ola"] < 2:  # one dispatch per bands_long group
        raise AssertionError(f"aac: {launches['aac_ola']} dispatches for "
                             "two bands_long groups")
    if sizes != {256, 2048, 512, 4096} or widths != {12, 36}:
        raise AssertionError(f"V1 block sizes {sizes}, L1 widths {widths}")
    mp3_outs, aac_outs, vorbis_outs, l12_outs = [], [], [], []
    packet_errs = {}
    for (kind, i), out in zip(items, outs):
        audio_s += out.samples.shape[1] / out.sample_rate
        if kind == "flac":
            src = flacs[i][1]
            if out.md5_ok is not True:
                raise AssertionError(f"flac entry {i}: md5_ok={out.md5_ok}")
            if not np.array_equal(out.samples.astype(np.int64), src):
                raise AssertionError(f"flac entry {i} differs from source")
        elif kind == "packet":
            name = PACKET_SPECS[i][0]
            packet_errs[f"{name}_{i}"] = _check_packet(name, out,
                                                       packets[i][1])
        else:
            {"mp3": mp3_outs, "aac": aac_outs, "vorbis": vorbis_outs,
             "l12": l12_outs}[kind].append(out)
    # MP3 against the port's CPU-twin path (K = 576 fp32 sums in another
    # order; builder streams reach |pcm| ~ 6, hence 1e-4).
    cpu = batch.Mp3BatchDecoder(device="cpu").decode_many(mp3s)
    e_mp3 = 0.0
    for a, b in zip(mp3_outs, cpu):
        if a.samples.shape != b.samples.shape:
            raise AssertionError("mp3 shape differs from the CPU twin path")
        if not np.isfinite(a.samples).all():
            raise AssertionError("mp3 output not finite")
        e_mp3 = max(e_mp3, float(np.abs(a.samples - b.samples).max()))
    if e_mp3 > 1e-4:
        raise AssertionError(f"mp3 vs CPU twin path: {e_mp3} > 1e-4")
    # The AAC streams alone, warm, for their share of the wall time.
    t0 = time.perf_counter()
    batch.AacBatchDecoder(device="cuda").decode_many(aacs)
    torch.cuda.synchronize()
    aac_wall = time.perf_counter() - t0
    # AAC against the port's CPU-twin path at the reference's batch bar
    # (1e-5, test_aac.py:213; builder streams reach |pcm| ~ 0.12).
    cpu = batch.AacBatchDecoder(device="cpu").decode_many(aacs)
    e_aac = 0.0
    for a, b in zip(aac_outs, cpu):
        if a.samples.shape != b.samples.shape or a.samples.shape[0] != 2:
            raise AssertionError("aac shape differs from the CPU twin path")
        if not np.isfinite(a.samples).all() or not a.samples.any():
            raise AssertionError("aac output not finite or all zero")
        e_aac = max(e_aac, float(np.abs(a.samples - b.samples).max()))
    if e_aac > 1e-5:
        raise AssertionError(f"aac vs CPU twin path: {e_aac} > 1e-5")
    # Vorbis against the port's CPU-twin path, within 1e-6 of the larger of
    # 1 and each stream's peak (the builder streams reach ~1e3-1e4); the
    # first stream decoded alone equals its merged decode bit for bit.
    t0 = time.perf_counter()
    batch.VorbisBatchDecoder(device="cuda").decode_many(vorbis)
    torch.cuda.synchronize()
    vorbis_wall = time.perf_counter() - t0
    cpu = batch.VorbisBatchDecoder(device="cpu").decode_many(vorbis)
    e_vorbis = 0.0
    for a, b in zip(vorbis_outs, cpu):
        if a.samples.shape != b.samples.shape or a.samples.shape[0] != 2:
            raise AssertionError("vorbis shape differs from the CPU twin path")
        if not np.isfinite(a.samples).all() or not a.samples.any():
            raise AssertionError("vorbis output not finite or all zero")
        peak = max(1.0, float(np.abs(b.samples).max()))
        e = float(np.abs(a.samples - b.samples).max())
        if e > 1e-6 * peak:
            raise AssertionError(f"vorbis vs CPU twin path: {e} > 1e-6 * "
                                 f"{peak}")
        e_vorbis = max(e_vorbis, e / peak)
    alone = batch.decode_bytes(vorbis[0], device="cuda").samples
    if not np.array_equal(alone, vorbis_outs[0].samples):
        raise AssertionError("vorbis merged decode differs from per-file")
    # The per-packet entries alone, for their share of the wall time.
    t0 = time.perf_counter()
    batch.decode_many([p[0] for p in packets])
    packet_wall = time.perf_counter() - t0
    # Layer I/II against the port's CPU-twin path at the reference's bar.
    cpu = batch.Mp3BatchDecoder(device="cpu").decode_many(l12s)
    e_l12 = 0.0
    for a, b in zip(l12_outs, cpu):
        if a.samples.shape != b.samples.shape or a.samples.shape[0] != 2:
            raise AssertionError("layer I/II shape differs from the CPU "
                                 "twin path")
        if not np.isfinite(a.samples).all() or not a.samples.any():
            raise AssertionError("layer I/II output not finite or all zero")
        e_l12 = max(e_l12, float(np.abs(a.samples - b.samples).max()))
    if e_l12 > 2e-5:
        raise AssertionError(f"layer I/II vs CPU twin path: {e_l12} > 2e-5")
    info = {
        "entries": len(datas), "flac_entries": N_FLAC_ENTRIES,
        "mp3_entries": len(mp3s), "aac_entries": len(aacs),
        "vorbis_entries": len(vorbis), "layer12_entries": len(l12s),
        "packet_entries": len(packets),
        "input_build_s": round(build_s, 1),
        "wall_s": round(wall, 3), "audio_s": round(audio_s, 1),
        "realtime_x": round(audio_s / wall, 1), "host_routes": routes,
        "packet_routes": packet_routes,
        "aac_only_wall_s": round(aac_wall, 3),
        "packet_only_wall_s": round(packet_wall, 3),
        "vorbis_only_wall_s": round(vorbis_wall, 3),
        "launches": launches, "off_path": list(OFF_PATH),
        "vorbis_block_sizes": sorted(sizes), "l12_widths": sorted(widths),
        "mp3_max_abs_err_vs_cpu": e_mp3, "aac_max_abs_err_vs_cpu": e_aac,
        "vorbis_max_err_vs_cpu_over_peak": e_vorbis,
        "layer12_max_abs_err_vs_cpu": e_l12,
        "packet_err_vs_source": packet_errs,
        "card": card_line(),
    }
    print("phase 3 slice decode_many:", json.dumps(info), flush=True)
    return info


def phase_golden(corpus=None) -> dict:
    """Phase 10: the reference's golden anchor (``tests/golden_pcm.npz``,
    the reference's own decoded PCM of one fixture per codec family) on
    the card: the corpus built by ``testing.golden_corpus`` (byte-equal to
    ``tests/test_golden_pcm.py``'s, the CPU tests check) decoded by
    ``batch.decode_many`` on the card, each entry under the anchor's
    protocol (integers bit-exact, floats within 1e-5). The real-media
    entries are decoded where pygame's files exist and named as absent
    where they do not. ``corpus`` is ``golden_corpus.corpus()``'s result
    where :func:`build_inputs` built it beside phase 3's streams."""
    import torch

    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.testing import golden_corpus

    entries, absent = corpus or golden_corpus.corpus()
    names = list(entries)
    t0 = time.perf_counter()
    _build.reset_launches()
    outs = batch.decode_many([entries[n] for n in names])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    with np.load(os.path.join(ROOT, "tests", "golden_pcm.npz")) as g:
        rows = [golden_corpus.compare(n, o.samples, o.sample_rate, g)
                for n, o in zip(names, outs)]
    info = {"entries": rows, "absent": absent, "wall_s": round(wall, 3),
            "launches": launches, "card": card_line()}
    print("phase 10 golden anchor:", json.dumps(
        dict(info, launches={k: v for k, v in launches.items() if v})),
        flush=True)
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"golden anchor: {bad} outside the protocol")
    path = GOLDEN_PATH + (("vorbis_imdct",) if "vorbis_real" in entries
                          else ())
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"golden anchor: {missing} not launched")
    return info


def _check_packet(name: str, out, src: np.ndarray) -> float:
    """A per-packet entry against its source: lossless ones bit for bit
    (float32 by its bits), ADPCM within 1% of the source's RMS. Returns the
    error (RMS over the source's for ADPCM, else 0)."""
    got = out.samples
    if name in LOSSY_PACKET:
        n = src.shape[1]
        if got.shape[0] != 1 or got.shape[1] < n:
            raise AssertionError(f"{name}: shape {got.shape}")
        err = float(np.sqrt(np.mean((got[:, :n] - src.astype(np.float64))
                                    ** 2) / np.mean(src.astype(np.float64)
                                                    ** 2)))
        if err > 1e-2:
            raise AssertionError(f"{name}: RMS error {err} of the source's")
        return err
    if got.shape != src.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {src.shape}")
    same = (np.array_equal(got.view(np.int32), src.view(np.int32))
            if src.dtype == np.float32
            else np.array_equal(got.astype(np.int64), src))
    if not same:
        raise AssertionError(f"{name} differs from its source")
    if name == "flac_mkv" and out.md5_ok is not True:
        raise AssertionError(f"flac_mkv: md5_ok={out.md5_ok}")
    return 0.0


def phase_pcm_batch(inputs) -> dict:
    """P1's path: the PCM entries of phase 3 demuxed with the port's
    readers, each codec's packets padded into one [B, max_bytes] uint8
    batch on the card and unpacked there; the caller de-interleaves and
    trims each packet (the reference's contract for decode_pcm_batch_jax).
    Bit for bit against decode_pcm_np packet by packet, the twin, and the
    sources."""
    import torch

    from symphonia_tpu_torch import get_probe
    from symphonia_tpu_torch.core.io import MediaSourceStream
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import pcm

    packets = inputs[5]
    dev = torch.device("cuda")
    streams = []  # (entry, codec, channels, bits_per_coded_sample, packets)
    for j, (data, src) in enumerate(packets):
        fmt = get_probe().probe(MediaSourceStream(data)).format
        track = fmt.default_track()
        params = track.codec_params
        if params.codec not in pcm.DEVICE_CODECS:
            continue
        pkts = []
        while (p := fmt.next_packet()) is not None:
            if p.track_id == track.id:
                pkts.append(bytes(p.data))
        streams.append((j, params.codec, params.channels.count,
                        params.bits_per_coded_sample, pkts))
    groups = {}
    for st in streams:
        groups.setdefault(st[1], []).append(st)
    t0 = time.perf_counter()
    _build.reset_launches()
    got = {}
    for codec, group in groups.items():
        rows = [p for st in group for p in st[4]]
        buf = np.zeros((len(rows), max(len(p) for p in rows)), np.uint8)
        for r, p in enumerate(rows):
            buf[r, : len(p)] = np.frombuffer(p, np.uint8)
        x = torch.from_numpy(buf).to(dev)
        got[codec] = (x, pcm.decode_pcm_batch(x, codec))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if launches["pcm_unpack"] != len(groups):
        raise AssertionError(f"pcm_batch: {launches['pcm_unpack']} launches "
                             f"for {len(groups)} codecs")
    n_packets, n_bytes = 0, 0
    for codec, group in groups.items():
        x, out = got[codec]
        if not torch.equal(out.view(torch.int32), pcm.decode_pcm_batch_plain(
                x, codec).view(torch.int32)):
            raise AssertionError(f"pcm_batch {codec}: kernel vs twin")
        out = out.cpu().numpy()
        bps = pcm.DEVICE_CODECS[codec][0]
        r = 0
        for j, _, ch, bits, pkts in group:
            planes = []
            for p in pkts:
                n = len(p) // (bps * ch) * ch
                planar = out[r, :n].reshape(-1, ch).T
                want = pcm.decode_pcm_np(p, codec, ch, bits)
                if want.dtype != planar.dtype or not np.array_equal(
                        planar.view(np.int32), want.view(np.int32)):
                    raise AssertionError(f"pcm_batch {codec} entry {j}: a "
                                         "packet differs from decode_pcm_np")
                planes.append(planar)
                r += 1
                n_bytes += len(p)
            n_packets += len(pkts)
            src = packets[j][1]
            whole = np.concatenate(planes, axis=1)
            if not (np.array_equal(whole.view(np.int32), src.view(np.int32))
                    if src.dtype == np.float32
                    else np.array_equal(whole.astype(np.int64), src)):
                raise AssertionError(f"pcm_batch {codec} entry {j} differs "
                                     "from its source")
    info = {"streams": len(streams), "codecs": sorted(groups),
            "packets": n_packets, "bytes": n_bytes,
            "batches": {c: list(got[c][0].shape) for c in groups},
            "wall_s": round(wall, 4), "launches": launches,
            "card": card_line()}
    print("phase 4 pcm_batch:", json.dumps(info), flush=True)
    return info


def _rice_case(rd, words, cur, param, n: int) -> dict:
    """R1 at one shape: bit for bit against its twin on the card (residuals
    and end cursors), then its back-to-back, device (graph) and enqueue
    times, the twin's time and the bound from these inputs."""
    import torch

    got, got_end = rd.rice_decode_lanes(words, cur, param, n)
    want, want_end = rd.rice_decode_lanes_plain(words, cur, param, n)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got_end, want_end)):
        raise AssertionError(f"rice_decode differs from its twin at "
                             f"[{cur.shape[0]}, {n}]")
    del want, want_end

    def kernel():
        rd.rice_decode_lanes(words, cur, param, n)

    return dict(got=got, ms=cuda_ms(kernel, 10), graph_ms=graph_ms(kernel, 10),
                enqueue_ms=enqueue_ms(kernel, 20),
                plain_ms=cuda_ms(lambda: rd.rice_decode_lanes_plain(
                    words, cur, param, n), 1),
                **bound(*work_rice_decode(words.numel(), cur.shape[0], n)))


def phase_rice_bench() -> dict:
    """R1's path: the port's bench tool at its defaults (the launches of the
    path), then R1 against its twin on the card, the encoded values and the
    reference's scalar oracle on four lanes at two shapes of 33.5M symbols:
    the tool's [8192, 4096] with k = 4 (few long lanes) and FLAC
    partitions, [131072, 256] with k 0..14 by lane (many short lanes); then
    the edge cases of ``testing.rice_streams`` with the words at every
    16-byte misalignment (a view at storage offset 0-3)."""
    import torch

    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import rice_device as rd
    from symphonia_tpu_torch.testing import rice_streams as rs
    from symphonia_tpu_torch.tools import bench_rice_device

    _build.reset_launches()
    res = bench_rice_device.main()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if not res["correct_slice"]:
        raise AssertionError("bench_rice_device: correctness slice failed")
    dev = torch.device("cuda")
    B, n, k = RICE_SIZE["B"], RICE_SIZE["n"], RICE_SIZE["k"]
    mixed = rs.make_mixed_streams(RICE_MIXED_SIZE["B"], RICE_MIXED_SIZE["n"],
                                  SEED)
    shapes = {"bench": rd.make_test_streams(B, n, k) + (np.full(B, k),),
              "flac_partitions": (mixed[0], mixed[1], mixed[3], mixed[2])}
    cases = {}
    for name, (data, cur, vals, par) in shapes.items():
        words = torch.from_numpy(rd.pack_bits_u32(data)).to(dev)
        case = _rice_case(rd, words, torch.from_numpy(cur).to(dev),
                          torch.from_numpy(par.astype(np.int32)).to(dev),
                          vals.shape[1])
        got_np = case.pop("got").cpu().numpy()
        if not np.array_equal(got_np, vals):
            raise AssertionError(f"rice_decode {name}: differs from the "
                                 "encoded values")
        lanes = np.array([0, 1, len(cur) // 2, len(cur) - 1])
        oracle = rd.rice_decode_oracle(data, cur[lanes], par[lanes],
                                       vals.shape[1])
        if not np.array_equal(got_np[lanes], oracle):
            raise AssertionError(f"rice_decode {name}: differs from the "
                                 "scalar oracle")
        cases[name] = dict(shape=list(vals.shape), stream_bytes=len(data),
                           k=sorted({int(x) for x in par}), **case)
        del got_np
    edge = []
    for c in rs.edge_cases(seed=SEED):
        cur = torch.from_numpy(c["cur"]).to(dev)
        par = torch.from_numpy(c["param"].astype(np.int32)).to(dev)
        W = len(c["words"])
        want = rd.rice_decode_lanes_plain(
            torch.from_numpy(c["words"].view(np.int32)).to(dev), cur, par,
            c["n"])
        for delta in range(4):
            buf = torch.zeros(W + 4, dtype=torch.int32, device=dev)
            buf[delta:delta + W] = torch.from_numpy(c["words"].view(np.int32))
            words = buf[delta:delta + W]
            got = rd.rice_decode_lanes(words, cur, par, c["n"])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"rice_decode edge case {c['name']}, "
                                     f"words at offset {delta}: differs from "
                                     "its twin")
        edge.append(c["name"])
    attrs = _attributes((("rice_decode", _build.lib().rice_decode_attributes,
                          ()),))
    info = {"bench": {kk: (round(v, 4) if isinstance(v, float) else v)
                      for kk, v in res.items()},
            "launches": launches, "card": card_line()}
    print("phase 5 rice_bench:", json.dumps(info), flush=True)
    main_case = cases["bench"]
    info["kernel"] = dict(
        max_abs_err=0, library_ms=None, bits_equal_twin=True,
        **{f: main_case[f] for f in ("shape", "ms", "plain_ms", "graph_ms",
                                     "enqueue_ms", "bound_ms", "bound_by")},
        by_shape=cases, edge_cases=edge, attributes=attrs)
    print("phase 5 rice_decode vs twin:", json.dumps(
        _rounded({"rice_decode": info["kernel"]})), flush=True)
    return info


def _step_bound(host, size, imad_macs_per_s: float) -> dict:
    """The entry step's bound: the sum of its stages' bounds (they run one
    after another), from this run's inputs; F1's from the taps its lanes
    have at the measured integer multiply-add rate, A1 and V1 at their half
    products, and the sum with their dense products beside it."""
    import torch

    F, N, G, A, V, n1 = (size[k] for k in ("F", "N", "G", "A", "V", "n1"))
    n_short = int((host[13] == 2).sum())
    f1 = bound_int(*work_flac_lpc(torch.from_numpy(host[1]), 2 * F, N),
                   imad_macs_per_s)
    stages = {
        "flac_lane_order": work_flac_lane_order(2 * F),
        "flac_decorrelate": work_flac_decorrelate(F, N),
        "mp3_hybrid": work_mp3_hybrid(G, 2),
        "mp3_synth": work_mp3_synth(G, 2),
        "aac_imdct_long": work_aac_imdct(A - n_short, 1024, True),
        "aac_imdct_short": work_aac_imdct(8 * n_short, 128, False),
        "aac_ola": work_aac_ola(A),
        "vorbis_imdct": work_vorbis_imdct(V, n1),
        "vorbis_lap": work_vorbis_lap(V, n1),
    }
    dense = dict(stages, mp3_synth=work_mp3_synth(G, 2, dense=True),
                 aac_imdct_long=work_aac_imdct(A - n_short, 1024, True, True),
                 aac_imdct_short=work_aac_imdct(8 * n_short, 128, False,
                                                True),
                 vorbis_imdct=work_vorbis_imdct(V, n1, True))
    by_stage = {"flac_lpc": f1, **{k: bound(*w) for k, w in stages.items()}}
    return {"bound_ms": sum(b["bound_ms"] for b in by_stage.values()),
            "dense_bound_ms": f1["bound_ms"] + sum(
                bound(*w)["bound_ms"] for w in dense.values()),
            "bound_by_stage": {k: [round(b["bound_ms"], 4), b["bound_by"]]
                               for k, b in by_stage.items()}}


def _kernel_device_ms(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the summed device time
    of the CUDA kernels it ran and their number (the port's kernels and
    PyTorch's own), or the profiler's error where it shows no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
        wall = round(time.perf_counter() - t0, 2)
        if not count:
            return {"kernel_sum_ms": None, "kernels": 0,
                    "profiler": "no device events", "profiler_s": wall}
        return {"kernel_sum_ms": total / 1e3, "kernels": count,
                "profiler_s": wall}
    except Exception as e:  # the card machine's CUPTI may refuse
        return {"kernel_sum_ms": None, "kernels": None,
                "profiler": f"{type(e).__name__}: {e}"}


def phase_entry_step(imad_macs_per_s: float) -> dict:
    """The combined decode step (K14) at full width on the card: once
    eagerly under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
    anywhere in it raises), against the same step of the plain twins on
    the card; then ``entry.capture_step``'s CUDA graph (four codec stages
    as four branches), its replay bit for bit against the eager step, and
    the step captured on one stream for comparison; their times, each
    stage's, the kernels' summed device time (``torch.profiler``), the
    bound and its share; then a small step with EIGHT_SHORT handoff lanes
    (A2 dequantizes them). ``imad_macs_per_s`` is phase 2's measured
    integer multiply-add rate, for F1's bound."""
    import torch

    from symphonia_tpu_torch import entry
    from symphonia_tpu_torch.ops import _build

    dev = torch.device("cuda")
    N = STEP_SIZE["N"]
    t0 = time.perf_counter()
    host = entry.example_batch(**STEP_SIZE, seed=SEED)
    args = [torch.from_numpy(a).to(dev) for a in host]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def run(a, n, plain=False):
        fn = entry.decode_step_plain if plain else entry.decode_step
        return fn(*a, n_samples=n)

    run(args, N)  # the constants, matrices and windows onto the card
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(args, N)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = run(args, N, plain=True)
    torch.cuda.synchronize()
    names = ("flac", "mp3", "aac", "vorbis")
    errs, exact, ok = {}, {}, True
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"entry step {name}: {g.shape} {g.dtype} "
                                 f"vs plain {w.shape} {w.dtype}")
        if g.dtype == torch.float32 and not torch.isfinite(g).all():
            raise AssertionError(f"entry step {name}: not finite")
        errs[name] = float((g.double() - w.double()).abs().max())
        exact[name] = entry._bits_equal(g, w)
        ok &= exact[name] if name != "mp3" else errs[name] <= 1e-5
    shapes = {n: list(g.shape) for n, g in zip(names, got)}
    del want

    # The step as one CUDA graph: four branches (entry.capture_step), and
    # for comparison the same step captured on one stream.
    four = entry.capture_step(*args, n_samples=N)
    replayed = four()
    one = torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        one_out = run(args, N)
    one.replay()
    torch.cuda.synchronize()
    replay_exact = {n: entry._bits_equal(g, r)
                    for n, g, r in zip(names, got, replayed)}
    one_exact = {n: entry._bits_equal(g, r)
                 for n, g, r in zip(names, got, one_out)}
    del got
    # In turns: four branches, one, eager, eager, one, four.
    order = ("four", "one", "eager", "eager", "one", "four")
    fns = {"four": four, "one": one.replay, "eager": lambda: run(args, N)}
    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(cuda_ms(fns[k], 20))
    enqueue = enqueue_ms(lambda: run(args, N), 5)
    plain_ms = cuda_ms(lambda: run(args, N, plain=True), 1)
    calls = entry._stage_calls(entry._stages(False), args, N)
    stage_ms = {n: cuda_ms(c, 5) for n, c in zip(names, calls)}
    prof = _kernel_device_ms(lambda: run(args, N))
    bound = _step_bound(host, STEP_SIZE, imad_macs_per_s)
    replay_ms = min(ms["four"] + ms["one"])
    replay_launches = {k: v for k, v in four.launches.items() if v}
    four.reset()
    one.reset()
    del four, one, one_out, replayed, fns
    torch.cuda.empty_cache()  # the graphs' pools: the step's intermediates

    # A few lanes of each codec with two EIGHT_SHORT handoff lanes (deq ==
    # 0): A2 dequantizes them before the short IMDCTs.
    small = list(entry.example_batch(F=4, N=64, G=4, A=12, V=4, n1=256,
                                     seed=SEED))
    small[13][[2, 5]] = 2
    small[12][[2, 5, 7]] = 0
    sargs = [torch.from_numpy(a).to(dev) for a in small]
    _build.reset_launches()
    sgot = run(sargs, 64)
    torch.cuda.synchronize()
    handoff_launches = dict(_build.LAUNCHES)
    swant = run(sargs, 64, plain=True)
    torch.cuda.synchronize()
    handoff_errs = {n: float((g.double() - w.double()).abs().max())
                    for n, g, w in zip(names, sgot, swant)}
    # At a dozen lanes cuBLAS (the plain step's products) may pick another
    # sum order than at full width: the reference's bars, not bits.
    handoff_ok = (torch.equal(sgot[0], swant[0])
                  and max(handoff_errs[n] for n in names[1:]) <= 1e-5)
    info = {
        "size": STEP_SIZE, "seed": SEED, "input_build_s": round(build_s, 2),
        "output_shapes": shapes, "sync_debug_mode": "error",
        "step_ms": min(ms["eager"]), "step_ms_runs": ms["eager"],
        "enqueue_ms": enqueue, "replay_ms": replay_ms,
        "replay_four_branches_ms": ms["four"],
        "replay_one_branch_ms": ms["one"], "plain_step_ms": plain_ms,
        "stage_ms": stage_ms, "stage_sum_ms": sum(stage_ms.values()),
        **prof, **bound, "bound_share_of_replay": bound["bound_ms"]
        / replay_ms, "launches": launches,
        "launches_per_replay": replay_launches,
        "max_abs_err_vs_plain": errs, "bit_exact_vs_plain": exact,
        "replay_bits_equal_eager": replay_exact,
        "one_branch_bits_equal_eager": one_exact,
        "handoff_launches": handoff_launches,
        "handoff_max_abs_err_vs_plain": handoff_errs,
        "card": card_line(),
    }
    print("phase 6 entry step:", json.dumps(info), flush=True)
    missing = [k for k in STEP_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"entry step: {missing} not launched")
    if not ok:
        raise AssertionError("entry step vs its plain twin: FLAC, AAC and "
                             "Vorbis must be bit-exact, MP3 within 1e-5")
    if not (all(replay_exact.values()) and all(one_exact.values())):
        raise AssertionError("the captured step's replay is not bit for bit "
                             f"the eager step: {replay_exact}, one branch "
                             f"{one_exact}")
    if replay_launches != {k: v for k, v in launches.items() if v}:
        raise AssertionError(f"the graph holds {replay_launches}, the "
                             f"eager step launched {launches}")
    if handoff_launches["aac_dequant"] != 1 or not handoff_ok:
        raise AssertionError("entry step with short handoff lanes: A2 not "
                             "launched once, or the step outside the bars")
    return info


# Phase 7's passes: fewer than the bench's defaults (host 5-20; the late
# host and breadth passes at most that many), so that the phase fits the
# run; the stage sizes are the bench's own.
BENCH_PASSES = dict(passes=3, min_passes=3)
BENCH_PATH = ("flac_lane_order", "flac_lpc", "flac_decorrelate", "mp3_hybrid",
              "mp3_synth", "aac_imdct", "aac_ola", "vorbis_imdct")
# Phase 8: the soak's budget, the kernels it must launch (it builds no
# Layer I/II stream) and how many of its decoded inputs are decoded again
# on the CPU. The budget was 60 s before phase 9 (~100 s, most of it the
# ranks' process and CUDA context starts) joined the run.
SOAK_SECONDS = 30
SOAK_PATH = ("flac_lpc", "flac_decorrelate", "mp3_hybrid", "mp3_synth",
             "aac_imdct", "aac_ola", "vorbis_imdct")
SOAK_COMPARE = 24


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_bench(sizes=None, passes=None) -> dict:
    """Phase 7: ``tools.bench.main()`` on the card at the bench's stage
    sizes (``sizes`` overrides them), every stage and the aggregate above
    0, every kernel of its device stages launched; then each device stage's
    first output against its plain twin on the card, at the same shapes:
    FLAC bit for bit, MP3 within 2e-5, AAC within 1e-5 with its dequant
    prologue bit for bit (A1 on the twin's dequantized coefficients gives
    the same bits), Vorbis within 1e-5."""
    import torch

    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import aac_dense as ad
    from symphonia_tpu_torch.ops import flac_dense as fd
    from symphonia_tpu_torch.ops import mp3_dense as md
    from symphonia_tpu_torch.ops import vorbis_dense as vd
    from symphonia_tpu_torch.tools import bench

    sizes = sizes or {}
    _build.reset_launches()
    t0 = time.perf_counter()
    res = bench.main(device="cuda", sizes=sizes,
                     **(BENCH_PASSES if passes is None else passes))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    zero = [k for k, v in res["stages"].items() if not v > 0]
    if len(res["stages"]) != 11 or zero or not res["value"] > 0:
        raise AssertionError(f"bench: stages at 0 {zero} or aggregate "
                             f"{res['value']}")
    missing = [k for k in BENCH_PATH if launches[k] < 1]
    if missing:
        raise AssertionError(f"bench: {missing} not launched")
    dev = torch.device("cuda")
    checks = {}
    # FLAC: F1 (with its helper), then F2, bit for bit.
    kw = {k: v for k, v in sizes.get("flac_device", {}).items()
          if k != "iters"}
    t = bench._to(dev, bench.flac_device_inputs(**kw))
    got = bench.flac_device_call(t)
    block = t["res"].shape[1]
    x = fd.apply_wasted_bits(fd.lpc_reconstruct_plain(
        t["res"], t["coefs"], t["order"], t["shift"], block), t["wasted"])
    want = fd.decorrelate_plain(x.reshape(-1, 2, block),
                                t["assign"]).reshape(-1, block)
    checks["flac_device"] = dict(shape=list(got.shape),
                                 bits_equal=bool(torch.equal(got, want)))
    del t, got, x, want
    # MP3: M1 then M2 from stream start, pcm and both tails.
    kw = {k: v for k, v in sizes.get("mp3_device", {}).items()
          if k != "iters"}
    dense = bench.mp3_device_dense(dev)
    t = bench._to(dev, bench.mp3_device_inputs(**kw))
    got = bench.mp3_device_call(dense, t)
    S, ht = md.mp3_hybrid_plain(t["x"], t["bt"], t["mixed"], None, None,
                                dense.hybrid, dense.cs, dense.ca, dense.finv)
    pcm, st = md.mp3_synth_plain(S, dense.matrixing, dense.window, None,
                                 None)
    checks["mp3_device"] = dict(
        shape=list(got[0].shape),
        max_abs_err=max(_max_err(a, b) for a, b in zip(got, (pcm, ht, st))),
        peak=float(pcm.abs().max()))
    del t, got, S, pcm
    # AAC: A1 with its dequant prologue, then A3.
    kw = {k: v for k, v in sizes.get("aac_device", {}).items()
          if k != "iters"}
    dense = bench.aac_device_dense(dev)
    bl = bench.aac_bands_long()
    t = bench._to(dev, bench.aac_device_inputs(**kw))
    got = bench.aac_device_call(dense, t, bl)
    quant = dense.quant(t["qbuf"], t["scales"], t["deq"], bl)
    co = ad.aac_dequant_plain(t["coeffs"], *quant)
    prologue_bits = torch.equal(ad.aac_imdct(t["coeffs"], dense.imdct_long,
                                             quant),
                                ad.aac_imdct(co, dense.imdct_long))
    want = ad.aac_ola_plain(ad.aac_imdct_plain(co, dense.imdct_long),
                            t["seq"], t["shape"], t["prev_shape"],
                            t["first"], *dense.ola_tables)
    checks["aac_device"] = dict(shape=list(got.shape),
                                max_abs_err=_max_err(got, want),
                                peak=float(want.abs().max()),
                                dequant_bits_equal=bool(prologue_bits))
    del t, got, co, want
    # Vorbis: V1 at n = 2048.
    kw = {k: v for k, v in sizes.get("vorbis_device", {}).items()
          if k != "iters"}
    m = bench.vorbis_device_matrix(dev)
    t = bench._to(dev, bench.vorbis_device_inputs(**kw))
    got = bench.vorbis_device_call(t, m)
    want = vd.vorbis_imdct_plain(t["x"], m)
    checks["vorbis_device"] = dict(shape=list(got.shape),
                                   max_abs_err=_max_err(got, want),
                                   peak=float(want.abs().max()))
    del t, got, want
    torch.cuda.synchronize()
    info = {"stages": {k: round(v, 1) for k, v in res["stages"].items()},
            "pipelined": {k: round(v, 1)
                          for k, v in res["pipelined"].items()},
            "value": round(res["value"], 1), "line": res["line"],
            "first_call_s": {k: round(v, 3)
                             for k, v in res["first_call_s"].items()},
            "wall_s": round(wall, 1), "launches": launches,
            "twins": checks, "card": card_line()}
    print("phase 7 bench:", json.dumps(info), flush=True)
    bad = [k for k, c in checks.items() if not (
        c.get("bits_equal", True) and c.get("dequant_bits_equal", True)
        and c.get("max_abs_err", 0.0) <= (2e-5 if k == "mp3_device"
                                          else 1e-5))]
    if bad:
        raise AssertionError(f"bench device stages outside their bars: {bad}")
    return info


def phase_soak(seconds: float = SOAK_SECONDS, compare: int = SOAK_COMPARE
               ) -> dict:
    """Phase 8: ``tools.soak.main`` on the card for ``seconds`` from the
    run's seed (any exception outside the decoders' error taxonomy, a
    native crash or a CUDA error fails it), every kernel of
    :data:`SOAK_PATH` launched; then the first ``compare`` inputs that
    decoded, decoded again on the CPU (the plain twins): integer output
    (FLAC, PCM) bit for bit, float output (MP3, AAC, Vorbis, and the host's
    float decoders) within 2e-5 x max(1, peak |sample|)."""
    import logging

    import torch

    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.testing.edge_streams import edge_inputs
    from symphonia_tpu_torch.tools import soak

    # The decoders log each corrupt frame they skip; thousands would bury
    # the run's own lines.
    quiet = [logging.getLogger(n) for n in ("symphonia_tpu_torch",
                                            "symphonia_tpu.probe")]
    levels = [lg.level for lg in quiet]
    for lg in quiet:
        lg.setLevel(logging.ERROR)
    try:
        _build.reset_launches()
        res = soak.main(seconds, SEED, device="cuda", keep=compare)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        rows = []
        for builder, rnd, k, data, samples in res["kept"]:
            row = {"builder": builder, "round": rnd, "variant": k}
            try:
                cpu = batch.decode_bytes(data, device="cpu").samples
            except soak.OK_ERRORS as e:
                cpu = repr(e)
            rows.append(_card_vs_cpu(row, samples, cpu))
        # The smallest shapes the decoders pack (one FLAC frame, one MP3
        # frame or none, one AAC lane, a few Vorbis packets, each also cut
        # short): each alone, then the decodable ones in one decode_many.
        edge, merged_in = [], []
        for name, data in edge_inputs(SEED):
            got, want = (_decode_or_error(batch, soak, data, d)
                         for d in ("cuda", "cpu"))
            if isinstance(got, str) or isinstance(want, str):
                edge.append({"edge": name, "card": got, "cpu": want,
                             "ok": isinstance(got, str) and got == want})
                continue
            edge.append(_card_vs_cpu({"edge": name}, got, want))
            merged_in.append((name, data, want))
        merged = batch.decode_many([d for _, d, _ in merged_in],
                                   device="cuda")
        edge += [_card_vs_cpu({"edge": name, "merged": True}, out.samples,
                              want)
                 for (name, _, want), out in zip(merged_in, merged)]
        torch.cuda.synchronize()
    finally:
        for lg, lv in zip(quiet, levels):
            lg.setLevel(lv)
    worst = max((r.get("rel_err", 0.0) for r in rows + edge), default=0.0)
    info = {"seed": res["seed"], "inputs": res["inputs"],
            "decoded": res["decoded"], "rounds": res["rounds"],
            "seconds": round(res["seconds"], 1), "slow": len(res["slow"]),
            "launches": launches, "compared": len(rows),
            "edge_compared": len(edge), "worst_rel_err": worst,
            "card": card_line()}
    print("phase 8 soak:", json.dumps(info), flush=True)
    print("phase 8 soak card vs CPU:", json.dumps(rows), flush=True)
    print("phase 8 edge inputs card vs CPU:", json.dumps(edge), flush=True)
    missing = [k for k in SOAK_PATH if launches[k] < 1]
    if missing:
        raise AssertionError(f"soak: {missing} not launched")
    bad = [r for r in rows + edge if not r["ok"]]
    if len(rows) < compare or bad:
        raise AssertionError(f"soak: {len(rows)} inputs compared, card and "
                             f"CPU differ on {bad}")
    return info


# Phase 9: the multi-card shell (entry.dryrun_multichip) on the one card:
# (ranks, backend, size). One rank under NCCL at the entry step's full
# width; eight gloo ranks at the reference's own sizes (dp = 4, tp = 2);
# the full width split over dp = 2, tp = 2; six ranks (dp = 3) at the
# reference's sizes, whose 1024 lanes dp does not divide. The kernels it
# must launch, summed over ranks: the entry step's.
MULTICHIP_RUNS = ((1, "nccl", STEP_SIZE), (8, "gloo", None),
                  (4, "gloo", STEP_SIZE), (6, "gloo", None))
MULTICHIP_PATH = STEP_PATH


def _plain_aac_row_split(device="cuda") -> dict:
    """The plain AAC step's long-window product (A1's twin with its dequant
    prologue) on the dry run's inputs at the reference's sizes, over all
    its rows against the same over two halves of them: the largest
    difference and bit-equality."""
    import torch

    from symphonia_tpu_torch import entry
    from symphonia_tpu_torch.codecs.aac import EIGHT_SHORT
    from symphonia_tpu_torch.ops import aac_dense

    host = entry.example_batch(F=512, N=256, G=1024, A=1024, V=1024, n1=512,
                               seed=1, aac_rate=48000)
    coeffs, qbuf, scales, deq, seqs = (torch.from_numpy(a).to(device)
                                       for a in host[9:14])
    sfb = torch.from_numpy(host[16]).to(device)
    aac = entry._constants(torch.device(device)).aac
    rows = torch.nonzero(seqs != EIGHT_SHORT).flatten()

    def product(r):
        quant = tuple(t.index_select(0, r) for t in (qbuf, scales, deq))
        return aac_dense.aac_imdct_plain(coeffs.index_select(0, r),
                                         aac.imdct_long,
                                         quant + (sfb, aac.pow43))

    whole = product(rows)
    halves = torch.cat([product(r) for r in rows.chunk(2)])
    return {"rows": len(rows), "max_abs_err": _max_err(whole, halves),
            "bits_equal": _bits_equal(whole, halves)}


def phase_multichip(runs=MULTICHIP_RUNS) -> dict:
    """Phase 9: ``entry.dryrun_multichip`` for each of ``runs`` on the card,
    each held (inside it, on rank 0) to the unsharded ``decode_step`` on
    the card (FLAC bit for bit, MP3, AAC and Vorbis within 1e-5,
    bit-equality printed) and to the plain twins' step on the card on the
    same inputs (FLAC and Vorbis bit for bit, MP3 and AAC within 1e-5,
    bit-equality printed), so that each kernel is held to its twin at
    these shapes too (the reference's sizes: FLAC N = 256, Vorbis n1 =
    512, the 48 kHz band map). ``plain_aac_row_split`` shows why AAC's bar
    is not bits: the plain step's long-window product at the reference's
    sizes against the same product over two halves of its rows. Each rank sets its counts to 0 just before its sharded step and
    reads them just after (its warm-up and rank 0's unsharded step are not
    counted); the launches are summed over ranks and runs."""
    import torch

    from symphonia_tpu_torch import entry
    from symphonia_tpu_torch.ops import _build

    torch.cuda.empty_cache()  # the ranks share the card with this process
    launches = {k: 0 for k in _build.KERNELS}
    rows = []
    for n, backend, size in runs:
        t0 = time.perf_counter()
        res = entry.dryrun_multichip(n, backend=backend, size=size,
                                     **({"seed": SEED} if size else {}))
        wall = time.perf_counter() - t0
        for k, v in res["launches"].items():
            launches[k] += v
        outs = res.pop("outputs")
        if not all(np.isfinite(o).all() for o in outs.values()):
            raise AssertionError(f"multichip {n} {backend}: not finite")
        rows.append({"ranks": n, "backend": backend, "mesh": res["mesh"],
                     "size": res["size"], "seed": res["seed"],
                     "devices": res["devices"], "h2d_ms": res["h2d_ms"],
                     "step_ms": res["step_ms"],
                     "gather_ms": res["gather_ms"],
                     "max_abs_err": res["max_abs_err"],
                     "bits_equal": res["bits_equal"],
                     "max_abs_err_vs_plain": res["max_abs_err_vs_plain"],
                     "bit_exact_vs_plain": res["bit_exact_vs_plain"],
                     "launches": {k: v for k, v in res["launches"].items()
                                  if v},
                     "shapes": {k: list(o.shape) for k, o in outs.items()},
                     "wall_s": round(wall, 2)})
        del outs
    info = {"runs": rows, "launches": launches,
            "plain_aac_row_split": _plain_aac_row_split(), "card": card_line()}
    print("phase 9 multichip:", json.dumps(info), flush=True)
    missing = [k for k in MULTICHIP_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"multichip: {missing} not launched")
    return info


# Phase 11: the FLAC bulk cell's pool (benchmark/configs/librispeech_flac
# .json): 128 durations, the quantiles of a Beta(3, 5.72) on [1, 35] s, at
# 16 kHz in frames of 4,096 samples.
MD5_POOL = dict(streams=128, rate=16000, block=4096, beta=(3.0, 5.72),
                seconds=(1.0, 35.0), lpc_order=8)


def _md5_pool_lengths() -> np.ndarray:
    p = MD5_POOL
    a, b = p["beta"]
    t = (np.arange(1 << 16) + 0.5) / (1 << 16)
    cdf = np.cumsum(t ** (a - 1) * (1 - t) ** (b - 1))
    q = np.interp((np.arange(p["streams"]) + 0.5) / p["streams"],
                  cdf / cdf[-1], t)
    secs = p["seconds"][0] + (p["seconds"][1] - p["seconds"][0]) * q
    n = np.round(secs * p["rate"]).astype(np.int64)
    r = n % p["block"]
    grow = (r > 0) & (r <= p["lpc_order"])
    return n + np.where(grow, p["lpc_order"] + 1 - r, 0)


def _md5_case(lengths, C: int, bps: int, block_sizes, trims, seed: int,
              dev):
    """Decoded lanes x [F, C, n_max] on the card for streams of
    ``lengths`` samples (frames of ``block_sizes``, cycled), each hashed to
    ``trims`` of its samples, and hashlib's digest of each stream."""
    import hashlib

    import torch

    from symphonia_tpu_torch.codecs.flac import md5_bytes_of

    rng = np.random.default_rng(seed)
    blocks, first, frames, want = [], [], [], []
    for k, n in enumerate(lengths):
        first.append(len(blocks))
        left = int(n)
        while left > 0:
            b = min(int(block_sizes[len(blocks) % len(block_sizes)]), left)
            blocks.append(b)
            left -= b
        frames.append(len(blocks) - first[-1])
    blocks = np.array(blocks, np.int32)
    n_max = int(max(block_sizes))
    lim = 1 << (bps - 1)
    x = rng.integers(-lim, lim, size=(len(blocks), C, n_max),
                     dtype=np.int64).astype(np.int32)
    for k in range(len(lengths)):
        f0, nf = first[k], frames[k]
        pcm = np.concatenate([x[f, :, : blocks[f]]
                              for f in range(f0, f0 + nf)], axis=1)
        want.append(hashlib.md5(md5_bytes_of(
            pcm[:, : trims[k]].astype(np.int64), bps)).digest())
    return dict(x=torch.from_numpy(x).to(dev), blocks=blocks, first=first,
                frames=frames, n_hash=list(trims), width=(bps + 7) // 8,
                want=want, x_host=x)


def _md5_run(case, dev, cuts=()):
    """F3 over ``case`` in lane chunks cut at ``cuts`` -> the digests."""
    import torch

    from symphonia_tpu_torch.ops import flac_dense as fd

    md5 = fd.LaneMd5(case["first"], case["frames"], case["n_hash"],
                     [case["width"]] * len(case["first"]), case["blocks"],
                     dev)
    F = case["x"].shape[0]
    edges = [0] + list(cuts) + [F]
    for i, j in zip(edges, edges[1:]):
        md5.update(case["x"][i:j], torch.from_numpy(md5.table(i, j)).to(dev))
    return md5


def step_ns() -> float:
    """Nanoseconds one step of an MD5 chain takes (LOP3, add, rotate and
    add: three dependent operations as compiled; one thread), measured by
    csrc/flac_dense.cu's md5_chain_kernel."""
    import torch

    from symphonia_tpu_torch.ops import _build

    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    iters = 1 << 20
    fn = _build.lib().flac_md5_chain_launch

    def run():
        _build.check("md5_chain", fn(out.data_ptr(), iters,
                                     torch.cuda.current_stream().cuda_stream))

    return cuda_ms(run, 3) * 1e6 / iters


def phase_md5() -> dict:
    import torch

    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build

    dev = torch.device("cuda")
    _build.reset_launches()
    lengths = _md5_pool_lengths()
    B = MD5_POOL["block"]
    pool = _md5_case(lengths, 1, 16, [B], lengths, SEED + 11, dev)
    F = pool["x"].shape[0]
    md5 = _md5_run(pool, dev)
    got = md5.digests()
    bad = [k for k, (g, w) in enumerate(zip(got, pool["want"])) if g != w]
    if bad:
        raise AssertionError(f"flac_md5: streams {bad} differ from hashlib")
    table = torch.from_numpy(md5.table(0, F)).to(dev)
    ms = cuda_ms(lambda: md5.update(pool["x"], table), 5)
    enq = enqueue_ms(lambda: md5.update(pool["x"], table), 5)

    # Stereo 24-bit: block sizes that vary frame to frame, streams trimmed
    # inside their last frame, three lane chunks that split streams.
    lens = [5000 + 1733 * k for k in range(12)]
    trims = [n - (k % 3) * 7 for k, n in enumerate(lens)]
    st = _md5_case(lens, 2, 24, [4096, 1152, 4608, 576, 17], trims,
                   SEED + 12, dev)
    Fs = st["x"].shape[0]
    got = _md5_run(st, dev, cuts=(Fs // 3, 2 * Fs // 3)).digests()
    bad_st = [k for k, (g, w) in enumerate(zip(got, st["want"])) if g != w]
    if bad_st:
        raise AssertionError(f"flac_md5 stereo 24-bit: streams {bad_st} "
                             "differ from hashlib")

    # The chain bound, and the rule's ratio: the host path over the 128
    # streams (planar int32 as the stitch hands them) against one chain.
    lat = step_ns()
    nbytes = [2 * int(n) for n in lengths]
    longest = int(np.argmax(lengths))
    blocks_max = -(-(nbytes[longest] + 9) // 64)
    chain_ms = blocks_max * 64 * lat * 1e-6
    bytes_ms = (4 * F * B + 4 * (8 * 128 + F) + 16 * 128) / HBM_BYTES_PER_S \
        * 1e3
    one = _md5_case([lengths[longest]], 1, 16, [B], [lengths[longest]],
                    SEED + 13, dev)
    one_md5 = _md5_run(one, dev)
    if one_md5.digests() != one["want"]:
        raise AssertionError("flac_md5: the longest stream alone differs")
    one_table = torch.from_numpy(one_md5.table(0, one["x"].shape[0])).to(dev)
    one_ms = cuda_ms(lambda: one_md5.update(one["x"], one_table), 5)

    xs = pool["x_host"]
    pcms, sis = [], []
    for k in range(len(lengths)):
        f0, nf = pool["first"][k], pool["frames"][k]
        pcms.append(np.ascontiguousarray(xs[f0 : f0 + nf, 0, :].reshape(
            -1)[: lengths[k]])[None, :])
        sis.append(SimpleNamespace(bits_per_sample=16, md5=pool["want"][k]))
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        oks = [batch._flac_md5_ok(p, si) for p, si in zip(pcms, sis)]
        host.append((time.perf_counter() - t0) * 1e3)
    if not all(oks):
        raise AssertionError("the host path rejects the pool's digests")
    host_ms = min(host)
    host_rate = sum(nbytes) / host_ms
    chain_rate = nbytes[longest] / one_ms
    info = dict(
        shape=[F, 1, B], streams=len(lengths),
        longest_bytes=nbytes[longest], sum_over_max=sum(nbytes) /
        nbytes[longest], ms=ms, enqueue_ms=enq, one_chain_ms=one_ms,
        step_ns=lat, bound_ms=max(chain_ms, bytes_ms),
        bound_by="chain" if chain_ms >= bytes_ms else "bytes",
        bytes_bound_ms=bytes_ms, share_of_bound=max(chain_ms, bytes_ms) / ms,
        host_ms=host_ms, host_ms_runs=host, host_mb_per_s=host_rate / 1e3,
        chain_mb_per_s=chain_rate / 1e3, host_per_chain=host_rate /
        chain_rate, rule=batch.MD5_HOST_PER_CHAIN,
        stereo24=dict(streams=len(lens), frames=Fs, chunks=3),
        launches=dict(_build.LAUNCHES),
        attributes=_attributes([("md5", _build.lib().flac_md5_attributes,
                                 ())]))
    print("phase 11 md5:", json.dumps(info), flush=True)
    return info


# M0's checks: a seeded pool of the fma_mp3 configuration's clips (the
# benchmark's generator), and the request the fma_mp3.shard32 cell sends
# (its first MP3_ENTROPY_REQUEST clips, 36.8K frames at 30 s a clip).
MP3_ENTROPY_POOL = 64
MP3_ENTROPY_REQUEST = 32


def _ptxas(source: str) -> dict:
    """ptxas's report of the kernels of ``csrc/<source>`` (``-Xptxas
    -v``): its lines, registers, stack frame and spill bytes."""
    import re
    import tempfile

    from symphonia_tpu_torch.ops import _build

    src = _build.CSRC / source
    with tempfile.TemporaryDirectory() as tmp:
        p = _build._nvcc(_build.find_nvcc(), [
            "-Xptxas", "-v", "-c", str(src), "-o",
            os.path.join(tmp, "k.o")])
    if p.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{p.stderr}")
    lines = [ln.strip() for ln in p.stderr.splitlines() if ln.strip()]
    text = " ".join(lines)

    def grab(pattern):
        m = re.search(pattern, text)
        return int(m.group(1)) if m else None

    return dict(lines=lines, registers=grab(r"Used (\d+) registers"),
                stack_bytes=grab(r"(\d+) bytes (?:cumulative )?stack"),
                spill_stores=grab(r"(\d+) bytes spill stores"),
                spill_loads=grab(r"(\d+) bytes spill loads"))


def _m0_run(datas, tabs, dev):
    """M0 over ``datas`` (MPEG audio streams): (plan, readers, inputs on
    the card, outputs as numpy)."""
    import torch

    from symphonia_tpu_torch.core.formats import FormatOptions
    from symphonia_tpu_torch.core.io import MediaSourceStream
    from symphonia_tpu_torch.formats.mpa import MpaReader
    from symphonia_tpu_torch.ops import mp3_entropy as me

    rs = [MpaReader(MediaSourceStream(d), FormatOptions(enable_gapless=True))
          for d in datas]
    pl = me.plan([r._offsets for r in rs], [r._sizes for r in rs],
                 [r.header.n_channels for r in rs],
                 [2 if r.header.is_mpeg1 else 1 for r in rs])
    inputs = [torch.from_numpy(a).to(dev) for a in (
        pl.pack([r._buf for r in rs]), pl.frames, pl.clips)]
    out = me.mp3_entropy(*inputs, tabs, pl.n_lanes)
    torch.cuda.synchronize()
    return pl, rs, inputs, [o.cpu().numpy() for o in out]


def phase_mp3_entropy() -> dict:
    """M0 against ``native.mp3_extract``: a seeded pool of the fma_mp3
    configuration's clips, and the test encoders' streams of every kind
    (``testing/mp3_entropy_streams.py``: MPEG-2 and 2.5, intensity
    stereo, CRC, linbits tables, mixed-block flags, a reservoir underflow
    at the start, flipped bits), each alone and all in one launch:
    statuses, block types and mixed flags equal, spectra bit-equal (a
    difference of one unit in the last place counted apart). Then M0's
    time at the fma_mp3.shard32 request's shape against its bytes bound
    and the native extraction of the same clips, and ptxas's registers
    and spills."""
    import ctypes

    import torch

    from benchmark.gen import mp3 as gen
    from symphonia_tpu_torch import native
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import mp3_entropy as me
    from symphonia_tpu_torch.testing import mp3_entropy_streams as ms

    dev = torch.device("cuda")
    _build.reset_launches()
    tabs = me.device_tables(dev)
    cfg = json.loads(open(os.path.join(
        ROOT, "benchmark", "configs", "fma_mp3.json")).read())
    t0 = time.perf_counter()
    pool = [s.data for s in gen.make_pool(cfg, MP3_ENTROPY_POOL, SEED + 21,
                                          device=dev)]
    pool_s = time.perf_counter() - t0
    checks = {}
    pl, rs, _, out = _m0_run(pool, tabs, dev)
    checks["fma_pool"] = ms.compare(pl, ms.expected(rs), *out)
    streams = ms.streams(SEED % 1000)
    for name, data in streams.items():
        pl, rs, _, out = _m0_run([data], tabs, dev)
        checks[name] = ms.compare(pl, ms.expected(rs), *out)
    pl, rs, _, out = _m0_run(list(streams.values()) + pool[:4], tabs, dev)
    checks["all_in_one"] = ms.compare(pl, ms.expected(rs), *out)
    bad = {k: v for k, v in checks.items() if not v["ok"]}
    for k, v in checks.items():
        print(f"phase 12 mp3_entropy {k}: {json.dumps(v)}", flush=True)
    if bad:
        raise AssertionError(f"mp3_entropy differs from the native "
                             f"extraction on {sorted(bad)}")

    # The cell's request: time, bound, the native extraction.
    req = pool[:MP3_ENTROPY_REQUEST]
    pl, rs, inputs, out = _m0_run(req, tabs, dev)
    F = pl.frames.shape[0]
    ms_ = cuda_ms(lambda: me.mp3_entropy(*inputs, tabs, pl.n_lanes), 10)
    enq = enqueue_ms(lambda: me.mp3_entropy(*inputs, tabs, pl.n_lanes), 10)
    frame_bytes = int(pl.frames[:, 1].sum())
    bytes_ms = (frame_bytes + pl.n_lanes * (576 * 4 + 8)) / HBM_BYTES_PER_S \
        * 1e3
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        for r in rs:
            native.mp3_extract(r._buf, r._offsets, r._sizes,
                               max_granules=2 * len(r._offsets) + 2)
        host.append((time.perf_counter() - t0) * 1e3)
    # Registers, local bytes (M0's per-thread arrays and ptxas's spills,
    # which ptxas reports apart) and blocks an SM, from the CUDA runtime.
    # M0 is not held to no spill: ptxas spills ~190 bytes a thread, and
    # the spill-free build (211 registers, 32-thread blocks, everything
    # inlined) took 1.5x as long on an H100 (PERF.md).
    attrs = (ctypes.c_int * 3)()
    fn = _build.lib().mp3_entropy_attributes
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _build.check("mp3_entropy attributes", fn(attrs))
    ptx = _ptxas("mp3_entropy.cu")
    info = dict(
        shape=[F, pl.n_lanes], clips=len(req), frame_bytes=frame_bytes,
        ms=ms_, enqueue_ms=enq, bound_ms=bytes_ms, bound_by="bytes",
        share_of_bound=bytes_ms / ms_, host_ms=min(host), host_ms_runs=host,
        host_over_kernel=min(host) / ms_, pool_s=pool_s,
        checked={k: {f: v[f] for f in ("clips", "frames", "lanes", "values",
                                       "ulp1")} for k, v in checks.items()},
        attributes={"mp3_entropy": dict(zip(
            ("registers", "local_bytes", "blocks_per_sm"), list(attrs)))},
        ptxas=ptx, launches=dict(_build.LAUNCHES), card=card_line())
    print("phase 12 mp3_entropy:", json.dumps(info), flush=True)
    return info


# Phase 13: the fma_mp3.shard32 request (32 stereo clips of 1,150 frames,
# two granules a frame) in the decoder's chunks.
MP3_PLACE_CLIPS = 32
MP3_PLACE_GRANULES = 2300
MP3_PLACE_CHUNK = 4096


def phase_mp3_place(clips: int = MP3_PLACE_CLIPS,
                    granules: int = MP3_PLACE_GRANULES,
                    chunk: int = MP3_PLACE_CHUNK) -> dict:
    """M3 ``mp3_place`` at the fma_mp3.shard32 request's shape: seeded PCM
    [clips x granules, 2, 576] on the card, laid out chunk by chunk with
    trims at every delay mod 4 (the LAME delay 1105, plus 0-3), bit for
    bit against its twin on the card and against the host's concatenate,
    transpose and ``_gapless_trim`` of the same PCM; its time for the
    request's launches (CUDA events; a graph replay, the launch cost out)
    beside its bytes bound (every kept sample read and written once), its
    registers, local memory and blocks an SM, and ptxas's report."""
    import ctypes

    import torch

    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import mp3_dense as md

    dev = torch.device("cuda")
    _build.reset_launches()
    C = 2
    counts = [granules] * clips
    tracks = [SimpleNamespace(delay=1105 + k % 4, padding=1151 - k % 3)
              for k in range(clips)]
    bounds = [batch._trim_bounds(576 * n, t, True)
              for n, t in zip(counts, tracks)]
    table, size = md.place_table(counts, bounds, C)
    G = sum(counts)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    pcm = torch.randn((G, C, 576), generator=g, device=dev)
    tab = torch.from_numpy(table).to(dev)
    chunks = [(i, min(G, i + chunk)) for i in range(0, G, chunk)]
    rows = [md.place_rows(table, i, j) for i, j in chunks]
    out = torch.full((size,), float("nan"), device=dev)

    def request():
        for (i, j), r in zip(chunks, rows):
            md.mp3_place(pcm[i:j], tab, out, i, r)

    request()
    twin = torch.full((size,), float("nan"), device=dev)
    for (i, j), r in zip(chunks, rows):
        md.mp3_place_plain(pcm[i:j], table, twin, i, r)
    torch.cuda.synchronize()
    got = out.cpu().numpy()

    def same(a, b):
        return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                     b.view(np.uint32))

    bits_twin = same(got, twin.cpu().numpy()) and not np.isnan(got).any()
    host = pcm.cpu().numpy()
    bits_host, pos = True, 0
    for n, t, (_, _, _, N, off) in zip(counts, tracks, table.tolist()):
        want = batch._gapless_trim(
            host[pos : pos + n].transpose(1, 0, 2).reshape(C, -1), t, True)
        bits_host = bits_host and same(
            got[off : off + C * N].reshape(C, N), want)
        pos += n
    launches = _build.LAUNCHES["mp3_place"]
    ms_ = cuda_ms(request, 20)
    graph = graph_ms(request, 10)
    enq = enqueue_ms(request, 20)
    bound_ms = 2 * 4 * size / HBM_BYTES_PER_S * 1e3
    attrs = (ctypes.c_int * 3)()
    fn = _build.lib().mp3_place_attributes
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _build.check("mp3_place attributes", fn(attrs))
    info = dict(
        shape=[G, C, 576], clips=clips, chunks=len(chunks),
        bytes_written=4 * size, bits_equal_twin=bits_twin,
        bits_equal_host=bits_host, ms=ms_, graph_ms=graph, enqueue_ms=enq,
        bound_ms=bound_ms, bound_by="bytes", share_of_bound=bound_ms / graph,
        attributes={"mp3_place": dict(zip(
            ("registers", "local_bytes", "blocks_per_sm"), list(attrs)))},
        ptxas=_ptxas("mp3_place.cu"),
        launches=dict(_build.LAUNCHES, mp3_place=launches),
        card=card_line())
    print("phase 13 mp3_place:", json.dumps(info), flush=True)
    if not (bits_twin and bits_host):
        raise AssertionError("mp3_place differs from its twin or from the "
                             "host's layout")
    if attrs[1] > 0:
        raise AssertionError(f"mp3_place uses {attrs[1]} bytes of local "
                             "memory (a spill)")
    return info


# Phase 14: the commonvoice_mp3.online request, one 48 kHz mono clip of
# about 5 s (~212 frames of 192 bytes, ~424 granules at C = 1), from a
# pool of MP3_SPEECH_POOL clips of the configuration.
MP3_SPEECH_POOL = 16


def _reservoir_reach(reader) -> tuple:
    """The largest ``main_data_begin`` of a mono MPEG-1 Layer III clip
    without CRC (its 9 bits right after the header), in bytes and in
    frames of main data (a frame's bytes less the header and the 17
    bytes of side info)."""
    buf = reader._buf
    mdb = [(int(buf[o + 4]) << 1) | (int(buf[o + 5]) >> 7)
           for o in reader._offsets]
    main = float(np.mean(reader._sizes)) - 4 - 17
    return max(mdb), max(mdb) / main


def phase_mp3_speech(pool_size: int = MP3_SPEECH_POOL,
                     device: str = "cuda") -> dict:
    """The MP3 path's four kernels at the commonvoice_mp3.online request:
    a seeded pool of the configuration's clips (48 kHz mono 64 kbit/s,
    lead-in and tail silences that fill the reservoir, short blocks at
    onsets), and of it the clip nearest the pool's mean length as the
    request. M0 over the pool in one launch and over the request alone
    against ``native.mp3_extract``: statuses, flags and spectra bit for
    bit. On the request's M0 output, as ``decode_many`` chains them (one
    chunk, C = 1, a boundary at the first granule): M1 and M2 against
    their twins on the card (within 2e-5 of the larger of 1 and the
    twin's peak, bit-equality reported), M3 against its twin and the
    host's transpose and ``_gapless_trim``, bit for bit, and the chain's
    clip against ``decode_many``'s, bit for bit. Each kernel's time
    (CUDA events; M1, M2 and M3 also as a graph replay, M1 at every run
    length) beside its bound, and how far the clips' ``main_data_begin``
    reaches back. ``device`` is "cuda" but for a rehearsal on the
    CPU."""
    import torch

    from benchmark.gen import mp3_speech as gen
    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import mp3_dense as md
    from symphonia_tpu_torch.ops import mp3_entropy as me
    from symphonia_tpu_torch.testing import mp3_entropy_streams as ms

    dev = torch.device(device)
    _build.reset_launches()
    tabs = me.device_tables(dev)
    cfg = json.loads(open(os.path.join(
        ROOT, "benchmark", "configs", "commonvoice_mp3.json")).read())
    pool = gen.make_pool(cfg, pool_size, SEED + 24, device=dev)
    datas = [s.data for s in pool]
    mean = float(np.mean([s.n_samples for s in pool]))
    k = int(np.argmin([abs(s.n_samples - mean) for s in pool]))
    checks = {}
    pl, rs, _, out = _m0_run(datas, tabs, dev)
    checks["speech_pool"] = ms.compare(pl, ms.expected(rs), *out)
    reach = [_reservoir_reach(r) for r in rs]
    pl, rs, inputs, out = _m0_run([datas[k]], tabs, dev)
    checks["request"] = ms.compare(pl, ms.expected(rs), *out)
    for name, v in checks.items():
        print(f"phase 14 mp3_speech {name}: {json.dumps(v)}", flush=True)
    bad = sorted(name for name, v in checks.items() if not v["ok"])
    if bad:
        raise AssertionError(f"mp3_entropy differs from the native "
                             f"extraction on {bad}")

    # The request's lanes on the card, as _card_entropy views them.
    spectra, bt, mixed, status = me.mp3_entropy(*inputs, tabs, pl.n_lanes)
    if not pl.clean(status.cpu().numpy()).all():
        raise AssertionError("mp3_entropy: the request's clip is not clean")
    lo, hi = int(pl.lane[0]), int(pl.lane[0] + pl.lanes[0])
    x, b, m = (spectra[lo:hi].view(-1, 1, 576), bt[lo:hi].view(-1, 1),
               mixed[lo:hi].view(-1, 1))
    G = x.shape[0]
    dense = md.Mp3Dense.from_numpy(md.reference_tables(), dev)
    bd = torch.zeros(G, dtype=torch.bool, device=dev)
    bd[0] = True

    def err(pairs):
        e = max(float((a - w).abs().max()) for a, w in pairs)
        peak = float(pairs[0][1].abs().max())
        return e, e <= 2e-5 * max(1.0, peak), all(
            _bits_equal(a, w) for a, w in pairs)

    hyb = (x, b, m, bd, None, dense.hybrid, dense.cs, dense.ca, dense.finv)
    S, tail = md.mp3_hybrid(*hyb)
    S_ref, tail_ref = md.mp3_hybrid_plain(*hyb)
    e_m1, ok_m1, bits_m1 = err([(S, S_ref), (tail, tail_ref)])
    syn = (S, dense.matrixing, dense.window, None, bd)
    pcm, st = md.mp3_synth(*syn)
    pcm_ref, st_ref = md.mp3_synth_plain(*syn)
    e_m2, ok_m2, bits_m2 = err([(pcm, pcm_ref), (st, st_ref)])

    track = rs[0].default_track()
    table, size = md.place_table(
        [G], [batch._trim_bounds(576 * G, track, True)], 1)
    tab = torch.from_numpy(table).to(dev)
    rows = md.place_rows(table, 0, G)
    placed = torch.full((size,), float("nan"), device=dev)
    md.mp3_place(pcm, tab, placed, 0, rows)
    twin = md.mp3_place_plain(pcm, table, torch.full(
        (size,), float("nan"), device=dev), 0, rows)
    want = batch._gapless_trim(pcm.cpu().numpy().transpose(1, 0, 2)
                               .reshape(1, -1), track, True)
    got = placed.cpu().numpy()
    bits_m3_twin = (_bits_equal(placed, twin)
                    and not np.isnan(got).any())
    bits_m3_host = np.array_equal(got.reshape(1, -1).view(np.uint32),
                                  want.view(np.uint32))
    decoded = batch.decode_many([datas[k]], device=dev)[0].samples
    bits_decode = np.array_equal(decoded.view(np.uint32),
                                 got.reshape(decoded.shape).view(np.uint32)
                                 ) if decoded.size == got.size else False

    # Times and bounds at the request's shape.
    F = int(pl.frames.shape[0])
    frame_bytes = int(pl.frames[:, 1].sum())

    def m0():
        return me.mp3_entropy(*inputs, tabs, pl.n_lanes)

    def m3():
        return md.mp3_place(pcm, tab, placed, 0, rows)

    kernels = {
        "mp3_entropy": dict(
            shape=[F, pl.n_lanes], ms=cuda_ms(m0, 20),
            enqueue_ms=enqueue_ms(m0, 20), bound_by="bytes",
            bound_ms=(frame_bytes + pl.n_lanes * (576 * 4 + 8))
            / HBM_BYTES_PER_S * 1e3),
        "mp3_hybrid": dict(
            shape=[G, 1, 576], max_abs_err=e_m1, bits_equal_twin=bits_m1,
            run=md.run_length(G, 1), ms=cuda_ms(lambda: md.mp3_hybrid(*hyb),
                                                20),
            graph_ms=graph_ms(lambda: md.mp3_hybrid(*hyb), 20),
            enqueue_ms=enqueue_ms(lambda: md.mp3_hybrid(*hyb), 20),
            graph_ms_by_run={f"run{r}": graph_ms(
                lambda: md.mp3_hybrid(*hyb, run=r), 20)
                for r in md.RUN_LENGTHS},
            **bound(*work_mp3_hybrid(G, 1))),
        "mp3_synth": dict(
            shape=[G, 1, 576], max_abs_err=e_m2, bits_equal_twin=bits_m2,
            ms=cuda_ms(lambda: md.mp3_synth(*syn), 20),
            graph_ms=graph_ms(lambda: md.mp3_synth(*syn), 20),
            enqueue_ms=enqueue_ms(lambda: md.mp3_synth(*syn), 20),
            **bound(*work_mp3_synth(G, 1))),
        "mp3_place": dict(
            shape=[G, 1, 576], bits_equal_twin=bits_m3_twin,
            bits_equal_host=bits_m3_host, ms=cuda_ms(m3, 20),
            graph_ms=graph_ms(m3, 20), enqueue_ms=enqueue_ms(m3, 20),
            bound_ms=2 * 4 * size / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes"),
    }
    info = dict(
        clip=dict(index=k, seconds=pool[k].seconds, frames=F, granules=G,
                  frame_bytes=frame_bytes, samples=size,
                  reservoir_bytes=reach[k][0],
                  reservoir_frames=reach[k][1]),
        pool=dict(clips=pool_size, mean_s=mean / gen.SAMPLE_RATE,
                  reservoir_bytes_max=max(r[0] for r in reach),
                  reservoir_frames_max=max(r[1] for r in reach)),
        checked={n: {f: v[f] for f in ("clips", "frames", "lanes", "values",
                                       "ulp1")} for n, v in checks.items()},
        decode_many_bits_equal=bits_decode, kernels=kernels,
        launches=dict(_build.LAUNCHES), card=card_line())
    print("phase 14 mp3_speech:", json.dumps(info), flush=True)
    if not (ok_m1 and ok_m2):
        raise AssertionError(f"mp3 kernels vs twins at the speech request: "
                             f"M1 {e_m1} M2 {e_m2}")
    if not (bits_m3_twin and bits_m3_host and bits_decode):
        raise AssertionError("mp3_place or decode_many differs at the "
                             "speech request")
    return info


# Phase 15: the host walk over a fma_mp3.shard32 request's 32 clips and a
# pool of 16 commonvoice_mp3 clips, each pass timed MPA_WALK_PASSES times.
MPA_WALK_FMA_CLIPS = 32
MPA_WALK_SPEECH_CLIPS = 16
MPA_WALK_PASSES = 5


def phase_mpa_walk(fma_clips: int = MPA_WALK_FMA_CLIPS,
                   speech_clips: int = MPA_WALK_SPEECH_CLIPS,
                   passes: int = MPA_WALK_PASSES,
                   device: str = "cuda") -> dict:
    """The frame-table walk of each clip on the card machine's host:
    a seeded fma_mp3.shard32 request and a commonvoice_mp3 pool, each clip
    from where the probe starts its reader (after the ID3v2 tag). Per clip,
    the best of ``passes`` passes, in ms: the verbatim ``MpaReader`` built,
    ``mpa_walk.MpaReader`` built, the remainder read through the
    ``MediaSourceStream`` alone (what both readers do first) and the
    compiled walk alone; both readers' frame tables, first headers and
    tracks equal. ``device`` (the generators' device) is "cuda" but for a
    rehearsal on the CPU."""
    import torch

    from benchmark.gen import mp3 as gen_fma
    from benchmark.gen import mp3_speech as gen_speech
    from symphonia_tpu_torch import batch, mpa_walk
    from symphonia_tpu_torch.core.io import MediaSourceStream
    from symphonia_tpu_torch.formats.mpa import MpaReader

    dev = torch.device(device)
    lib = mpa_walk._lib()
    if lib is None:
        raise AssertionError("mpa_walk: the compiled walk did not build")

    def cfg(name):
        return json.loads(open(os.path.join(
            ROOT, "benchmark", "configs", f"{name}.json")).read())

    pools = {
        "fma_mp3": [s.data for s in gen_fma.make_pool(
            cfg("fma_mp3"), fma_clips, SEED + 25, device=dev)],
        "commonvoice_mp3": [s.data for s in gen_speech.make_pool(
            cfg("commonvoice_mp3"), speech_clips, SEED + 26, device=dev)]}

    def read(mss):
        chunks = []
        while True:
            b = mss.read_upto(1 << 22)
            if not b:
                return b"".join(chunks)
            chunks.append(b)

    def best_ms(fn, datas):
        best = float("inf")
        for _ in range(passes):
            t0 = time.perf_counter()
            for d in datas:
                fn(d)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3 / len(datas)

    info = {}
    for name, datas in pools.items():
        # The bytes each reader walks: the probe starts it after the tag.
        audio = [d[batch._probe(d)[1]._start:] for d in datas]
        equal = True
        frames = 0
        for d in audio:
            ref = MpaReader(MediaSourceStream(d))
            port = mpa_walk.MpaReader(MediaSourceStream(d))
            equal = equal and (
                np.array_equal(ref._offsets, port._offsets)
                and np.array_equal(ref._sizes, port._sizes)
                and ref.header == port.header and ref._track == port._track)
            frames += len(ref._offsets)
        bufs = [read(MediaSourceStream(d)) for d in audio]
        info[name] = dict(
            clips=len(audio), frames=frames,
            bytes=sum(len(d) for d in audio), tables_equal=equal,
            verbatim_ms=best_ms(lambda d: MpaReader(MediaSourceStream(d)),
                                audio),
            compiled_ms=best_ms(
                lambda d: mpa_walk.MpaReader(MediaSourceStream(d)),
                audio),
            read_ms=best_ms(lambda d: read(MediaSourceStream(d)), audio),
            walk_ms=best_ms(lambda b: mpa_walk.walk(lib, b), bufs))
        info[name]["speedup"] = (info[name]["verbatim_ms"]
                                 / info[name]["compiled_ms"])
    info["card"] = card_line() if device == "cuda" else None
    print("phase 15 mpa_walk:", json.dumps(info), flush=True)
    bad = sorted(n for n in pools if not info[n]["tables_equal"])
    if bad:
        raise AssertionError(f"mpa_walk: the compiled walk's table differs "
                             f"from the verbatim reader's on {bad}")
    return info


# Phase 16: the musdb_flac.tracks8 request (the cell's 8 tracks, one
# seed), each way of placing its MD5 timed MUSDB_PASSES times; F2 at one
# stereo lane chunk's shape; F3 at two channels over streams that cross
# lane chunks (samples a stream, frames of 4,096).
MUSDB_TRACKS = 8
MUSDB_PASSES = 3
MUSDB_F2_SHAPE = (4096, 2, 4096)
MUSDB_MD5_LENGTHS = (50_000, 123_457, 8_193, 77_777, 300_001, 4_097)
# The kernels the request's decode_many launches once a lane chunk (F3
# where the rule puts the MD5 on the card).
MUSDB_PATH = ("flac_lane_order", "flac_lpc", "flac_decorrelate", "flac_md5")


def _md5_chain(pool, frames_per_chunk: int) -> dict:
    """The bytes F3 chains at a merged stereo request over ``pool``: its
    frames laid out in lane chunks of ``frames_per_chunk`` by
    ``batch._chunk_runs`` (each track spread over them in proportion),
    each chunk's launch as long as the most bytes one track hashes in it,
    the chunks one after another."""
    from symphonia_tpu_torch import batch

    runs = batch._chunk_runs([len(s.blocks) for s in pool], frames_per_chunk)
    ends = np.cumsum(runs, axis=1)
    part = np.stack([
        np.diff(np.concatenate([[0], np.cumsum(s.blocks)])[
            np.concatenate([[0], e])]) * 2 * ((s.bits + 7) // 8)
        for s, e in zip(pool, ends)])
    return dict(chain_bytes=int(part.max(0).sum()), chunks=runs.shape[1])


def _traced_md5(fn, dev) -> dict:
    """One call of ``fn`` under ``torch.profiler``, the port's spans and
    counters on: F3's device time (its kernel's rows; None without a
    device trace) and the request's ``md5_card_bytes`` and
    ``md5_chain_bytes``."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symphonia_tpu_torch import trace

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    trace.reset()
    with profile(activities=acts) as prof:
        fn()
    counts = Counter()
    for r in trace.requests():
        counts.update(r.counters)
    trace.reset()
    us = [getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0))
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "flac_md5" in e.key]
    return dict(f3_ms=sum(us) / 1e3 if us else None,
                md5_card_bytes=counts["md5_card_bytes"],
                md5_chain_bytes=counts["md5_chain_bytes"])


def phase_musdb_flac(tracks: int = MUSDB_TRACKS, seconds=None,
                     passes: int = MUSDB_PASSES,
                     f2_shape=MUSDB_F2_SHAPE,
                     md5_lengths=MUSDB_MD5_LENGTHS, device: str = "cuda"
                     ) -> dict:
    """The stereo FLAC path at the musdb_flac.tracks8 request: the
    configuration's seeded pool of ``tracks`` 44.1 kHz stereo tracks (two
    of eight at 24 bits), all in one ``decode_many(verify=True)``, every
    sample equal to the source and every ``md5_ok`` True; the request
    timed (wall ms, best of ``passes`` after a first call) with its MD5
    placed as the rule places it, on the card (F3) and on the host, each
    placement's answers checked, and the rule's decision with the bytes
    it weighed and the bytes F3 chains over the lane chunks (each track
    spread over them by ``batch._chunk_runs``); one more request under
    ``torch.profiler``: F3's device time and the port's counters
    ``md5_card_bytes`` and ``md5_chain_bytes``, held to the bytes hashed
    and chained. F2 at
    ``f2_shape`` (one stereo lane chunk; 25-bit values, every assignment)
    against its plain twin on the card, bit for bit, with both times
    beside its bound. F3 at two channels, 2 and 3 bytes a sample, over
    streams of ``md5_lengths`` samples cut into three lane chunks that
    split them, against hashlib. The launches are those of the request's
    first ``decode_many`` alone: F1, its helper, F2 and F3 once a lane
    chunk. ``seconds`` (min, max) shortens the tracks and ``device`` is
    "cuda" but for a rehearsal on the CPU."""
    import torch

    from benchmark.gen import flac_music as gen
    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import flac_dense as fd

    dev = torch.device(device)
    cfg = json.loads(open(os.path.join(
        ROOT, "benchmark", "configs", "musdb_flac.json")).read())
    if seconds is not None:
        cfg["duration_s"].update(min=seconds[0], max=seconds[1])
    t0 = time.perf_counter()
    pool = gen.make_pool(cfg, tracks, SEED + 27, device=dev)
    gen_s = time.perf_counter() - t0
    datas = [s.data for s in pool]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    real_rule = batch._md5_on_card
    seen = []

    def decode(on_card):
        """decode_many over the request, the placement forced (None: the
        rule's) -> (outputs, wall ms)."""
        def rule(nbytes):
            d = real_rule(nbytes) if on_card is None else on_card
            seen.append(dict(total_bytes=int(sum(nbytes)),
                             max_bytes=int(max(nbytes)), card=bool(d)))
            return d
        batch._md5_on_card = rule
        try:
            t = time.perf_counter()
            outs = batch.decode_many(datas, device=device, verify=True)
            sync()
            return outs, (time.perf_counter() - t) * 1e3
        finally:
            batch._md5_on_card = real_rule

    def answers(outs) -> dict:
        return dict(
            mismatched=sum(int(np.count_nonzero(o.samples != s.pcm))
                           if o.samples.shape == s.pcm.shape else -1
                           for o, s in zip(outs, pool)),
            md5_ok=all(o.md5_ok is True for o in outs))

    _build.reset_launches()
    outs, first_ms = decode(None)
    launches = dict(_build.LAUNCHES)
    exact = answers(outs)
    rule = dict(seen[-1], **_md5_chain(pool, batch.FlacBatchDecoder(
        device=device).lane_chunk // 2))
    del outs
    placements = {}
    for name, on_card in (("rule", None), ("card", True), ("host", False)):
        ms = []
        for _ in range(passes):
            outs, t = decode(on_card)
            ms.append(t)
        placements[name] = dict(ms=ms, best_ms=min(ms), **answers(outs))
        del outs
    faster = min(("card", "host"), key=lambda k: placements[k]["best_ms"])
    traced = _traced_md5(lambda: decode(None), dev)

    # F2 at one stereo lane chunk's shape, against its twin.
    F, _, n = f2_shape
    rng = np.random.default_rng(SEED + 28)
    x = torch.from_numpy(rng.integers(-(1 << 24), 1 << 24, size=f2_shape)
                         .astype(np.int32)).to(dev)
    a = torch.from_numpy(rng.integers(0, 4, size=F).astype(np.int32)).to(dev)
    f2_equal = torch.equal(fd.decorrelate_batch(x, a),
                           fd.decorrelate_plain(x, a))
    f2 = dict(shape=list(f2_shape), bits_equal_twin=bool(f2_equal),
              ms=cuda_ms(lambda: fd.decorrelate_batch(x, a), 20),
              plain_ms=cuda_ms(lambda: fd.decorrelate_plain(x, a), 3),
              **bound(16 * F * n + 4 * F, 0))
    del x, a

    # F3 at two channels across lane chunks, against hashlib.
    f3 = {}
    for bps in (16, 24):
        trims = [m - (k % 3) * 5 for k, m in enumerate(md5_lengths)]
        case = _md5_case(md5_lengths, 2, bps, [4096], trims, SEED + bps, dev)
        Fm = case["x"].shape[0]
        cuts = (Fm // 3, 2 * Fm // 3)
        got = _md5_run(case, dev, cuts=cuts).digests()
        f3[f"width{(bps + 7) // 8}"] = dict(
            streams=len(md5_lengths), frames=Fm, chunks=len(cuts) + 1,
            equal_hashlib=got == case["want"])

    info = dict(
        tracks=len(pool), bits=[s.bits for s in pool],
        seconds=sum(s.seconds for s in pool),
        frames=sum(len(s.blocks) for s in pool),
        bytes=sum(len(d) for d in datas),
        message_bytes=sum(s.pcm.size * ((s.bits + 7) // 8) for s in pool),
        assign_mix=np.bincount(np.concatenate(
            [s.frames["assign"] for s in pool]), minlength=4).tolist(),
        bits_per_sample=8 * sum(len(d) for d in datas) / sum(
            s.pcm.size for s in pool),
        generate_s=gen_s, first_ms=first_ms, exact=exact, rule=rule,
        placements=placements, faster=faster, traced=traced,
        rule_picks_faster=rule["card"] == (faster == "card"),
        decorrelate=f2, md5=f3, launches=launches,
        card=card_line() if device == "cuda" else None)
    print("phase 16 musdb_flac:", json.dumps(info), flush=True)
    bad = [k for k in ("rule", "card", "host")
           if placements[k]["mismatched"] or not placements[k]["md5_ok"]]
    if exact["mismatched"] or not exact["md5_ok"] or bad:
        raise AssertionError(f"decode_many differs from the source at the "
                             f"musdb_flac request (placements {bad})")
    if not f2_equal:
        raise AssertionError("flac_decorrelate differs from its twin")
    if not all(v["equal_hashlib"] for v in f3.values()):
        raise AssertionError("flac_md5 at two channels differs from "
                             "hashlib")
    want = (info["message_bytes"], rule["chain_bytes"]) if rule["card"] \
        else (0, 0)
    if (traced["md5_card_bytes"], traced["md5_chain_bytes"]) != want:
        raise AssertionError(f"flac_md5's counters at the musdb_flac "
                             f"request: {traced}, not {want}")
    want = {k: rule["chunks"] for k in MUSDB_PATH}
    if not rule["card"]:
        want["flac_md5"] = 0
    off = {k: launches[k] for k in want if launches[k] != want[k]}
    if off:
        raise AssertionError(f"decode_many's launches at the musdb_flac "
                             f"request, {rule['chunks']} lane chunks: {off}")
    return info


def _decode_or_error(batch, soak, data: bytes, device: str):
    """``decode_bytes``'s samples on ``device``, or the name of the
    taxonomy error it raised."""
    try:
        return batch.decode_bytes(data, device=device).samples
    except soak.OK_ERRORS as e:
        return type(e).__name__


def _card_vs_cpu(row: dict, card, cpu) -> dict:
    """``row`` with the comparison of the card's samples with the CPU's (or
    the CPU's error): integer samples bit for bit, float samples within
    2e-5 x max(1, peak |sample|)."""
    row.update(shape=list(card.shape), dtype=str(card.dtype))
    if isinstance(cpu, str) or cpu.shape != card.shape or (
            cpu.dtype != card.dtype):
        row.update(ok=False, cpu=cpu if isinstance(cpu, str) else
                   list(cpu.shape))
    elif np.issubdtype(card.dtype, np.integer):
        row["ok"] = bool(np.array_equal(cpu, card))
    else:
        err = float(np.abs(cpu.astype(np.float64) - card).max(initial=0.0))
        peak = float(np.abs(cpu).max(initial=0.0))
        row.update(max_abs_err=err, peak=peak,
                   rel_err=err / max(1.0, peak),
                   ok=bool(err <= 2e-5 * max(1.0, peak)),
                   bits_equal=bool(np.array_equal(cpu, card)))
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    _paths()
    t_start = time.perf_counter()
    wall = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[name] = round(time.perf_counter() - t0, 1)
        return out

    env = timed("1", phase_env)
    kern = timed("2", phase_kernels)
    kern.update(timed("2_aac", phase_aac_kernels))
    kern.update(timed("2_vorbis_l12", phase_vorbis_l12_kernels))
    kern.update(timed("2_pcm", phase_pcm_kernel))
    inputs = timed("inputs", build_inputs)
    sl = timed("3", phase_slice, inputs)
    gd = timed("10", phase_golden, inputs[7])
    pb = timed("4", phase_pcm_batch, inputs)
    del inputs
    rb = timed("5", phase_rice_bench)
    kern["rice_decode"] = rb["kernel"]
    st = timed("6", phase_entry_step, kern["flac_lpc"]["imad_macs_per_s"])
    bn = timed("7", phase_bench)
    sk = timed("8", phase_soak)
    mc = timed("9", phase_multichip)
    m5 = timed("11", phase_md5)
    kern["flac_md5"] = dict(max_abs_err=0, plain_ms=None, library_ms=None,
                            **{k: m5[k] for k in (
                                "ms", "bound_ms", "bound_by", "shape",
                                "enqueue_ms", "attributes")})
    m0 = timed("12", phase_mp3_entropy)
    kern["mp3_entropy"] = dict(max_abs_err=0, plain_ms=None,
                               library_ms=None, **{k: m0[k] for k in (
                                   "ms", "bound_ms", "bound_by", "shape",
                                   "enqueue_ms", "attributes")})
    m3 = timed("13", phase_mp3_place)
    kern["mp3_place"] = dict(max_abs_err=0, plain_ms=None, library_ms=None,
                             **{k: m3[k] for k in (
                                 "ms", "graph_ms", "bound_ms", "bound_by",
                                 "shape", "enqueue_ms", "bits_equal_twin",
                                 "attributes")})
    m4 = timed("14", phase_mp3_speech)
    timed("15", phase_mpa_walk)
    m16 = timed("16", phase_musdb_flac)
    paths = {"decode_many": sl["launches"], "golden": gd["launches"],
             "pcm_batch": pb["launches"],
             "rice_bench": rb["launches"], "entry_step": st["launches"],
             "entry_step_handoff": st["handoff_launches"],
             "bench": bn["launches"], "soak": sk["launches"],
             "multichip": mc["launches"], "md5": m5["launches"],
             "mp3_entropy": m0["launches"], "mp3_place": m3["launches"],
             "mp3_speech": m4["launches"], "musdb_flac": m16["launches"]}
    rows = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        k = kern[name]
        by_path = {p: counts[name] for p, counts in paths.items()}
        if sum(by_path.values()) <= 0:
            raise AssertionError(f"{name} was launched on no path")
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"], "shape": k["shape"],
                     # A1 and V1: cuBLAS on their half product; A1, V1, M2
                     # and L1: the dense product's bound; M1, M2, L1, A3
                     # and R1: the device time with the host's launch cost
                     # out; F1, its helper, M1, M2, A3 and R1: the host's
                     # time to enqueue a call; M1, A3 and R1: bit-equality
                     # with the twin; F1, P1, M1, A3 and R1: registers,
                     # spills and blocks an SM; R1: each shape's numbers.
                     **{f: k[f] for f in ("library_half_ms", "dense_bound_ms",
                                          "graph_ms", "enqueue_ms",
                                          "bits_equal_twin", "attributes",
                                          "by_shape")
                        if f in k}})
    print(f"chip_smoke: phases 1-16 in {time.perf_counter() - t_start:.1f} s "
          f"(s by phase: {json.dumps(wall)})", flush=True)
    print(env["card"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
