"""ctypes loader for the native host library (native/symphonia_host.cpp).

The native library implements the host-side hot loops (FLAC frame scan +
entropy extraction, bulk CRCs) that feed the batched device kernels. Built
on demand with g++; every entry point has a pure-Python fallback so the
framework works without a toolchain.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_DISABLED = False


@contextlib.contextmanager
def disabled():
    """Context manager that disables every native fast path (each wrapper's
    _load() returns None), forcing the pure-Python oracle paths. Used by
    tools/check.py --ref cross as the independent second implementation.
    Decoders constructed inside the context stay on the Python path for
    their lifetime (they cache the fast-path decision at first decode)."""
    global _DISABLED
    old = _DISABLED
    _DISABLED = True
    try:
        yield
    finally:
        _DISABLED = old

_ROOT = Path(__file__).resolve().parent.parent
_SRCS = [_ROOT / "native" / "symphonia_host.cpp",
         _ROOT / "native" / "mp3_entropy.cpp",
         _ROOT / "native" / "aac_entropy.cpp",
         _ROOT / "native" / "vorbis_entropy.cpp",
         _ROOT / "native" / "alac_decode.cpp",
         _ROOT / "native" / "adpcm_loops.cpp",
         _ROOT / "native" / "mpa_layer12.cpp",
         _ROOT / "native" / "mp3_dense.cpp"]
_HDRS = [_ROOT / "native" / "entropy_common.h",
         _ROOT / "native" / "mp3_tables.h"]
_SO = _ROOT / "native" / "libsymphonia_host.so"


def _build() -> bool:
    if not all(s.exists() for s in _SRCS):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", str(_SO)] + [str(s) for s in _SRCS],
            check=True, capture_output=True, timeout=300,
        )
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _DISABLED:
        return None
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    # Override hook for instrumented builds (tools/asan_fuzz.sh): load the
    # given .so verbatim, no mtime rebuild.
    override = os.environ.get("SYMPHONIA_TPU_NATIVE_SO")
    so_path = Path(override) if override else _SO
    if not override:
        stale = not _SO.exists() or any(
            s.exists() and s.stat().st_mtime > _SO.stat().st_mtime
            for s in _SRCS + _HDRS
        )
        if stale:
            if not _build():
                return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sh_crc8.restype = ctypes.c_uint32
    lib.sh_crc8.argtypes = [c_u8p, ctypes.c_int64]
    try:
        lib.sh_codebook_assign.restype = ctypes.c_int32
        lib.sh_codebook_assign.argtypes = [
            c_i32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)]
    except AttributeError:
        pass
    try:
        lib.sh_crc8_init.restype = ctypes.c_uint32
        lib.sh_crc8_init.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_uint32]
    except AttributeError:
        pass
    lib.sh_crc16.restype = ctypes.c_uint32
    lib.sh_crc16.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_uint32]
    lib.sh_crc32.restype = ctypes.c_uint32
    lib.sh_crc32.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_uint32]
    lib.sh_flac_scan.restype = ctypes.c_int64
    lib.sh_flac_scan.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, c_i64p, ctypes.c_int64,
    ]
    lib.sh_flac_extract.restype = ctypes.c_int32
    lib.sh_flac_extract.argtypes = [
        c_u8p, ctypes.c_int64, c_i64p, c_i64p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
    ]
    lib.sh_flac_has_simd.restype = ctypes.c_int32
    lib.sh_flac_has_simd.argtypes = []
    try:
        lib.sh_flac_scan_fast.restype = ctypes.c_int64
        lib.sh_flac_scan_fast.argtypes = lib.sh_flac_scan.argtypes
    except AttributeError:
        pass
    try:
        lib.sh_flac_extract_simd.restype = ctypes.c_int32
        lib.sh_flac_extract_simd.argtypes = lib.sh_flac_extract.argtypes
    except AttributeError:
        pass
    try:
        lib.sh_flac_decode_frame.restype = ctypes.c_int32
        lib.sh_flac_decode_frame.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, c_i32p, c_i32p,
        ]
    except AttributeError:
        pass  # older .so without the per-packet FLAC stage
    lib.sh_flac_stream_extract.restype = ctypes.c_int32
    lib.sh_flac_stream_extract.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i64p,
    ]
    lib.sh_aac_set_codebook.restype = None
    lib.sh_aac_set_codebook.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint32), c_i32p,
    ]
    lib.sh_aac_extract.restype = ctypes.c_int32
    lib.sh_aac_extract.argtypes = [
        c_u8p, ctypes.c_int64, c_i64p, c_i64p, ctypes.c_int32,
        ctypes.c_int32, c_i32p, ctypes.c_int32, c_i32p, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_float), c_i32p,
        c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
    ]
    try:
        c_f32p2 = ctypes.POINTER(ctypes.c_float)
        lib.sh_aac_stream_open.restype = ctypes.c_void_p
        lib.sh_aac_stream_open.argtypes = []
        lib.sh_aac_stream_close.restype = None
        lib.sh_aac_stream_close.argtypes = [ctypes.c_void_p]
        lib.sh_aac_stream_reset.restype = None
        lib.sh_aac_stream_reset.argtypes = [ctypes.c_void_p]
        lib.sh_aac_stream_decode.restype = ctypes.c_int32
        lib.sh_aac_stream_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            c_i32p, ctypes.c_int32, c_i32p, ctypes.c_int32, ctypes.c_int32,
            c_f32p2, ctypes.POINTER(ctypes.c_int16), c_f32p2,
            c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
        ]
        lib.sh_aac_set_windows.restype = None
        lib.sh_aac_set_windows.argtypes = [c_f32p2, c_f32p2, c_f32p2, c_f32p2]
        lib.sh_aac_stream_decode_pcm.restype = ctypes.c_int32
        lib.sh_aac_stream_decode_pcm.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            c_i32p, ctypes.c_int32, c_i32p, ctypes.c_int32, ctypes.c_int32,
            c_f32p2, c_f32p2, c_i32p, c_i32p, c_i32p,
        ]
    except AttributeError:
        pass  # older .so without the AAC stream stage
    lib.sh_vorbis_open.restype = ctypes.c_void_p
    lib.sh_vorbis_open.argtypes = [c_u8p, ctypes.c_int64]
    lib.sh_vorbis_close.restype = None
    lib.sh_vorbis_close.argtypes = [ctypes.c_void_p]
    lib.sh_vorbis_decode.restype = ctypes.c_int32
    lib.sh_vorbis_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, c_i64p, c_i64p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), c_i32p, c_i32p,
    ]
    try:
        lib.sh_vorbis_decode_pcm.restype = ctypes.c_int32
        # data as c_char_p: bytes pass pointer-directly, no frombuffer/
        # cast per packet (this call sits on the per-packet hot path).
        lib.sh_vorbis_decode_pcm.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            c_i32p, c_i32p, c_i32p,
        ]
        lib.sh_vorbis_reset.restype = None
        lib.sh_vorbis_reset.argtypes = [ctypes.c_void_p]
    except AttributeError:
        pass  # older .so without the vorbis synthesis stage
    try:
        lib.sh_vorbis_set_tables.restype = None
        lib.sh_vorbis_set_tables.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.sh_vorbis_open_hdrs.restype = ctypes.c_void_p
        lib.sh_vorbis_open_hdrs.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.sh_vorbis_mode_flags.restype = ctypes.c_int32
        lib.sh_vorbis_mode_flags.argtypes = [ctypes.c_void_p, c_i32p]
    except AttributeError:
        pass  # older .so without the native setup parser
    try:
        lib.sh_alac_decode.restype = ctypes.c_int32
        lib.sh_alac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            c_i32p, c_i32p,
        ]
    except AttributeError:
        pass  # older .so without the ALAC stage
    try:
        lib.sh_ima_decode_nibbles.restype = None
        lib.sh_ima_decode_nibbles.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, c_i32p]
        lib.sh_ms_decode_nibbles.restype = None
        lib.sh_ms_decode_nibbles.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int32, c_i32p, c_i32p,
            c_i64p, c_i64p, c_i64p, c_i32p, ctypes.c_int64]
    except AttributeError:
        pass  # older .so without the ADPCM loops
    try:
        c_f64p = ctypes.POINTER(ctypes.c_double)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.sh_mpa_l1_extract.restype = ctypes.c_int32
        lib.sh_mpa_l1_extract.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            c_f64p, c_f32p]
        lib.sh_mpa_l2_extract.restype = ctypes.c_int32
        lib.sh_mpa_l2_extract.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, c_i32p, c_f64p, c_f32p]
        lib.sh_l12_stream_decode.restype = ctypes.c_int32
        lib.sh_l12_stream_decode.argtypes = [
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, c_i32p, c_f64p, c_f32p, c_f32p]
    except AttributeError:
        pass  # older .so without the L1/L2 stage
    try:
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.sh_mp3_set_dense.restype = None
        lib.sh_mp3_set_dense.argtypes = [
            c_f32p, c_f32p, c_f32p, c_i32p, c_f32p, c_f32p]
        lib.sh_mp3_dense_ready.restype = ctypes.c_int32
        lib.sh_mp3_dense_ready.argtypes = []
        lib.sh_mp3_dense_granule.restype = ctypes.c_int32
        lib.sh_mp3_dense_granule.argtypes = [
            c_f32p, ctypes.c_int32, ctypes.c_int32, c_f32p, c_f32p, c_f32p]
        lib.sh_mp3_polyphase.restype = ctypes.c_int32
        lib.sh_mp3_polyphase.argtypes = [c_f32p, ctypes.c_int32, c_f32p]
        lib.sh_mp3_stream_open.restype = ctypes.c_void_p
        lib.sh_mp3_stream_open.argtypes = []
        lib.sh_mp3_stream_close.restype = None
        lib.sh_mp3_stream_close.argtypes = [ctypes.c_void_p]
        lib.sh_mp3_stream_reset.restype = None
        lib.sh_mp3_stream_reset.argtypes = [ctypes.c_void_p]
        lib.sh_mp3_stream_decode.restype = ctypes.c_int32
        lib.sh_mp3_stream_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            c_f32p, c_f32p, c_f32p]
    except AttributeError:
        pass  # older .so without the dense stage
    lib.sh_mp3_extract.restype = ctypes.c_int32
    lib.sh_mp3_extract.argtypes = [
        c_u8p, ctypes.c_int64, c_i64p, c_i64p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), c_i32p, c_i32p, c_i32p, c_i32p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def codebook_assign(lengths) -> "Optional[tuple]":
    """Canonical Vorbis codeword assignment (sh_codebook_assign): exact
    mirror of ``Codebook.from_lengths_canonical``'s branch-splitting loop
    (hot at every Vorbis decoder construction). Returns (codes uint32,
    status) or None when the library is unavailable. Status: 0 ok,
    1 over-specified, 2 under-specified, 3 invalid length."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_codebook_assign"):
        return None
    l = np.ascontiguousarray(lengths, dtype=np.int32)
    codes = np.zeros(len(l), dtype=np.uint32)
    st = lib.sh_codebook_assign(
        l.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(l),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return codes, int(st)


def crc16(data: bytes, init: int = 0) -> int:
    lib = _load()
    a = np.frombuffer(data, dtype=np.uint8)
    return int(lib.sh_crc16(_u8ptr(a), len(a), init))


def _pad_rows(n_max: int) -> int:
    """Row-stride anti-aliasing: block-capacity rows of exactly 4 KiB
    multiples put every SIMD lane's scatter cursor at the same low-12
    address bits and the store buffer's 4K-aliasing disambiguation
    serializes them (measured 2589x -> 8187x on a 16-lane probe, +7.5%
    on the shipped 8-lane engine). decode_packed consumes the padded
    width via packed["n_max"]."""
    return n_max + 16 if (n_max * 4) % 4096 == 0 else n_max


def flac_scan_frames_fast(buf: bytes, si) -> Optional[np.ndarray]:
    """AVX-512 sync-byte scan with sequence-chain filtering
    (sh_flac_scan_fast). Much faster than the CRC-16 chain scan but drops
    everything after a corrupt frame header instead of re-anchoring —
    callers must validate the result (timestamp contiguity vs STREAMINFO)
    and fall back to :func:`flac_scan_frames` on any inconsistency."""
    lib = _load()
    if lib is None or not lib.sh_flac_has_simd():
        return None
    a = np.frombuffer(buf, dtype=np.uint8)
    cap = max(16, len(buf) // 16)
    while True:
        out = np.zeros(cap, dtype=np.int64)
        n = lib.sh_flac_scan_fast(
            _u8ptr(a), len(a), si.channels, si.bits_per_sample,
            si.sample_rate, si.block_len_max,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        )
        if n < cap or cap >= len(buf):
            return out[:n].copy()
        cap = min(max(cap * 4, 16), max(len(buf), 16))


def flac_scan_frames(buf: bytes, si) -> np.ndarray:
    """Native frame-boundary scan; mirrors formats.flac.scan_frames."""
    lib = _load()
    a = np.frombuffer(buf, dtype=np.uint8)
    # Frames can be smaller than 16 bytes (tiny blocks, constant subframes),
    # so a len//16 guess may hit the cap; grow and rescan until it fits.
    cap = max(16, len(buf) // 16)
    while True:
        out = np.zeros(cap, dtype=np.int64)
        n = lib.sh_flac_scan(
            _u8ptr(a), len(a), si.channels, si.bits_per_sample,
            si.sample_rate, si.block_len_max,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        )
        if n < cap or cap >= len(buf):
            return out[:n].copy()
        cap = min(max(cap * 4, 16), max(len(buf), 16))


def flac_extract(buf: bytes, offsets: np.ndarray, sizes: np.ndarray, si,
                 n_max: int, use_simd: bool = True):
    """Native entropy extraction -> packed tensors (ops.flac_dense layout).

    Returns a dict compatible with ops.flac_dense.decode_packed, or None if
    the native library is unavailable.
    """
    n_max = _pad_rows(n_max)
    lib = _load()
    if lib is None:
        return None
    a = np.frombuffer(buf, dtype=np.uint8)
    F = len(offsets)
    C = si.channels
    res = np.zeros((F * C, n_max), dtype=np.int32)
    coefs = np.zeros((F * C, 32), dtype=np.int32)
    order = np.zeros(F * C, dtype=np.int32)
    shift = np.zeros(F * C, dtype=np.int32)
    wasted = np.zeros(F * C, dtype=np.int32)
    block = np.zeros(F, dtype=np.int32)
    assign = np.zeros(F, dtype=np.int32)
    bps = np.zeros(F, dtype=np.int32)
    status = np.zeros(F, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn = (lib.sh_flac_extract_simd
          if use_simd and lib.sh_flac_has_simd() else lib.sh_flac_extract)
    fn(
        _u8ptr(a), len(a),
        offsets.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p), F,
        si.channels, si.bits_per_sample, si.sample_rate, si.block_len_max,
        C, n_max,
        res.ctypes.data_as(i32p), coefs.ctypes.data_as(i32p),
        order.ctypes.data_as(i32p), shift.ctypes.data_as(i32p),
        wasted.ctypes.data_as(i32p), block.ctypes.data_as(i32p),
        assign.ctypes.data_as(i32p), bps.ctypes.data_as(i32p),
        status.ctypes.data_as(i32p),
    )
    return {
        "res": res, "coefs": coefs, "order": order, "shift": shift,
        "wasted": wasted, "block": block, "assign": assign, "bps": bps,
        "status": status, "F": F, "C": C, "n_max": n_max,
    }


def flac_decode_frame(data: bytes, si, verify_crc: bool = False):
    """Full single-frame native decode for the per-packet AudioDecoder:
    entropy + predictor + decorrelation -> (pcm int32 [C, block], bps).
    Returns None to fall back to the Python oracle (native unavailable,
    wide streams whose residuals may not fit int32, or any error
    status — malformed-input behavior stays identical via the fallback).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "sh_flac_decode_frame"):
        return None
    if si.bits_per_sample > 25 or si.channels > 8:
        return None
    n_max = max(si.block_len_max, 16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    pcm, p_pcm = _pooled_ptr("flac_pkt_pcm", (si.channels, n_max), np.int32,
                             i32p)
    meta, p_meta = _pooled_ptr("flac_pkt_meta", (3,), np.int32, i32p)
    rc = lib.sh_flac_decode_frame(
        data, len(data), si.channels, si.bits_per_sample, si.sample_rate,
        si.block_len_max, si.channels, n_max, 1 if verify_crc else 0,
        p_pcm, p_meta,
    )
    if rc != 0:
        return None
    return pcm[:, : meta[0]], int(meta[1])


def mp3_extract(buf: bytes, offsets: np.ndarray, sizes: np.ndarray,
                max_granules: int, prep_flags: int = 7):
    """Native Layer III entropy+prep stage -> granule spectra batch.

    Returns dict(spectra [G,2,576] f32, bt [G,2], mixed [G,2],
    gr_frame [G], status [n_frames]) or None if unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    a = np.frombuffer(buf, dtype=np.uint8)
    F = len(offsets)
    # Pooled uninitialized outputs: the C++ writer fills every field the
    # caller reads back ([:g] rows of spectra/bt/mixed/gr_frame for emitted
    # granules, all F status slots), so np.empty reuse is safe. Callers
    # must consume results before the next call (per-packet fast path).
    spectra = _pooled("mp3_spectra", (max_granules, 2, 576), np.float32)
    bt = _pooled("mp3_bt", (max_granules, 2), np.int32)
    mixed = _pooled("mp3_mixed", (max_granules, 2), np.int32)
    gr_frame = _pooled("mp3_gr_frame", (max_granules,), np.int32)
    status = _pooled("mp3_status", (F,), np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    g = lib.sh_mp3_extract(
        _u8ptr(a), len(a), offsets.ctypes.data_as(i64p),
        sizes.ctypes.data_as(i64p), F,
        spectra.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bt.ctypes.data_as(i32p), mixed.ctypes.data_as(i32p),
        gr_frame.ctypes.data_as(i32p), status.ctypes.data_as(i32p),
        max_granules, prep_flags,
    )
    return {
        "spectra": spectra[:g], "bt": bt[:g], "mixed": mixed[:g],
        "gr_frame": gr_frame[:g], "status": status, "n_granules": g,
    }


_MP3_DENSE_SET = False


def _mp3_ensure_dense(lib) -> bool:
    """Register the MP3 dense-stage tables (once) from ops.mp3_dense —
    the numeric source of truth stays in Python."""
    global _MP3_DENSE_SET
    if _MP3_DENSE_SET:
        return True
    if not hasattr(lib, "sh_mp3_set_dense"):
        return False
    from .ops.mp3_dense import (
        antialias_coeffs,
        hybrid_matrices,
        polyphase_matrix,
        synthesis_window,
        _synth_sel_idx,
    )

    f32p = ctypes.POINTER(ctypes.c_float)
    T4 = np.ascontiguousarray(hybrid_matrices(), dtype=np.float32)
    N = np.ascontiguousarray(polyphase_matrix(), dtype=np.float32)
    W = np.ascontiguousarray(synthesis_window(), dtype=np.float32)
    qidx = np.ascontiguousarray(_synth_sel_idx(), dtype=np.int32)
    cs, ca = antialias_coeffs()
    cs = np.ascontiguousarray(cs, dtype=np.float32)
    ca = np.ascontiguousarray(ca, dtype=np.float32)
    lib.sh_mp3_set_dense(
        T4.ctypes.data_as(f32p), N.ctypes.data_as(f32p),
        W.ctypes.data_as(f32p),
        qidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cs.ctypes.data_as(f32p), ca.ctypes.data_as(f32p),
    )
    _MP3_DENSE_SET = True
    return True


def mp3_dense_granule(x: np.ndarray, bt: int, mixed: bool,
                      hybrid_tail: np.ndarray, synth_tail: np.ndarray):
    """Native granule dense stage: [576] spectral -> [576] PCM, updating
    the carried tails in place. Returns the PCM array or None (caller
    falls back to ops.mp3_dense.granule_dense_np)."""
    lib = _load()
    if lib is None or not _mp3_ensure_dense(lib):
        return None
    assert x.dtype == np.float32 and x.flags.c_contiguous
    assert hybrid_tail.dtype == np.float32 and hybrid_tail.flags.c_contiguous
    assert synth_tail.dtype == np.float32 and synth_tail.flags.c_contiguous
    out = np.empty(576, dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.sh_mp3_dense_granule(
        x.ctypes.data_as(f32p), int(bt), int(bool(mixed)),
        hybrid_tail.ctypes.data_as(f32p), synth_tail.ctypes.data_as(f32p),
        out.ctypes.data_as(f32p),
    )
    return out if rc == 0 else None


def mp3_polyphase(S: np.ndarray):
    """Native polyphase: [T, 32] subband samples -> [(T+15)*32] response
    (Layer I/II per-packet path). Returns None if unavailable. The
    returned array is POOLED — callers must copy out what they keep
    before the next call (the L12 synthesize path already does)."""
    lib = _load()
    if lib is None or not _mp3_ensure_dense(lib):
        return None
    T = S.shape[0]
    f32p = ctypes.POINTER(ctypes.c_float)
    Sbuf, p_S = _pooled_ptr(("l12_S", T), (T, 32), np.float32, f32p)
    np.copyto(Sbuf, S)
    resp, p_resp = _pooled_ptr(("l12_resp", T), ((T + 15) * 32,),
                               np.float32, f32p)
    rc = lib.sh_mp3_polyphase(p_S, T, p_resp)
    return resp if rc == 0 else None


class Mp3Stream:
    """Handle for the stateful native per-packet MP3 pipeline (carried bit
    reservoir in C++; entropy + dense fused behind one call per frame)."""

    def __init__(self, lib, ctx):
        self._lib = lib
        self._ctx = ctx
        # (key, pcm_ptr, hybrid_ptr, synth_ptr, strong refs): the decoder
        # passes the same three arrays every call; building the ctypes
        # pointers once keeps the per-packet call overhead flat. The
        # cache assumes a live array's data pointer never moves — callers
        # must not resize(refcheck=False) the cached arrays (the decoder
        # only ever writes them in place).
        self._ptr_cache = None

    def __del__(self):
        if self._ctx:
            self._lib.sh_mp3_stream_close(self._ctx)
            self._ctx = None

    def reset(self) -> None:
        self._lib.sh_mp3_stream_reset(self._ctx)


def mp3_stream_open():
    """Create a native MP3 stream context, or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_mp3_stream_open"):
        return None
    if not _mp3_ensure_dense(lib):
        return None
    ctx = lib.sh_mp3_stream_open()
    return Mp3Stream(lib, ctx) if ctx else None


def mp3_stream_decode(stream: "Mp3Stream", frame: bytes,
                      hybrid_tails: np.ndarray, synth_tails: np.ndarray,
                      pcm_out: np.ndarray) -> int:
    """Decode one whole frame -> PCM via the native stream context.

    hybrid_tails [2,32,18] f32, synth_tails [2,480] f32, pcm_out [2,1152]
    f32, all C-contiguous and caller-owned; tails update in place only on
    success. Returns granule count > 0, or a negative status (same codes
    and reservoir bookkeeping as sh_mp3_extract)."""
    lib = stream._lib
    c = stream._ptr_cache
    key = (id(pcm_out), id(hybrid_tails), id(synth_tails))
    if c is None or c[0] != key:
        f32p = ctypes.POINTER(ctypes.c_float)
        c = (key, pcm_out.ctypes.data_as(f32p),
             hybrid_tails.ctypes.data_as(f32p),
             synth_tails.ctypes.data_as(f32p),
             (pcm_out, hybrid_tails, synth_tails))  # keep ids alive
        stream._ptr_cache = c
    return int(lib.sh_mp3_stream_decode(
        stream._ctx, frame, len(frame), c[1], c[2], c[3]))


_POOL = {}


def _pooled(key, shape, dtype):
    arr = _POOL.get(key)
    if arr is None or arr.shape != shape or arr.dtype != dtype:
        arr = np.empty(shape, dtype)
        _POOL[key] = arr
        _PTRS.pop(key, None)  # keep _pooled_ptr's cache coherent
    return arr


_PTRS = {}


def _pooled_ptr(key, shape, dtype, ctp):
    """_pooled plus a cached ctypes pointer (the data_as/cast dance costs
    ~3 us per array; the per-packet fast paths call in a tight loop).
    Safe to interleave with _pooled on the same key: reallocation by
    either helper invalidates/refreshes the pointer entry."""
    arr = _POOL.get(key)
    ptr = _PTRS.get(key)
    if arr is None or arr.shape != shape or arr.dtype != dtype:
        arr = np.empty(shape, dtype)
        _POOL[key] = arr
        ptr = None
    if ptr is None:
        ptr = arr.ctypes.data_as(ctp)
        _PTRS[key] = ptr
    return arr, ptr


def flac_stream_extract(buf: bytes, si, n_max: int, max_frames: int):
    """Single-pass demux+extract: no separate sync scan or CRC pass.

    Returns a packed dict (ops.flac_dense layout) with 'offsets' added, or
    None if unavailable. Output arrays come from a reuse pool (the C++
    writer initializes every field it reads back), so callers must consume
    them before the next call.
    """
    n_max = _pad_rows(n_max)
    lib = _load()
    if lib is None:
        return None
    a = np.frombuffer(buf, dtype=np.uint8)
    C = si.channels
    res = _pooled("res", (max_frames * C, n_max), np.int32)
    coefs = _pooled("coefs", (max_frames * C, 32), np.int32)
    order = _pooled("order", (max_frames * C,), np.int32)
    shift = _pooled("shift", (max_frames * C,), np.int32)
    wasted = _pooled("wasted", (max_frames * C,), np.int32)
    block = _pooled("block", (max_frames,), np.int32)
    assign = _pooled("assign", (max_frames,), np.int32)
    bps = _pooled("bps", (max_frames,), np.int32)
    offsets = _pooled("offsets", (max_frames,), np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    F = lib.sh_flac_stream_extract(
        _u8ptr(a), len(a), si.channels, si.bits_per_sample, si.sample_rate,
        si.block_len_max, C, n_max, max_frames,
        res.ctypes.data_as(i32p), coefs.ctypes.data_as(i32p),
        order.ctypes.data_as(i32p), shift.ctypes.data_as(i32p),
        wasted.ctypes.data_as(i32p), block.ctypes.data_as(i32p),
        assign.ctypes.data_as(i32p), bps.ctypes.data_as(i32p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return {
        "res": res[: F * C], "coefs": coefs[: F * C], "order": order[: F * C],
        "shift": shift[: F * C], "wasted": wasted[: F * C],
        "block": block[:F], "assign": assign[:F], "bps": bps[:F],
        "offsets": offsets[:F], "status": np.zeros(F, np.int32),
        "F": F, "C": C, "n_max": n_max,
    }


_AAC_BOOKS_SET = False


def _aac_ensure_codebooks(lib) -> None:
    """Register the AAC Huffman books from aac_tables.npz (once)."""
    global _AAC_BOOKS_SET
    if _AAC_BOOKS_SET:
        return
    from .codecs.aac import _tables

    t = _tables()
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def push(idx, codes, lens):
        codes = np.ascontiguousarray(codes, dtype=np.uint32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        lib.sh_aac_set_codebook(idx, len(codes), codes.ctypes.data_as(u32p),
                                lens.ctypes.data_as(i32p))

    push(0, t["scf_codes"], t["scf_lens"])
    for n in range(1, 12):
        push(n, t[f"spec_codes_{n}"], t[f"spec_lens_{n}"])
    _AAC_BOOKS_SET = True


def aac_extract(buf: bytes, offsets: np.ndarray, sizes: np.ndarray,
                rate_idx: int, bands_long, bands_short, max_ch: int):
    """Native AAC-LC entropy stage over raw_data_blocks.

    Returns dict with coeffs [F, max_ch, 1024] f32 (post pulse/TNS/MS/IS;
    valid only where deq == 1), qbuf [F, max_ch, 1024] i16 + scales
    [F, max_ch, 64] f32 + deq [F, max_ch] i32 (deq == 0 lanes carry
    quantized values for the device dequant handoff — same pow43 table,
    bit-identical), seq/shape/prev_shape [F, max_ch], nch [F], status [F];
    or None if the native library is unavailable. aac_dequant_host()
    reconstructs full coeffs for oracle comparisons.
    """
    lib = _load()
    if lib is None:
        return None
    _aac_ensure_codebooks(lib)
    a = np.frombuffer(buf, dtype=np.uint8)
    F = len(offsets)
    # Pooled outputs (the C++ writer initializes every field read back for
    # frames with status==0 and nch==max_ch; callers discard otherwise).
    coeffs = _pooled("aac_coeffs", (F, max_ch, 1024), np.float32)
    qbuf = _pooled("aac_qbuf", (F, max_ch, 1024), np.int16)
    scales = _pooled("aac_scales", (F, max_ch, 64), np.float32)
    deq = _pooled("aac_deq", (F, max_ch), np.int32)
    deq[:] = 1  # the sequential engine leaves host-dequantized lanes alone
    seq = _pooled("aac_seq", (F, max_ch), np.int32)
    shape = _pooled("aac_shape", (F, max_ch), np.int32)
    prev_shape = _pooled("aac_pshape", (F, max_ch), np.int32)
    nch = _pooled("aac_nch", (F,), np.int32)
    status = _pooled("aac_status", (F,), np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    bl = np.ascontiguousarray(bands_long, dtype=np.int32)
    bs = np.ascontiguousarray(bands_short, dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.sh_aac_extract(
        _u8ptr(a), len(a),
        offsets.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p), F,
        rate_idx, bl.ctypes.data_as(i32p), len(bl),
        bs.ctypes.data_as(i32p), len(bs), max_ch,
        coeffs.ctypes.data_as(f32p),
        qbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        scales.ctypes.data_as(f32p), deq.ctypes.data_as(i32p),
        seq.ctypes.data_as(i32p),
        shape.ctypes.data_as(i32p), prev_shape.ctypes.data_as(i32p),
        nch.ctypes.data_as(i32p), status.ctypes.data_as(i32p),
    )
    return {"coeffs": coeffs, "qbuf": qbuf, "scales": scales, "deq": deq,
            "seq": seq, "shape": shape,
            "prev_shape": prev_shape, "nch": nch, "status": status, "F": F}


class AacStream:
    """Persistent native AAC context for the per-packet decoder: the C++
    ChannelPair vector carries PNS-LCG / window-shape / element-layout
    state across calls, so one frame per call decodes exactly like the
    batch walk."""

    def __init__(self, lib, ctx, rate_idx: int, bands_long, bands_short,
                 max_ch: int):
        self._lib = lib
        self._ctx = ctx
        self.max_ch = max_ch
        self.rate_idx = rate_idx
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        self._bl = np.ascontiguousarray(bands_long, dtype=np.int32)
        self._bs = np.ascontiguousarray(bands_short, dtype=np.int32)
        self.coeffs = np.empty((1, max_ch, 1024), np.float32)
        self.qbuf = np.empty((1, max_ch, 1024), np.int16)
        self.scales = np.empty((1, max_ch, 64), np.float32)
        self.deq = np.empty((1, max_ch), np.int32)
        self.seq = np.empty((1, max_ch), np.int32)
        self.shape = np.empty((1, max_ch), np.int32)
        self.prev_shape = np.empty((1, max_ch), np.int32)
        self.nch = np.empty(1, np.int32)
        self.status = np.empty(1, np.int32)
        self._p = dict(
            bl=self._bl.ctypes.data_as(i32p), bs=self._bs.ctypes.data_as(i32p),
            coeffs=self.coeffs.ctypes.data_as(f32p),
            qbuf=self.qbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            scales=self.scales.ctypes.data_as(f32p),
            deq=self.deq.ctypes.data_as(i32p), seq=self.seq.ctypes.data_as(i32p),
            shape=self.shape.ctypes.data_as(i32p),
            prev_shape=self.prev_shape.ctypes.data_as(i32p),
            nch=self.nch.ctypes.data_as(i32p),
            status=self.status.ctypes.data_as(i32p),
        )
        # Full-packet PCM path (sh_aac_stream_decode_pcm).
        self.has_pcm = hasattr(lib, "sh_aac_stream_decode_pcm")
        self.pcm = np.empty((max_ch, 1024), np.float32)
        self.pcm_shape = np.empty(max_ch, np.int32)
        self._p_pcm = self.pcm.ctypes.data_as(f32p)
        self._p_pcm_shape = self.pcm_shape.ctypes.data_as(i32p)
        self._delay_cache = None  # (id, ptr, strong ref)

    def __del__(self):
        if self._ctx:
            self._lib.sh_aac_stream_close(self._ctx)
            self._ctx = None

    def reset(self) -> None:
        self._lib.sh_aac_stream_reset(self._ctx)


_AAC_WINDOWS_SET = False


def _aac_ensure_windows(lib) -> None:
    """Register the oracle's exact window tables for the native PCM
    synthesis (byte-identical floats; aac.py kbd_window/sine_window)."""
    global _AAC_WINDOWS_SET
    if _AAC_WINDOWS_SET or not hasattr(lib, "sh_aac_set_windows"):
        return
    from .codecs.aac import kbd_window, sine_window

    f32p = ctypes.POINTER(ctypes.c_float)
    tabs = [np.ascontiguousarray(t, np.float32) for t in (
        sine_window(1024), kbd_window(1024, 4.0),
        sine_window(128), kbd_window(128, 6.0))]
    lib.sh_aac_set_windows(*(t.ctypes.data_as(f32p) for t in tabs))
    _AAC_WINDOWS_SET = True


def aac_stream_open(rate_idx: int, bands_long, bands_short, max_ch: int):
    """Open a persistent native AAC context, or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_aac_stream_open"):
        return None
    _aac_ensure_codebooks(lib)
    _aac_ensure_windows(lib)
    ctx = lib.sh_aac_stream_open()
    if not ctx:
        return None
    return AacStream(lib, ctx, rate_idx, bands_long, bands_short, max_ch)


def aac_stream_decode(stream: "AacStream", data: bytes):
    """Decode one raw_data_block via the persistent context. Returns the
    single-frame ext dict (sh_aac_extract layout, F = 1, pooled in the
    stream — consume before the next call), or None on any error status
    (caller falls back to the Python oracle permanently, preserving
    state continuity)."""
    stream.deq[:] = 1
    p = stream._p
    rc = stream._lib.sh_aac_stream_decode(
        stream._ctx, data, len(data), stream.rate_idx,
        p["bl"], len(stream._bl), p["bs"], len(stream._bs), stream.max_ch,
        p["coeffs"], p["qbuf"], p["scales"], p["deq"], p["seq"], p["shape"],
        p["prev_shape"], p["nch"], p["status"],
    )
    if rc != 0:
        return None
    return {"coeffs": stream.coeffs, "qbuf": stream.qbuf,
            "scales": stream.scales, "deq": stream.deq, "seq": stream.seq,
            "shape": stream.shape, "prev_shape": stream.prev_shape,
            "nch": stream.nch, "status": stream.status, "F": 1}


def aac_stream_decode_pcm(stream: "AacStream", data: bytes,
                          delay: np.ndarray):
    """FULL per-packet decode (entropy + dequant + pulse/TNS/PNS/joint +
    IMDCT + window/OLA in C++). ``delay`` is the caller-owned OLA state
    [max_ch, 1024] f32 C-contiguous, updated in place only on success —
    on None (error status, channel-count mismatch, engine without the
    entry) it is untouched and the caller falls back to the Python path,
    which shares the same buffer. Returns (pcm [max_ch, 1024] f32 copy,
    shape [max_ch] int32 copy)."""
    if not stream.has_pcm:
        return None
    c = stream._delay_cache
    if c is None or c[0] != id(delay):
        c = (id(delay),
             delay.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), delay)
        stream._delay_cache = c
    p = stream._p
    rc = stream._lib.sh_aac_stream_decode_pcm(
        stream._ctx, data, len(data), stream.rate_idx,
        p["bl"], len(stream._bl), p["bs"], len(stream._bs), stream.max_ch,
        c[1], stream._p_pcm, stream._p_pcm_shape, p["nch"], p["status"],
    )
    if rc != 0 or int(stream.nch[0]) != stream.max_ch:
        return None
    return stream.pcm.copy(), stream.pcm_shape.copy()


def aac_sfb_map(bands_long, n: int = 1024) -> np.ndarray:
    """Static coefficient -> scalefactor-band map for long windows (the
    device dequant handoff's scale gather index; bands beyond the last
    boundary map to band 63, whose scale is 0 for long-window lanes)."""
    bl = np.asarray(bands_long, dtype=np.int64)
    m = np.full(n, 63, np.int32)
    for sfb in range(len(bl) - 1):
        m[bl[sfb]:bl[sfb + 1]] = sfb
    return m


_AAC_POW43 = None


def aac_pow43() -> np.ndarray:
    """The shared |q|^(4/3) table (f32 cast of the f64 powers) — the one
    source of truth for host, device, and test dequantization."""
    global _AAC_POW43
    if _AAC_POW43 is None:
        _AAC_POW43 = (np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)
                      ).astype(np.float32)
    return _AAC_POW43


def aac_dequant_host(ext, bands_long) -> np.ndarray:
    """Reconstruct full float coefficients on the host (numpy) for lanes
    the native stage left quantized (deq == 0) — the test/oracle twin of
    the device dequant: identical pow43-table f32 multiply."""
    coeffs = ext["coeffs"].copy()
    deq = ext["deq"]
    if (deq != 0).all():
        return coeffs
    pow43 = aac_pow43()
    sfb = aac_sfb_map(bands_long)
    q = ext["qbuf"].astype(np.int32)
    mag = np.minimum(np.abs(q), 8191)
    scale = ext["scales"][:, :, sfb]
    # Lanes the host already dequantized (deq != 0) carry stale qbuf /
    # scales here; their product may overflow to inf before the mask
    # discards it below — expected, scope the warning.
    with np.errstate(over="ignore"):
        vals = np.sign(q).astype(np.float32) * pow43[mag] * scale
    # Uncoded bands multiply stale quants by a zero scale: canonicalize
    # -0.0 to +0.0 so reconstructions are byte-deterministic (the decode
    # math is unaffected; only hashes/tobytes comparisons care).
    vals = vals + 0.0
    mask = deq[:, :, None] == 0
    coeffs = np.where(mask, vals, coeffs)
    return coeffs


def flac_fast_extract(buf: bytes, si, n_max: int, max_frames: int):
    """Fast whole-stream path: AVX-512 sync scan (seq-chain filtered) +
    8-lane SIMD Rice extraction. Returns the packed dict with 'offsets', or
    None when SIMD is unavailable (callers use flac_stream_extract then)."""
    n_max = _pad_rows(n_max)
    lib = _load()
    if lib is None or not lib.sh_flac_has_simd():
        return None
    a = np.frombuffer(buf, dtype=np.uint8)
    C = si.channels
    offsets = _pooled("offsets", (max_frames,), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    F = lib.sh_flac_scan_fast(
        _u8ptr(a), len(a), si.channels, si.bits_per_sample, si.sample_rate,
        si.block_len_max, offsets.ctypes.data_as(i64p), max_frames)
    if F <= 0:
        return None
    sizes = _pooled("sizes", (max_frames,), np.int64)
    sizes[:F - 1] = offsets[1:F] - offsets[:F - 1]
    sizes[F - 1] = len(a) - offsets[F - 1]
    res = _pooled("res", (max_frames * C, n_max), np.int32)
    coefs = _pooled("coefs", (max_frames * C, 32), np.int32)
    order = _pooled("order", (max_frames * C,), np.int32)
    shift = _pooled("shift", (max_frames * C,), np.int32)
    wasted = _pooled("wasted", (max_frames * C,), np.int32)
    block = _pooled("block", (max_frames,), np.int32)
    assign = _pooled("assign", (max_frames,), np.int32)
    bps = _pooled("bps", (max_frames,), np.int32)
    status = _pooled("status", (max_frames,), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sh_flac_extract_simd(
        _u8ptr(a), len(a),
        offsets.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p), F,
        si.channels, si.bits_per_sample, si.sample_rate, si.block_len_max,
        C, n_max,
        res.ctypes.data_as(i32p), coefs.ctypes.data_as(i32p),
        order.ctypes.data_as(i32p), shift.ctypes.data_as(i32p),
        wasted.ctypes.data_as(i32p), block.ctypes.data_as(i32p),
        assign.ctypes.data_as(i32p), bps.ctypes.data_as(i32p),
        status.ctypes.data_as(i32p),
    )
    return {
        "res": res[: F * C], "coefs": coefs[: F * C], "order": order[: F * C],
        "shift": shift[: F * C], "wasted": wasted[: F * C],
        "block": block[:F], "assign": assign[:F], "bps": bps[:F],
        "offsets": offsets[:F], "status": status[:F],
        "F": F, "C": C, "n_max": n_max,
    }


def _vorbis_serialize(ident, setup) -> Optional[bytes]:
    """Serialize a parsed Vorbis setup for sh_vorbis_open (vorbis_entropy.cpp
    Reader layout). Returns None when the setup exceeds the native layout's
    limits (callers use the Python oracle then)."""
    import struct

    from .codecs.vorbis import floor1_inverse_db_table

    out = bytearray()

    def i32(*vals):
        out.extend(struct.pack("<%di" % len(vals), *(int(v) for v in vals)))

    def ivec(vals):
        out.extend(struct.pack("<i", len(vals)))
        out.extend(np.asarray(vals, dtype="<i4").tobytes())

    i32(0x56535450, 1)
    i32(ident.n_channels, ident.sample_rate, 1 << ident.bs0_exp,
        1 << ident.bs1_exp)
    out.extend(floor1_inverse_db_table().astype(np.float32).tobytes())
    i32(len(setup.codebooks))
    for cb in setup.codebooks:
        book = cb.codebook
        if len(book.values) and int(np.max(book.values)) >= (1 << 20):
            return None
        i32(cb.dims, len(book.codes))
        arr = np.empty((len(book.codes), 3), dtype=np.int32)
        arr[:, 0] = book.codes.astype(np.int64).astype(np.int32)
        arr[:, 1] = book.lens
        arr[:, 2] = book.values
        out.extend(arr.tobytes())
        if cb.vq is not None:
            i32(cb.vq.shape[0])
            out.extend(np.ascontiguousarray(cb.vq, dtype=np.float32).tobytes())
        else:
            i32(0)
    i32(len(setup.floors))
    for fl in setup.floors:
        i32(fl.kind)
        if fl.kind == 0:
            f = fl.f0
            i32(f.order, f.rate, f.bark_map_size, f.amplitude_bits,
                f.amplitude_offset)
            ivec(f.books)
        else:
            f = fl.f1
            if len(f.x_list) > 256:
                return None
            i32(f.multiplier)
            ivec(f.partition_class_list)
            ivec(f.class_dims)
            ivec(f.class_subclass_bits)
            ivec(f.class_masterbooks)
            i32(len(f.subclass_books))
            for sb in f.subclass_books:
                ivec(sb)
            ivec(f.x_list)
            ivec(f.sort_order)
            ivec(f.low_neighbors)
            ivec(f.high_neighbors)
    i32(len(setup.residues))
    for r in setup.residues:
        i32(r.kind, r.begin, r.end, r.partition_size, r.classifications,
            r.classbook)
        i32(len(r.books))
        for b in r.books:
            ivec(b)
    i32(len(setup.mappings))
    for m in setup.mappings:
        i32(len(m.coupling_steps))
        for a, b in m.coupling_steps:
            i32(a, b)
        ivec(m.mux)
        ivec(m.submap_floor)
        ivec(m.submap_residue)
    i32(len(setup.modes))
    for md in setup.modes:
        i32(1 if md.block_flag else 0, md.mapping)
    return bytes(out)


class VorbisStream:
    """Persistent native Vorbis context for the per-packet decoder (setup
    tables parsed once; sh_vorbis_decode called one packet at a time)."""

    def __init__(self, lib, ctx, n_ch: int, n2max: int):
        self._lib = lib
        self._ctx = ctx
        self.n_ch = n_ch
        self.n2max = n2max
        # Own per-call buffers with prebuilt ctypes pointers (the data_as
        # dance costs ~1.5 us each; six per packet adds up).
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._offs = np.zeros(1, np.int64)
        self._sizes = np.zeros(1, np.int64)
        self.spectra = np.empty((1, n_ch, n2max), np.float32)
        self._flags = np.empty(1, np.int32)
        self._status = np.empty(1, np.int32)
        self._p_offs = self._offs.ctypes.data_as(i64p)
        self._p_sizes = self._sizes.ctypes.data_as(i64p)
        self._p_spec = self.spectra.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))
        self._p_flags = self._flags.ctypes.data_as(i32p)
        self._p_status = self._status.ctypes.data_as(i32p)
        # Full-packet PCM path (sh_vorbis_decode_pcm): out_n / first slots
        # + a persistent output buffer (callers receive a sliced copy).
        self.has_pcm = hasattr(lib, "sh_vorbis_decode_pcm")
        self._outn = np.empty(1, np.int32)
        self._first = np.empty(1, np.int32)
        self._p_outn = self._outn.ctypes.data_as(i32p)
        self._p_first = self._first.ctypes.data_as(i32p)
        self._pcmbuf = np.empty((n_ch, n2max), np.float32)
        self._p_pcmbuf = self._pcmbuf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))

    def __del__(self):
        if self._ctx:
            self._lib.sh_vorbis_close(self._ctx)
            self._ctx = None


_VORBIS_TABLES_SET = False


def _vorbis_register_tables(lib) -> None:
    """One-time registration of the floor1 inverse dB table (the native
    setup parser needs it; registering the Python-side array keeps the
    native floor curves byte-identical to the oracle's)."""
    global _VORBIS_TABLES_SET
    if _VORBIS_TABLES_SET:
        return
    from .codecs.vorbis import floor1_inverse_db_table

    db = np.ascontiguousarray(floor1_inverse_db_table(), dtype=np.float32)
    lib.sh_vorbis_set_tables(db.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)))
    _VORBIS_TABLES_SET = True


def vorbis_skim_modes(ident_data: bytes, setup_data: bytes):
    """Mode block-flag list for the OGG mapper's packet-duration table,
    parsed natively, or None (caller falls back to the Python skim).
    Uses the full native parser, which is strictly STRICTER than the
    Python skim — so a native accept always agrees with the Python walk,
    and every reject lands on the fallback for the authoritative answer."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_vorbis_open_hdrs"):
        return None
    _vorbis_register_tables(lib)
    ctx = lib.sh_vorbis_open_hdrs(bytes(ident_data), len(ident_data),
                                  bytes(setup_data), len(setup_data))
    if not ctx:
        return None
    try:
        flags = np.zeros(64, np.int32)
        n = lib.sh_vorbis_mode_flags(
            ctx, flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return [bool(f) for f in flags[:n]]
    finally:
        lib.sh_vorbis_close(ctx)


def vorbis_stream_open(dec):
    """Open a persistent native context for a VorbisDecoder, or None.

    Fast path: sh_vorbis_open_hdrs parses the raw ident+setup header
    packets in C++ (no Python setup parse, no serialize round-trip). Any
    native parse failure falls back to the serialize path, which touches
    ``dec.setup`` and thereby runs the Python parser (raising the precise
    DecodeError for malformed setups).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "sh_vorbis_open"):
        return None
    ctx = None
    raw = getattr(dec, "_raw_headers", None)
    if raw is not None and hasattr(lib, "sh_vorbis_open_hdrs"):
        _vorbis_register_tables(lib)
        ident_data, setup_data = raw
        ctx = lib.sh_vorbis_open_hdrs(bytes(ident_data), len(ident_data),
                                      bytes(setup_data), len(setup_data))
    if not ctx:
        blob = _vorbis_serialize(dec.ident, dec.setup)
        if blob is None:
            return None
        b = np.frombuffer(blob, dtype=np.uint8)
        ctx = lib.sh_vorbis_open(_u8ptr(b), len(b))
    if not ctx:
        return None
    return VorbisStream(lib, ctx, dec.ident.n_channels,
                        (1 << dec.ident.bs1_exp) // 2)


def vorbis_stream_decode(stream: "VorbisStream", data: bytes):
    """Entropy + floor/residue/coupling for ONE packet via the persistent
    context. Returns (spectra [n_ch, n2max] f32 pooled view, block_flag)
    or None (caller falls back to the Python oracle)."""
    stream._sizes[0] = len(data)
    stream._lib.sh_vorbis_decode(
        stream._ctx, data, len(data),
        stream._p_offs, stream._p_sizes, 1,
        stream._p_spec, stream._p_flags, stream._p_status,
    )
    if stream._status[0] != 0:
        return None
    return stream.spectra[0], bool(stream._flags[0])


def vorbis_stream_decode_pcm(stream: "VorbisStream", data: bytes):
    """FULL per-packet decode (entropy + IMDCT + lapped OLA + channel
    reorder) via the persistent context. Returns (pcm [n_ch, n_out] f32
    freshly allocated, first_block) or None (caller falls back; the
    context's lapping state is untouched on failure). The caller must
    route every packet of the stream through this entry once it engages
    (the overlap state lives in the context)."""
    if not stream.has_pcm:
        return None
    stream._lib.sh_vorbis_decode_pcm(
        stream._ctx, data, len(data),
        stream._p_pcmbuf, stream.n2max,
        stream._p_outn, stream._p_first, stream._p_status,
    )
    if stream._status[0] != 0:
        return None
    # Copy out of the persistent buffer: the caller owns the result.
    return (stream._pcmbuf[:, : stream._outn[0]].copy(),
            bool(stream._first[0]))


def vorbis_stream_reset(stream: "VorbisStream") -> None:
    """Clear the context's lapping state (decoder reset / post-seek)."""
    if stream.has_pcm:
        stream._lib.sh_vorbis_reset(stream._ctx)


def vorbis_decode_spectra(dec, packets):
    """Native whole-stream Vorbis entropy stage.

    ``dec`` is a VorbisDecoder (provides ident/setup); ``packets`` is a list
    of audio-packet byte strings. Returns (spectra [N, n_ch, bs1/2] f32,
    flags [N], status [N]) or None if unavailable.
    """
    lib = _load()
    if lib is None or not packets:
        return None
    try:
        lib.sh_vorbis_open
    except AttributeError:
        return None
    blob = _vorbis_serialize(dec.ident, dec.setup)
    if blob is None:
        return None
    b = np.frombuffer(blob, dtype=np.uint8)
    ctx = lib.sh_vorbis_open(_u8ptr(b), len(b))
    if not ctx:
        return None
    try:
        buf = b"".join(packets)
        sizes = np.array([len(p) for p in packets], np.int64)
        offs = np.zeros(len(packets), np.int64)
        np.cumsum(sizes[:-1], out=offs[1:])
        N = len(packets)
        n_ch = dec.ident.n_channels
        n2max = (1 << dec.ident.bs1_exp) // 2
        spectra = np.empty((N, n_ch, n2max), dtype=np.float32)
        flags = np.empty(N, dtype=np.int32)
        status = np.empty(N, dtype=np.int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.sh_vorbis_decode(
            ctx, buf, len(buf),
            offs.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p), N,
            spectra.ctypes.data_as(f32p), flags.ctypes.data_as(i32p),
            status.ctypes.data_as(i32p),
        )
        return spectra, flags, status
    finally:
        lib.sh_vorbis_close(ctx)


def alac_decode(data: bytes, cfg, chmap) -> "np.ndarray | None":
    """Decode one ALAC packet natively (native/alac_decode.cpp, a mirror
    of codecs/alac.py AlacDecoder.decode). Returns planar int32
    [num_channels, num_frames], or None when the native library is
    unavailable or reports an error — the caller then falls back to the
    Python decoder so malformed-input behavior matches the oracle."""
    lib = _load()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    # Pooled output + cached chmap pointer: callers receive a sliced copy,
    # so the 32 KiB allocation/zeroing doesn't recur per packet. Zeroing
    # still matters for channels a malformed element loop leaves untouched.
    out, p_out = _pooled_ptr(("alac_out", cfg.num_channels,
                              cfg.frame_length),
                             (cfg.num_channels, cfg.frame_length),
                             np.int32, i32p)
    out.fill(0)
    cm_key = ("alac_cm", tuple(chmap))
    cm, p_cm = _pooled_ptr(cm_key, (len(chmap),), np.int32, i32p)
    cm[:] = chmap
    n = lib.sh_alac_decode(
        data, len(data), cfg.frame_length, cfg.bit_depth, cfg.pb, cfg.mb,
        cfg.kb, cfg.num_channels, p_cm, p_out,
    )
    if n < 0:
        return None
    return out[:, :n].copy()


def ima_decode_nibbles(nibbles, pred: int, idx: int):
    """IMA ADPCM recurrence (native/adpcm_loops.cpp mirror of
    codecs/adpcm.py ima_decode_nibbles). Returns int32 samples, or None
    when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_ima_decode_nibbles"):
        return None
    nb = np.ascontiguousarray(nibbles, dtype=np.uint8)
    out = np.empty(len(nb), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sh_ima_decode_nibbles(_u8ptr(nb), len(nb), ctypes.c_int32(int(pred)),
                              ctypes.c_int32(int(idx)),
                              out.ctypes.data_as(i32p))
    return out


def ms_decode_nibbles(nibbles, c1, c2, delta, s1, s2, out) -> bool:
    """MS ADPCM recurrence (native/adpcm_loops.cpp). Mutates delta/s1/s2
    and fills out[:, 2:] like the Python loop; returns False when the
    native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_ms_decode_nibbles"):
        return False
    nb = np.ascontiguousarray(nibbles, dtype=np.uint8)
    c1 = np.ascontiguousarray(c1, dtype=np.int32)
    c2 = np.ascontiguousarray(c2, dtype=np.int32)
    assert out.dtype == np.int32 and out.flags.c_contiguous
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sh_ms_decode_nibbles(
        _u8ptr(nb), len(nb), ctypes.c_int32(out.shape[0]),
        c1.ctypes.data_as(i32p), c2.ctypes.data_as(i32p),
        delta.ctypes.data_as(i64p), s1.ctypes.data_as(i64p),
        s2.ctypes.data_as(i64p), out.ctypes.data_as(i32p),
        ctypes.c_int64(out.shape[1]))
    return True


_L12_SF_CACHE: "Optional[tuple]" = None  # (source ref, f64 copy, ptr)
_L12_ROWS_CACHE: "Optional[tuple]" = None  # (source ref, i32 copy, ptr)


def mpa_l12_extract(layer: int, data: bytes, n_ch: int, bound: int,
                    sblimit: int, band_rows, sf_table):
    """Layer I/II bitstream stage (native/mpa_layer12.cpp mirror of
    codecs/mpa_layer12.py). Returns f32 samples [2, 384 or 1152], or None
    when unavailable / on any error status (caller falls back to Python)."""
    global _L12_SF_CACHE
    lib = _load()
    if lib is None or not hasattr(lib, "sh_mpa_l1_extract"):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    # The scale-factor / band-row tables are identical every packet:
    # single-slot caches of the converted copy + its ctypes pointer,
    # keyed by object identity WITH the source kept alive (a bare id()
    # key could alias a recycled address).
    p_sf = l12_sf_ptr(sf_table)
    # Pooled output (callers copy out via _synthesize before the next
    # call); zero-filled each call — uncoded regions rely on it.
    out, p_out = _pooled_ptr(("l12_out", layer == 1),
                             (2, 384 if layer == 1 else 1152),
                             np.float32, f32p)
    out.fill(0.0)
    if layer == 1:
        r = lib.sh_mpa_l1_extract(data, len(data), ctypes.c_int32(n_ch),
                                  ctypes.c_int32(bound), p_sf, p_out)
    else:
        p_rows = l12_rows_ptr(band_rows)
        r = lib.sh_mpa_l2_extract(data, len(data), ctypes.c_int32(n_ch),
                                  ctypes.c_int32(bound),
                                  ctypes.c_int32(sblimit),
                                  p_rows, p_sf, p_out)
    return out if r == 0 else None


def l12_sf_ptr(sf_table):
    """Single-slot cache of the f64 scale-factor table pointer (identity
    keyed with the source kept alive — see mpa_l12_extract)."""
    global _L12_SF_CACHE
    if _L12_SF_CACHE is None or _L12_SF_CACHE[0] is not sf_table:
        sf = np.ascontiguousarray(sf_table, dtype=np.float64)
        _L12_SF_CACHE = (sf_table, sf,
                         sf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return _L12_SF_CACHE[2]


def l12_rows_ptr(band_rows):
    """Cached int32 pointer for a Layer II band-row table (identity keyed
    with the source kept alive)."""
    global _L12_ROWS_CACHE
    if band_rows is None:
        return None
    if _L12_ROWS_CACHE is None or _L12_ROWS_CACHE[0] is not band_rows:
        rows = np.zeros(32, dtype=np.int32)
        rows[: len(band_rows)] = band_rows
        _L12_ROWS_CACHE = (
            band_rows, rows,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return _L12_ROWS_CACHE[2]


def l12_stream_caller(synth_tails: np.ndarray, pcm_buf: np.ndarray):
    """Fused per-packet Layer I/II decode (native/mpa_layer12.cpp
    sh_l12_stream_decode): bitstream stage + 32-band polyphase + carried
    480-sample synthesis tail in ONE call. Returns a callable bound to the
    given state buffers (the per-frame FFI prep is hoisted here), or None
    when the native library is unavailable.

    The callable's signature is (layer, data, n_ch, bound, sblimit,
    p_rows, p_sf) -> samples-per-channel, or <=0 on error. synth_tails
    [2,480] f32 and pcm_buf [2,1152] f32 must stay alive and un-resized;
    the tail updates in place only on success, so a non-positive return
    lets the caller fall back to the Python path with state continuity
    intact."""
    lib = _load()
    if lib is None or not hasattr(lib, "sh_l12_stream_decode"):
        return None
    if not _mp3_ensure_dense(lib):
        return None
    assert synth_tails.dtype == np.float32 and synth_tails.flags.c_contiguous
    assert pcm_buf.dtype == np.float32 and pcm_buf.flags.c_contiguous
    f32p = ctypes.POINTER(ctypes.c_float)
    fn = lib.sh_l12_stream_decode
    p_tail = synth_tails.ctypes.data_as(f32p)
    p_pcm = pcm_buf.ctypes.data_as(f32p)

    def call(layer, data, n_ch, bound, sblimit, p_rows, p_sf,
             _fn=fn, _pt=p_tail, _pp=p_pcm, _keep=(synth_tails, pcm_buf)):
        return _fn(layer, data, len(data), n_ch, bound, sblimit, p_rows,
                   p_sf, _pt, _pp)

    return call
