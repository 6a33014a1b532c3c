"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and the objects link into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. The library lands in ``symphonia_tpu_torch/_build/`` under
a name keyed by a hash of the sources, so an edited source rebuilds and a
stale library is never loaded. Nothing here runs at import time: the first
kernel launch builds.

There is no fallback: a missing ``nvcc`` or a failed build raises. Each C
entry point returns ``cudaGetLastError()`` after its launch and
:func:`check` raises on a nonzero code. ``LAUNCHES`` counts launches per
kernel; the wrappers add one where they launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

KERNELS = ("flac_lane_order", "flac_lpc", "flac_decorrelate", "flac_md5",
           "mp3_entropy", "mp3_hybrid", "mp3_synth", "mp3_place",
           "aac_imdct", "aac_dequant", "aac_ola", "vorbis_imdct",
           "mpa_l12_synth", "vorbis_lap", "pcm_unpack", "rice_decode")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
build_seconds: Optional[float] = None
build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C signatures (csrc/*.cu); every entry returns cudaGetLastError().
_SIGNATURES = {
    # res, res_stride, coefs, order, shift, wasted, perm, taps, out, L, n,
    # parts, stream
    "flac_lpc_launch": [_P, _I64] + [_P] * 7 + [_I64, _I, _I, _P],
    # coefs, taps, perm, scratch, L, stream
    "flac_lane_order_launch": [_P, _P, _P, _P, _I64, _P],
    # out, blocks, iters, stream (the integer multiply-add rate, measured)
    "flac_imad_rate_launch": [_P, _I, _I, _P],
    # x, assign, out, F, n, stream
    "flac_decorrelate_launch": [_P, _P, _P, _I64, _I, _P],
    # x, table, blocks, state, S, F, C, n_max, stream
    "flac_md5_launch": [_P] * 4 + [_I64, _I64, _I, _I, _P],
    # out, iters, stream (a dependent operation's latency, measured)
    "flac_md5_chain_launch": [_P, _I, _P],
    # data, n, frames, F, clips, K, huff, fl, it, spectra, L, bt, mixed,
    # status, stream
    "mp3_entropy_launch": [_P, _I64, _P, _I64, _P, _I] + [_P] * 4
                          + [_I64] + [_P] * 4,
    # pcm, g0, g, C, table, K, k0, k1, out, out_n, stream
    "mp3_place_launch": [_P, _I64, _I, _I, _P, _I, _I, _I, _P, _I64, _P],
    # x, bt, mixed, boundary, tail0, T, cs, ca, finv, S, tail_out, G, C,
    # run, stream
    "mp3_hybrid_launch": [_P] * 11 + [_I, _I, _I, _P],
    # S, N, W, tail0, boundary, pcm, tail_out, G, C, stream
    "mp3_synth_launch": [_P] * 7 + [_I, _I, _P],
    # X, M, qbuf (None: no dequant prologue), scales, deq, sfb_map, pow43,
    # Y, L, n, rows (None: every row), n_rows, R, group, stream
    "aac_imdct_launch": [_P] * 8 + [_I, _I, _P, _P, _I, _I, _P],
    # coeffs, qbuf, scales, deq, sfb_map, pow43, out, L, rows (None: every
    # row), n_rows, R, stream
    "aac_dequant_launch": [_P] * 7 + [_I, _P, _P, _I, _P],
    # pcm, seqs, shapes, prev_shapes, first, head, delay, s_first, s_left,
    # s_right, out, L, stream
    "aac_ola_launch": [_P] * 11 + [_I, _P],
    # X, M, Y, L, n, stream
    "vorbis_imdct_launch": [_P] * 3 + [_I, _I, _P],
    # sb, N, W, tail0, pcm, tail_out, F, C, T, stream
    "mpa_l12_synth_launch": [_P] * 6 + [_I, _I, _I, _P],
    # t, w, pcm, V, n1, stream
    "vorbis_lap_launch": [_P] * 3 + [_I64, _I, _P],
    # in, out, B, N, bps, big_endian, finish, stream
    "pcm_unpack_launch": [_P, _P, _I64, _I64, _I, _I, _I, _P],
    # words, W, cur, param, out, cur_end, B, n, stream
    "rice_decode_launch": [_P, _I64] + [_P] * 4 + [_I64, _I, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of symphonia_tpu_torch cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    if not any(s.suffix == ".cu" for s in srcs):
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _nvcc(nvcc: str, args) -> subprocess.CompletedProcess:
    # subprocess.run kills nvcc if it outlives the timeout.
    return subprocess.run([nvcc] + NVCC_FLAGS + args, capture_output=True,
                          text=True, timeout=600)


def build() -> Path:
    """Compile csrc/*.cu into _build/ (no-op when the hashed library
    exists). Returns the library path; raises on any failure."""
    global build_seconds, build_log
    srcs = _sources()
    so = BUILD_DIR / f"libsymphonia_cuda_{_source_hash(srcs)}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cus = [s for s in srcs if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in cus]
    t0 = time.perf_counter()
    try:
        # One nvcc per source, all started together, then one link.
        with ThreadPoolExecutor(len(cus)) as pool:
            procs = list(pool.map(
                lambda s, o: _nvcc(nvcc, ["-c", str(s), "-o", str(o)]),
                cus, objs))
        if not any(p.returncode for p in procs):
            procs.append(_nvcc(nvcc, ["-shared", "-o", str(tmp)]
                               + [str(o) for o in objs]))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_log = "".join(p.stdout + p.stderr for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(name: str, err: int) -> None:
    """Raise on a launch the CUDA runtime refused or that faulted."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def device_type(t: torch.Tensor) -> str:
    """'cpu' (the wrappers run the plain twin) or 'cuda' (they launch the
    kernel); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device, contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev
