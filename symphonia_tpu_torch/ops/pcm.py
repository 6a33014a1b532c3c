"""PCM sample conversion: the host oracle and the batch unpack kernel.

Port of ``symphonia_tpu/ops/pcm.py``. Its numpy half (the G.711 tables
and ``decode_pcm_np``, lines 25-166) is copied: raw packet bytes ->
planar samples, the oracle and the per-packet decoder's path
(``codecs/pcm.py``). Its device half (K12, ``_combine_bytes_int`` and
``decode_pcm_batch_jax``, lines 174-230) is :func:`decode_pcm_batch`: a
padded ``[B, N]`` uint8 batch -> ``[B, N // bps]`` samples through the
hand-written kernel P1 ``pcm_unpack`` (``csrc/pcm.cu``) for CUDA tensors,
or its plain PyTorch twin :func:`decode_pcm_batch_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

# ---------------------------------------------------------------------------
# G.711 companding tables (codec-pcm lib.rs:154-181)
# ---------------------------------------------------------------------------


def _build_mulaw_table() -> np.ndarray:
    """CCITT G.711 mu-law -> linear16."""
    out = np.zeros(256, dtype=np.int16)
    for u in range(256):
        v = ~u & 0xFF
        t = ((v & 0x0F) << 3) + 0x84
        t <<= (v & 0x70) >> 4
        out[u] = (0x84 - t) if (v & 0x80) else (t - 0x84)
    return out


def _build_alaw_table() -> np.ndarray:
    """CCITT G.711 A-law -> linear16."""
    out = np.zeros(256, dtype=np.int16)
    for a in range(256):
        v = a ^ 0x55
        t = (v & 0x0F) << 4
        seg = (v & 0x70) >> 4
        if seg == 0:
            t += 8
        elif seg == 1:
            t += 0x108
        else:
            t = (t + 0x108) << (seg - 1)
        out[a] = t if (v & 0x80) else -t
    return out


MULAW_TABLE = _build_mulaw_table()
ALAW_TABLE = _build_alaw_table()


# ---------------------------------------------------------------------------
# Host (numpy) decode — the oracle
# ---------------------------------------------------------------------------

_INT_DTYPES = {
    ("s16", False): "<i2", ("s16", True): ">i2",
    ("u16", False): "<u2", ("u16", True): ">u2",
    ("s32", False): "<i4", ("s32", True): ">i4",
    ("u32", False): "<u4", ("u32", True): ">u4",
    ("f32", False): "<f4", ("f32", True): ">f4",
    ("f64", False): "<f8", ("f64", True): ">f8",
}


def decode_pcm_np(
    data: bytes,
    codec: str,
    channels: int,
    bits_per_coded_sample: int | None = None,
) -> np.ndarray:
    """Decode interleaved PCM bytes -> planar [ch, frames] samples.

    Integer output is int32 right-justified at the *coded* width; float
    output is float32/float64. Mirrors codec-pcm lib.rs:318-412 incl. the
    bits_per_coded_sample sub-width shift.
    """
    # Truncated final sample (malformed/cut streams): clip to whole
    # samples like the reference's frame-bounded reads; a partial trailing
    # sample is dropped rather than raising out of the taxonomy.
    _widths = {"pcm_u8": 1, "pcm_s8": 1, "pcm_alaw": 1, "pcm_mulaw": 1,
               "pcm_s16le": 2, "pcm_s16be": 2, "pcm_u16le": 2,
               "pcm_u16be": 2, "pcm_s24le": 3, "pcm_s24be": 3,
               "pcm_u24le": 3, "pcm_u24be": 3, "pcm_s32le": 4,
               "pcm_s32be": 4, "pcm_u32le": 4, "pcm_u32be": 4,
               "pcm_f32le": 4, "pcm_f32be": 4, "pcm_f64le": 8,
               "pcm_f64be": 8}
    if channels < 1:
        raise ValueError("PCM decode requires at least one channel")
    w = _widths.get(codec, 1) * max(1, channels)
    if len(data) % w:
        data = data[: len(data) - (len(data) % w)]
    if codec == "pcm_u8":
        x = np.frombuffer(data, dtype=np.uint8).astype(np.int32) - 128
        bits = 8
    elif codec == "pcm_s8":
        x = np.frombuffer(data, dtype=np.int8).astype(np.int32)
        bits = 8
    elif codec in ("pcm_s16le", "pcm_s16be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("s16", codec.endswith("be"))]).astype(np.int32)
        bits = 16
    elif codec in ("pcm_u16le", "pcm_u16be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("u16", codec.endswith("be"))]).astype(np.int32) - 32768
        bits = 16
    elif codec in ("pcm_s24le", "pcm_s24be"):
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if codec.endswith("be"):
            b = b[:, ::-1]
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x << 8) >> 8  # sign-extend 24 -> 32
        bits = 24
    elif codec in ("pcm_u24le", "pcm_u24be"):
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if codec.endswith("be"):
            b = b[:, ::-1]
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        ) - (1 << 23)
        bits = 24
    elif codec in ("pcm_s32le", "pcm_s32be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("s32", codec.endswith("be"))]).astype(np.int32)
        bits = 32
    elif codec in ("pcm_u32le", "pcm_u32be"):
        x = (
            np.frombuffer(data, dtype=_INT_DTYPES[("u32", codec.endswith("be"))]).astype(np.int64)
            - (1 << 31)
        ).astype(np.int32)
        bits = 32
    elif codec in ("pcm_f32le", "pcm_f32be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("f32", codec.endswith("be"))]).astype(np.float32)
        bits = None
    elif codec in ("pcm_f64le", "pcm_f64be"):
        x = np.frombuffer(data, dtype=_INT_DTYPES[("f64", codec.endswith("be"))]).astype(np.float64)
        bits = None
    elif codec == "pcm_mulaw":
        x = MULAW_TABLE[np.frombuffer(data, dtype=np.uint8)].astype(np.int32)
        bits = 16
    elif codec == "pcm_alaw":
        x = ALAW_TABLE[np.frombuffer(data, dtype=np.uint8)].astype(np.int32)
        bits = 16
    else:
        raise ValueError(f"not a PCM codec: {codec}")

    # Sub-width samples stored right-justified in a wider container
    # (lib.rs:318-412): shift down to the coded width.
    if (
        bits is not None
        and bits_per_coded_sample
        and bits_per_coded_sample < bits
        and codec not in ("pcm_alaw", "pcm_mulaw")
    ):
        x = x >> (bits - bits_per_coded_sample)

    frames = len(x) // channels
    return np.ascontiguousarray(x[: frames * channels].reshape(frames, channels).T)


# ---------------------------------------------------------------------------
# Batch unpack: P1 pcm_unpack (K12) and its plain twin
# ---------------------------------------------------------------------------

# The finishing step: sign-extend from 8 * bps bits, subtract
# 1 << (8 * bps - 1) in uint32 (for u32 that is the reference's sign-bit
# flip), or expand a G.711 byte (the twin looks it up in the tables above;
# the kernel, csrc/pcm.cu, computes the tables' formulas in registers and
# is told which law by _KERNEL_FINISH).
SIGNED, UNSIGNED, TABLE = 0, 1, 2

# codec -> (bytes per sample, big endian, finish); f32 is the signed 32-bit
# word, its bits reinterpreted as float32.
DEVICE_CODECS: Dict[str, Tuple[int, bool, int]] = {
    "pcm_u8": (1, False, UNSIGNED), "pcm_s8": (1, False, SIGNED),
    "pcm_mulaw": (1, False, TABLE), "pcm_alaw": (1, False, TABLE),
    **{f"pcm_{s}{b}{e}": (b // 8, e == "be", SIGNED if s == "s" else UNSIGNED)
       for s in ("s", "u") for b in (16, 24, 32) for e in ("le", "be")},
    "pcm_f32le": (4, False, SIGNED), "pcm_f32be": (4, True, SIGNED),
}
_G711 = {"pcm_mulaw": MULAW_TABLE, "pcm_alaw": ALAW_TABLE}
_KERNEL_FINISH = {"pcm_mulaw": 2, "pcm_alaw": 3}


def _layout(batch_u8, codec: str) -> Tuple[int, bool, int]:
    if codec not in DEVICE_CODECS:
        raise ValueError(f"no device kernel for codec {codec}")
    if batch_u8.dtype != torch.uint8 or batch_u8.dim() != 2:
        raise ValueError("expected a [B, N] uint8 batch")
    return DEVICE_CODECS[codec]


def decode_pcm_batch_plain(batch_u8: torch.Tensor, codec: str
                           ) -> torch.Tensor:
    """Twin of P1: the reference's ``decode_pcm_batch_jax`` in plain tensor
    code. Each row's bytes combine in int64 (no intermediate wraps), then
    the finish maps them into int32 exactly as the reference's int32
    arithmetic wraps."""
    bps, be, fin = _layout(batch_u8, codec)
    B, N = batch_u8.shape
    n = N // bps
    b = batch_u8[:, : n * bps].reshape(B, n, bps).to(torch.int64)
    if fin == TABLE:
        table = torch.from_numpy(_G711[codec].astype(np.int32))
        return table.to(batch_u8.device)[b[:, :, 0]]
    if be:
        b = b.flip(2)
    x = b[:, :, 0]
    for i in range(1, bps):
        x = x | (b[:, :, i] << (8 * i))
    bits = 8 * bps
    if fin == SIGNED:
        x = x - ((x >> (bits - 1)) << bits)
    else:
        x = x - (1 << (bits - 1))
    x = x.to(torch.int32)
    return x.view(torch.float32) if codec.startswith("pcm_f32") else x


def decode_pcm_batch(batch_u8: torch.Tensor, codec: str) -> torch.Tensor:
    """P1 wrapper, the port of ``decode_pcm_batch_jax``: a padded ``[B, N]``
    uint8 batch -> ``[B, N // bps]`` int32 samples (float32 for
    ``pcm_f32le``/``be``: the same bits). Trailing bytes of a row that do
    not fill a sample are dropped. Channel de-interleave and trimming to
    each packet's length happen in the caller. ``pcm_f64le``/``be`` and
    other codecs raise ``ValueError``, as in the reference."""
    bps, be, fin = _layout(batch_u8, codec)
    if _build.device_type(batch_u8) == "cpu":
        return decode_pcm_batch_plain(batch_u8, codec)
    x = batch_u8.contiguous()
    dev = _build.require_cuda(x)
    B, N = x.shape
    out = torch.empty((B, N // bps), dtype=torch.int32, device=dev)
    if out.numel():
        err = _build.lib().pcm_unpack_launch(
            x.data_ptr(), out.data_ptr(), B, N, bps, int(be),
            _KERNEL_FINISH.get(codec, fin), _build.stream_ptr(dev))
        _build.LAUNCHES["pcm_unpack"] += 1
        _build.check("pcm_unpack", err)
    return out.view(torch.float32) if codec.startswith("pcm_f32") else out
