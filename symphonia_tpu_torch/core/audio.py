"""Audio buffers, sample formats, conversion, and channel maps.

Analog of symphonia-core/src/audio/:

* ``SampleFormat`` — audio/sample.rs:17 (U8..F64 incl. 24-bit-in-4-bytes).
* ``Channels`` / ``Position`` — audio/channels.rs:19,276 (64-bit speaker
  bitflags; positioned / discrete variants).
* ``AudioSpec`` — audio/mod.rs:50.
* ``AudioBuffer`` — audio/buf.rs:68: *planar* storage, here an ndarray of
  shape ``[channels, frames]`` (numpy on host, jax on device), which is the
  natural layout for the batched TPU pipeline (a batch of buffers stacks to
  ``[batch, channels, frames]``).
* conversion lattice + TPDF dither — audio/conv.rs:147,429.

Internally decoded audio is carried as either int32 (lossless codecs,
bit-exact, left-justified to the coded bit width like the reference's i32
path) or float32 (lossy codecs), and exported to any target format.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from functools import cached_property
from typing import Optional, Tuple, Union

import numpy as np


class SampleFormat(Enum):
    """Sample formats (audio/sample.rs:17)."""

    U8 = "u8"
    S8 = "s8"
    U16 = "u16"
    S16 = "s16"
    U24 = "u24"
    S24 = "s24"
    U32 = "u32"
    S32 = "s32"
    F32 = "f32"
    F64 = "f64"

    @property
    def bits(self) -> int:
        return {"u8": 8, "s8": 8, "u16": 16, "s16": 16, "u24": 24, "s24": 24,
                "u32": 32, "s32": 32, "f32": 32, "f64": 64}[self.value]

    @property
    def bytes_per_sample(self) -> int:
        # 24-bit samples occupy 4 bytes in-memory (sample.rs u24/i24).
        return {"u8": 1, "s8": 1, "u16": 2, "s16": 2, "u24": 4, "s24": 4,
                "u32": 4, "s32": 4, "f32": 4, "f64": 8}[self.value]

    @property
    def is_float(self) -> bool:
        return self in (SampleFormat.F32, SampleFormat.F64)

    @property
    def is_unsigned(self) -> bool:
        return self in (SampleFormat.U8, SampleFormat.U16, SampleFormat.U24,
                        SampleFormat.U32)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype({"u8": np.uint8, "s8": np.int8, "u16": np.uint16,
                         "s16": np.int16, "u24": np.uint32, "s24": np.int32,
                         "u32": np.uint32, "s32": np.int32, "f32": np.float32,
                         "f64": np.float64}[self.value])


class Position:
    """Speaker position bitflags (audio/channels.rs:19)."""

    FRONT_LEFT = 1 << 0
    FRONT_RIGHT = 1 << 1
    FRONT_CENTER = 1 << 2
    LFE1 = 1 << 3
    REAR_LEFT = 1 << 4
    REAR_RIGHT = 1 << 5
    FRONT_LEFT_CENTER = 1 << 6
    FRONT_RIGHT_CENTER = 1 << 7
    REAR_CENTER = 1 << 8
    SIDE_LEFT = 1 << 9
    SIDE_RIGHT = 1 << 10
    TOP_CENTER = 1 << 11
    TOP_FRONT_LEFT = 1 << 12
    TOP_FRONT_CENTER = 1 << 13
    TOP_FRONT_RIGHT = 1 << 14
    TOP_REAR_LEFT = 1 << 15
    TOP_REAR_CENTER = 1 << 16
    TOP_REAR_RIGHT = 1 << 17
    REAR_LEFT_CENTER = 1 << 18
    REAR_RIGHT_CENTER = 1 << 19
    FRONT_LEFT_WIDE = 1 << 20
    FRONT_RIGHT_WIDE = 1 << 21
    FRONT_LEFT_HIGH = 1 << 22
    FRONT_CENTER_HIGH = 1 << 23
    FRONT_RIGHT_HIGH = 1 << 24
    LFE2 = 1 << 25

    MONO = FRONT_CENTER
    STEREO = FRONT_LEFT | FRONT_RIGHT


@dataclass(frozen=True)
class Channels:
    """A channel map (audio/channels.rs:276): positioned speaker mask,
    N discrete channels, a full Ambisonic set of a given order (ACN order,
    SN3D normalization; (1+n)^2 components), or custom channel labels."""

    mask: int = 0  # positioned bitmask; 0 otherwise
    discrete: int = 0  # discrete channel count; 0 otherwise
    ambisonic_order: Optional[int] = None  # highest Ambisonic order
    custom: Optional[Tuple[str, ...]] = None  # channel labels

    @staticmethod
    def positioned(mask: int) -> "Channels":
        return Channels(mask=mask)

    @staticmethod
    def ambisonic(order: int) -> "Channels":
        return Channels(ambisonic_order=order)

    @staticmethod
    def custom_labels(labels) -> "Channels":
        return Channels(custom=tuple(labels))

    @staticmethod
    def from_count(n: int) -> "Channels":
        """Default positioned layout for n channels, else discrete."""
        layouts = {
            1: Position.MONO,
            2: Position.STEREO,
            3: Position.STEREO | Position.FRONT_CENTER,
            4: Position.STEREO | Position.REAR_LEFT | Position.REAR_RIGHT,
            5: Position.STEREO | Position.FRONT_CENTER
            | Position.REAR_LEFT | Position.REAR_RIGHT,
            6: Position.STEREO | Position.FRONT_CENTER | Position.LFE1
            | Position.REAR_LEFT | Position.REAR_RIGHT,
            7: Position.STEREO | Position.FRONT_CENTER | Position.LFE1
            | Position.REAR_CENTER | Position.SIDE_LEFT | Position.SIDE_RIGHT,
            8: Position.STEREO | Position.FRONT_CENTER | Position.LFE1
            | Position.REAR_LEFT | Position.REAR_RIGHT
            | Position.SIDE_LEFT | Position.SIDE_RIGHT,
        }
        if n in layouts:
            return Channels(mask=layouts[n])
        return Channels(discrete=n)

    @cached_property
    def count(self) -> int:
        # cached: per-packet decode paths read num_channels per call.
        if self.ambisonic_order is not None:
            return (1 + self.ambisonic_order) ** 2
        if self.custom is not None:
            return len(self.custom)
        return self.discrete if self.discrete else bin(self.mask).count("1")

    def __len__(self) -> int:
        return self.count


@dataclass(frozen=True)
class AudioSpec:
    """Sample rate + channel map (audio/mod.rs:50)."""

    rate: int
    channels: Channels

    @property
    def num_channels(self) -> int:
        return self.channels.count


# ---------------------------------------------------------------------------
# Sample conversion lattice (audio/conv.rs)
# ---------------------------------------------------------------------------

def _clamp_int(x: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if signed:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    else:
        lo, hi = 0, (1 << bits) - 1
    return np.clip(x, lo, hi)


def int_to_float(x: np.ndarray, bits: int, signed: bool = True) -> np.ndarray:
    """Integer PCM -> f32 in [-1, 1) (conv.rs FromSample for f32).

    Matches the reference's scaling: ``s / 2^(bits-1)`` for signed, with
    unsigned first re-centered.
    """
    scale = np.float32(1.0 / (1 << (bits - 1)))
    if signed:
        return x.astype(np.float32) * scale
    return (x.astype(np.float32) - np.float32(1 << (bits - 1))) * scale


def float_to_int(
    x: np.ndarray, bits: int, signed: bool = True,
    dither: Optional[np.random.Generator] = None,
    dither_mode: str = "triangular",
) -> np.ndarray:
    """f32 -> integer PCM with optional dither (conv.rs:147-270).

    ``dither_mode`` selects the reference's Dither variants:
    ``"triangular"`` (TPDF, sum of two uniforms — conv.rs:186-199) or
    ``"rectangular"`` (one uniform LSB — conv.rs:177-184).
    """
    scale = np.float32(1 << (bits - 1))
    y = x.astype(np.float64) * scale
    if dither is not None:
        if dither_mode == "rectangular":
            # RPDF dither: one uniform [-0.5, 0.5) LSB.
            y = y + (dither.random(y.shape) - 0.5)
        elif dither_mode == "triangular":
            # TPDF dither: sum of two uniform [-0.5, 0.5) samples.
            y = y + (dither.random(y.shape) - 0.5) \
                  + (dither.random(y.shape) - 0.5)
        else:
            raise ValueError(f"unknown dither mode: {dither_mode!r}")
    y = np.rint(y)
    y = _clamp_int(y, bits, signed=True)
    if not signed:
        y = y + (1 << (bits - 1))
    return y.astype(np.int64)


def convert_int_width(x: np.ndarray, from_bits: int, to_bits: int) -> np.ndarray:
    """Signed int width conversion by shifting (conv.rs integer lattice)."""
    x = x.astype(np.int64)
    if to_bits > from_bits:
        return x << (to_bits - from_bits)
    if to_bits < from_bits:
        return x >> (from_bits - to_bits)
    return x


class AudioBuffer:
    """Planar PCM audio buffer (audio/buf.rs:68).

    ``data`` has shape ``[channels, frames]``; dtype is int32 (integer PCM,
    right-justified at ``bits_per_sample``) or float32. ``capacity`` frames
    are pre-allocated; ``frames`` marks the rendered prefix, matching the
    reference's render/truncate model (buf.rs:257-431).
    """

    def __init__(
        self,
        spec: AudioSpec,
        capacity: int,
        dtype=np.float32,
        bits_per_sample: int = 32,
    ):
        self.spec = spec
        self.capacity = capacity
        self.bits_per_sample = bits_per_sample
        self.data = np.zeros((spec.num_channels, capacity), dtype=dtype)
        self.frames = 0

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_array(
        arr: np.ndarray, spec: AudioSpec, bits_per_sample: Optional[int] = None
    ) -> "AudioBuffer":
        if not (isinstance(arr, np.ndarray) and arr.ndim == 2):
            arr = np.atleast_2d(np.asarray(arr))
        buf = AudioBuffer.__new__(AudioBuffer)
        buf.spec = spec
        buf.capacity = arr.shape[1]
        buf.data = arr
        buf.frames = arr.shape[1]
        buf.bits_per_sample = bits_per_sample or (
            32 if arr.dtype.kind == "f" else 8 * arr.dtype.itemsize
        )
        return buf

    # -- mutation (buf.rs:257-431) -----------------------------------------

    def clear(self) -> None:
        self.frames = 0

    def render_silence(self, n: int) -> None:
        self.data[:, self.frames : self.frames + n] = 0
        self.frames += n

    def truncate(self, n: int) -> None:
        self.frames = min(self.frames, n)

    def shift(self, n: int) -> None:
        """Drop the first n frames (buf.rs shift)."""
        if n == 0:
            return
        if n >= self.frames:
            self.frames = 0
            return
        self.data[:, : self.frames - n] = self.data[:, n : self.frames]
        self.frames -= n

    def trim(self, start: int, end: int) -> None:
        """Gapless trim: drop ``start`` leading and ``end`` trailing frames."""
        self.truncate(max(self.frames - end, 0))
        self.shift(min(start, self.frames))

    # -- accessors ---------------------------------------------------------

    @property
    def num_channels(self) -> int:
        return self.data.shape[0]

    def chan(self, i: int) -> np.ndarray:
        return self.data[i, : self.frames]

    def planes(self) -> np.ndarray:
        return self.data[:, : self.frames]

    def __len__(self) -> int:
        return self.frames

    # -- export (audio/generic.rs:197-325 copy_to_* family) ---------------

    def to_float(self) -> np.ndarray:
        """Planar f32 view scaled to [-1, 1) ([ch, frames])."""
        d = self.planes()
        if d.dtype.kind == "f":
            return d.astype(np.float32, copy=False)
        return int_to_float(d, self.bits_per_sample)

    def _to_float_as(self, dtype) -> np.ndarray:
        """Float export in the target precision: f64 content exported to
        F64 must not round-trip through f32 (conv.rs converts directly)."""
        d = self.planes()
        if d.dtype.kind == "f":
            return d.astype(dtype, copy=False)
        if np.dtype(dtype) == np.float64:
            scale = 1.0 / (1 << (self.bits_per_sample - 1))
            return d.astype(np.float64) * scale
        return int_to_float(d, self.bits_per_sample).astype(dtype, copy=False)

    def to_int(self, bits: int, dither=None,
               dither_mode: str = "triangular") -> np.ndarray:
        """Planar signed integer export at the requested width.

        ``dither`` (a numpy Generator) enables dithered quantization of
        float content; ``dither_mode`` picks rectangular/triangular
        (conv.rs:147-270 Dither selection when narrowing)."""
        d = self.planes()
        if d.dtype.kind == "f":
            return float_to_int(d, bits, dither=dither,
                                dither_mode=dither_mode)
        return convert_int_width(d, self.bits_per_sample, bits)

    def copy_to_interleaved(self, fmt: SampleFormat, dither=None,
                            dither_mode: str = "triangular") -> np.ndarray:
        """Interleaved export in any target sample format
        ([frames * ch] flat, frame-major)."""
        ch = self.num_channels
        if fmt.is_float:
            out = self._to_float_as(fmt.np_dtype)
        else:
            bits = fmt.bits
            vals = self.to_int(bits, dither=dither, dither_mode=dither_mode)
            if fmt.is_unsigned:
                vals = vals + (1 << (bits - 1))
            out = vals.astype(fmt.np_dtype)
        return np.ascontiguousarray(out.T).reshape(ch * self.frames)

    def copy_to_planar(self, fmt: SampleFormat, dither=None,
                       dither_mode: str = "triangular") -> np.ndarray:
        if fmt.is_float:
            return self._to_float_as(fmt.np_dtype)
        vals = self.to_int(fmt.bits, dither=dither, dither_mode=dither_mode)
        if fmt.is_unsigned:
            vals = vals + (1 << (fmt.bits - 1))
        return vals.astype(fmt.np_dtype)
