"""Polyphase sample-rate converter.

Analog of symphonia-play's rubato-backed resampler (symphonia-play/src/
resampler.rs:177): converts decoded audio to an output device's rate when
it differs from the track's. Implemented as a windowed-sinc polyphase
filter via scipy.signal.resample_poly over the planar [ch, n] layout —
a dense filterbank, consistent with the framework's batch-first design
(the same conversion expressed as a strided matmul runs on device for bulk
workloads; this host path serves the streaming/playback tools).
"""

from __future__ import annotations

from math import gcd
from typing import Optional

import numpy as np


class Resampler:
    """Streaming rational resampler.

    ``process`` accepts planar float32 [ch, n] chunks and returns converted
    chunks; ``flush`` drains the tail. Internally each conversion block is
    aligned to a multiple of ``down`` input samples and surrounded by
    carried left context plus held-back right context (``margin`` samples,
    the converter's lookahead latency), so concatenated outputs match a
    whole-signal conversion away from the filter's edge ringing.
    """

    def __init__(self, rate_in: int, rate_out: int, n_channels: int,
                 margin: int = 256):
        g = gcd(rate_in, rate_out)
        self.up = rate_out // g
        self.down = rate_in // g
        self.rate_in = rate_in
        self.rate_out = rate_out
        self.n_channels = n_channels
        # Left-context length, rounded up to a whole number of `down`
        # periods so every block starts on the global output grid.
        self._lc = -(-margin // self.down) * self.down
        self.margin = margin
        self._fifo = np.zeros((n_channels, 0), np.float32)
        self._carry = np.zeros((n_channels, 0), np.float32)

    @property
    def is_identity(self) -> bool:
        return self.up == self.down

    def _convert(self, x: np.ndarray) -> np.ndarray:
        from scipy.signal import resample_poly

        return resample_poly(x, self.up, self.down, axis=1).astype(np.float32)

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, dtype=np.float32)
        if self.is_identity:
            return chunk
        self._fifo = np.concatenate([self._fifo, chunk], axis=1)
        usable = self._fifo.shape[1] - self.margin
        n_proc = (usable // self.down) * self.down if usable > 0 else 0
        if n_proc <= 0:
            return np.zeros((self.n_channels, 0), np.float32)
        lc = self._carry.shape[1]  # 0 or self._lc, both output-grid aligned
        x = np.concatenate([self._carry, self._fifo[:, : n_proc + self.margin]],
                           axis=1)
        y = self._convert(x)
        start = lc * self.up // self.down
        count = n_proc * self.up // self.down
        out = y[:, start : start + count]
        keep = min(self._lc, n_proc)
        self._carry = self._fifo[:, n_proc - keep : n_proc].copy()
        self._fifo = self._fifo[:, n_proc:]
        return out

    def flush(self) -> np.ndarray:
        if self.is_identity or (self._fifo.shape[1] == 0
                                and self._carry.shape[1] == 0):
            return np.zeros((self.n_channels, 0), np.float32)
        lc = self._carry.shape[1]
        x = np.concatenate([self._carry, self._fifo], axis=1)
        y = self._convert(x)
        start = lc * self.up // self.down
        self._fifo = np.zeros((self.n_channels, 0), np.float32)
        self._carry = np.zeros((self.n_channels, 0), np.float32)
        return y[:, start:]


def resample(audio: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """One-shot planar conversion (bulk path)."""
    if rate_in == rate_out:
        return np.asarray(audio, dtype=np.float32)
    from scipy.signal import resample_poly

    g = gcd(rate_in, rate_out)
    return resample_poly(np.asarray(audio, np.float32), rate_out // g,
                         rate_in // g, axis=1).astype(np.float32)
