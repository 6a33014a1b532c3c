"""Host-side fast IMDCT for the per-packet decoders.

The device pipelines keep IMDCT-as-matmul (MXU-friendly; ops/aac_dense,
codecs/vorbis imdct_matrix), but a [2n, n] matvec on the host is
memory-bound (~8 MB matrix for AAC's n=1024 — measured 415 us/call vs
22 us via DCT-IV). This module provides the O(n log n) route through
scipy's float32 DCT-IV (core dsp/mdct.rs uses the same FFT-backed
structure), with the matmul as fallback when scipy is absent.

Identity: the IMDCT kernel cos(pi/(2*n_out) (2i+1+n_in)(2j+1)) is the
DCT-IV kernel at row offset n_in/2; rows beyond n_in extend by the
cosine symmetries y[i] = -y-mirror, giving the three-segment assembly
below. Unscaled (pure cosine sum) — AAC divides by n_out afterwards.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy import fft as _sfft
except ImportError:  # pragma: no cover - scipy is in the image
    _sfft = None

try:
    # Same C kernel scipy.fft.dct dispatches to, minus ~8 us/call of
    # wrapper layers (measured; bit-identical output). Private API, so
    # fall back to the public entry point on any mismatch.
    from scipy.fft._pocketfft import pypocketfft as _pfft

    _ppdct = _pfft.dct
except Exception:  # pragma: no cover - depends on scipy internals
    _ppdct = None


def _dct4(x: np.ndarray) -> np.ndarray:
    if _ppdct is not None:
        try:
            return _ppdct(x, 4, (x.ndim - 1,), 0, None, 1, None)
        except TypeError:  # signature drift: use the public API
            pass
    return _sfft.dct(x, type=4, axis=-1)


def have_fast_imdct() -> bool:
    return _sfft is not None


def imdct_dct4(x: np.ndarray) -> np.ndarray:
    """Unscaled IMDCT along the last axis: [..., n] -> [..., 2n],
    y[i] = sum_j x[j] cos(pi/(4n) (2i+1+n)(2j+1)). Requires scipy."""
    n = x.shape[-1]
    d = _dct4(x)
    np.multiply(d, np.float32(0.5), out=d)
    y = np.empty(x.shape[:-1] + (2 * n,), d.dtype)
    h = n // 2
    y[..., :h] = d[..., h:]
    np.negative(d[..., ::-1], out=y[..., h : h + n])
    np.negative(d[..., :h], out=y[..., h + n :])
    return y
