"""Plain reference for the stereo FLAC music cell: the generator's source
samples.

FLAC is lossless, so each track's expected PCM is the stereo source the
generator encoded, with its rate, two channels and its length; the
STREAMINFO MD5 is verified by the decoder (``md5_ok``). Nothing of the
program is imported or used.

``control`` is the control: a plain int64 decoder (each frame's two
subframe signals from the source and the channel assignment, their
residuals from the generator's predictors, the LPC recurrence, then the
assignment undone) with the classic mid/side slip: it rebuilds mid/side
frames without the side channel's low bit. It checks its output against
STREAMINFO's MD5 as a decoder would. ``mismatched_samples`` reads it
wrong, and so does ``md5_not_verified``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def judge(pool, requests, device) -> dict:
    """The compared numbers over every stream of every request: requests
    is a list of (pool indices, outputs), each output having ``samples``,
    ``sample_rate`` and ``md5_ok``."""
    wrong_shape = mismatched = md5_failed = streams = 0
    for idx, outs in requests:
        for i, out in zip(idx, outs):
            s = pool[i]
            streams += 1
            got = np.asarray(out.samples)
            if (out.sample_rate != s.sample_rate
                    or got.shape != s.pcm.shape):
                wrong_shape += 1
                continue
            mismatched += int(np.count_nonzero(got != s.pcm))
            md5_failed += out.md5_ok is not True
    return {"streams_wrong_shape": wrong_shape,
            "mismatched_samples": mismatched,
            "md5_not_verified": md5_failed,
            "streams_compared": streams}


class Decoded:
    """An output as the program gives one, for the control."""

    def __init__(self, samples, sample_rate, md5_ok):
        self.samples, self.sample_rate, self.md5_ok = (samples, sample_rate,
                                                       md5_ok)


# The two subframes of each channel assignment (independent, left/side,
# right/side, mid/side), as rows of (left, right, mid, side).
PAIRS = ((0, 1), (0, 3), (3, 1), (2, 3))


def _md5(pcm: np.ndarray, bps: int) -> bytes:
    inter = np.ascontiguousarray(pcm.T).reshape(-1).astype("<i4")
    width = (bps + 7) // 8
    b = inter.view(np.uint8).reshape(-1, 4)[:, :width]
    return hashlib.md5(np.ascontiguousarray(b).tobytes()).digest()


def _streaminfo_md5(data: bytes) -> bytes:
    """STREAMINFO's MD5: the last 16 bytes of the 34-byte block that
    follows ``fLaC`` and its 4-byte block header."""
    return bytes(data[8 + 18 : 8 + 34])


def decode_track(s, device="cpu", slip: bool = True) -> np.ndarray:
    """One track decoded by the plain int64 path -> int32 [2, n]; with
    ``slip``, mid/side frames rebuilt without the side's low bit."""
    f = s.frames
    blocks = np.asarray(s.blocks, np.int64)
    F, B = len(blocks), int(blocks.max())
    n = s.pcm.shape[1]
    x = np.zeros((2, F * B), np.int64)
    x[:, :n] = s.pcm
    x = torch.from_numpy(x).view(2, F, B).transpose(0, 1).to(device)
    left, right = x[:, 0], x[:, 1]
    cand = torch.stack([left, right, (left + right) >> 1, left - right], 1)
    pair = torch.as_tensor(PAIRS, device=device)[
        torch.from_numpy(f["assign"]).to(device)]
    rows = torch.arange(F, device=device)[:, None]
    sub = cand[rows, pair].reshape(2 * F, B)
    C = torch.from_numpy(f["coefs"]).to(device).reshape(2 * F, -1)
    shift = torch.from_numpy(f["shift"]).to(device).reshape(2 * F)
    O = C.shape[1]
    # Residuals from the generator's predictors, then the recurrence.
    acc = torch.zeros_like(sub)
    for j in range(O):
        acc[:, O:] += C[:, j : j + 1] * sub[:, O - 1 - j : B - 1 - j]
    res = sub - (acc >> shift[:, None])
    y = sub.clone()
    Cr = C.flip(1)
    for t in range(O, B):
        y[:, t] = res[:, t] + ((y[:, t - O : t] * Cr).sum(1) >> shift)
    y = y.view(F, 2, B)
    a = torch.from_numpy(f["assign"]).to(device)[:, None]
    c0, c1 = y[:, 0], y[:, 1]
    mid = c0 << 1 if slip else (c0 << 1) | (c1 & 1)
    out0 = torch.where(a == 2, c0 + c1,
                       torch.where(a == 3, (mid + c1) >> 1, c0))
    out1 = torch.where(a == 1, c0 - c1,
                       torch.where(a == 3, (mid - c1) >> 1, c1))
    pcm = torch.stack([out0, out1], 0).reshape(2, F * B)[:, :n]
    return pcm.to(torch.int32).cpu().numpy()


def control(streams, device="cpu") -> list:
    """The control: each track decoded by :func:`decode_track`, its MD5
    checked against STREAMINFO's."""
    outs = []
    for s in streams:
        pcm = decode_track(s, device)
        outs.append(Decoded(pcm, s.sample_rate,
                            _md5(pcm, s.bits) == _streaminfo_md5(s.data)))
    return outs
