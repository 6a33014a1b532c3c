"""Plain reference for the FLAC cells: the generator's source samples.

FLAC is lossless, so each stream's expected PCM is the source the
generator encoded, with its rate, channel count and length; STREAMINFO's
MD5 is verified by the decoder (``md5_ok``). Nothing of the program is
imported or used.

``control`` is the control. The configuration states no float precision,
so it breaks a guarantee the configuration states: the reference decoder
(residuals from the generator's source and predictor, then the LPC
recurrence in int64) with STREAMINFO's MD5 left unchecked, the step that
would tempt a port, since MD5 is a third of a bulk request's time. Its
samples are exact, and ``md5_not_verified`` fails it.
"""

from __future__ import annotations

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


def control(streams, device="cpu") -> list:
    """The control: decode each stream from its residuals by the LPC
    recurrence in int64, all frames of all streams in parallel and their
    samples in turn, and leave the MD5 unchecked (``md5_ok`` None)."""
    rows = []  # (stream, start, block)
    for si, s in enumerate(streams):
        st = 0
        for b in s.blocks.tolist():
            rows.append((si, st, b))
            st += b
    B = max(b for _, _, b in rows)
    O = len(streams[0].lpc["coefs"])
    X = torch.zeros((len(rows), B), dtype=torch.int64)
    for f, (si, st, b) in enumerate(rows):
        X[f, :b] = torch.from_numpy(streams[si].pcm[0, st : st + b])
    C = torch.from_numpy(np.stack([streams[si].lpc["coefs"]
                                   for si, _, _ in rows]))
    shift = torch.tensor([streams[si].lpc["shift"] for si, _, _ in rows])
    X, C, shift = X.to(device), C.to(device), shift.to(device)
    acc = torch.zeros_like(X)
    for j in range(O):
        acc[:, O:] += C[:, j : j + 1] * X[:, O - 1 - j : B - 1 - j]
    res = X - (acc >> shift[:, None])
    Y = X.clone()
    Cr = C.flip(1)
    for n in range(O, B):
        pred = (Y[:, n - O : n] * Cr).sum(1)
        Y[:, n] = res[:, n] + (pred >> shift)
    Y = Y.cpu().numpy()
    outs = []
    for si, s in enumerate(streams):
        pcm = np.concatenate([Y[f, :b] for f, (sj, _, b) in enumerate(rows)
                              if sj == si])[None, :]
        outs.append(Decoded(pcm, s.sample_rate, None))
    return outs
