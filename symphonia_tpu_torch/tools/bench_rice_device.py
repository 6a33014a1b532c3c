"""Measure the device FLAC Rice decode kernel R1 ``rice_decode`` on the card.

Port of ``tools/bench_rice_device.py``: ``B`` lanes of ``n`` Rice symbols
with parameter ``k`` from ``make_test_streams``, decoded ``iters`` times.
Each repetition times the ``iters`` launches with CUDA events (in place of
the reference's ``fori_loop`` inside one jit); the best of three counts.
Prints the platform, the first call (the kernels' build included), the
wall time, Msamples/s, realtime x at 44.1 kHz mono-sample equivalent, and
whether the first 8 lanes decode to the encoded values.

Usage: python -m symphonia_tpu_torch.tools.bench_rice_device [B n k iters]
"""

import sys
import time

import numpy as np
import torch

from ..batch import resolve_device
from ..ops.rice_device import (make_test_streams, pack_bits_u32,
                               rice_decode_lanes)


def main(B=8192, n=4096, k=4, iters=4, device="cuda") -> dict:
    """Run the measurement and return its numbers: ``platform``,
    ``first_call_s``, ``wall_ms`` (``iters`` launches), ``msamples_per_s``,
    ``realtime_x`` and ``correct_slice``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    platform = (f"cuda ({torch.cuda.get_device_name(dev)})" if on_card
                else "cpu")
    print(f"platform: {platform}", flush=True)
    data, cur, vals = make_test_streams(B, n, k)
    words = torch.from_numpy(pack_bits_u32(data)).to(dev)
    cur0 = torch.from_numpy(np.asarray(cur, np.int32)).to(dev)
    par = torch.from_numpy(np.full(B, k, np.int32)).to(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    rice_decode_lanes(words, cur0, par, n)
    sync()
    first = time.perf_counter() - t0
    print(f"first call (incl. build): {first:.1f}s", flush=True)
    best = 1e9
    for _ in range(3):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                rice_decode_lanes(words, cur0, par, n)
            b.record()
            sync()
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                rice_decode_lanes(words, cur0, par, n)
            dt = time.perf_counter() - t0
        best = min(best, dt)
    samples = B * n * iters
    audio_s = samples / 44100.0
    rtx = audio_s / best
    print(f"B={B} n={n} k={k} iters={iters}: wall {best*1e3:.1f} ms, "
          f"{samples/best/1e6:.0f} Msamples/s, {rtx:.0f}x realtime "
          f"(44.1k mono-sample equivalent)", flush=True)

    # Correctness spot check on a slice.
    out, _ = rice_decode_lanes(words, cur0[:8], par[:8], n)
    ok = bool((out.cpu().numpy() == vals[:8]).all())
    print(f"correctness slice: {ok}", flush=True)
    return {"platform": platform, "first_call_s": first,
            "wall_ms": best * 1e3, "msamples_per_s": samples / best / 1e6,
            "realtime_x": rtx, "correct_slice": ok}


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
