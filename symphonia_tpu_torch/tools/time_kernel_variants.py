"""Time M1 ``mp3_hybrid``, A3 ``aac_ola`` and R1 ``rice_decode`` built from
other source trees.

    python3 -m symphonia_tpu_torch.tools.time_kernel_variants DIR [DIR ...]

Each DIR holds a full copy of ``symphonia_tpu_torch/csrc`` (edited or not).
For each, a fresh process builds the library from DIR into ``DIR/_build``,
checks the kernels against their plain twins, and prints one JSON line:
the kernels' registers, spill bytes and blocks per SM (R1's where the
source exports them), M1's device time (the replay of a CUDA graph of 50
calls) at [4096, 2, 576], [1024, 2, 576] and [64, 2, 576] for each run
length, A3's back-to-back and device time at [16384, 2048], R1's device
time at [8192, 4096] with k = 4 and at FLAC partitions [131072, 256] with
k 0..14 by lane, and the SM clock and power draw ``nvidia-smi`` reports
while M1 runs. It compares variants of a kernel on one card in one go; a
variant that computes something else on purpose (to see what a part of the
kernel costs) shows in ``m1_max_abs_err`` / ``a3_bits_equal`` /
``r1_bits_equal``. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

SEED = 20261016


def _graph_ms(fn, reps: int = 50) -> float:
    """Mean device milliseconds per call: ``reps`` calls in one CUDA graph,
    its replay timed with CUDA events."""
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


def _event_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _attributes(fn) -> dict:
    vals = (ctypes.c_int * 3)()
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    if fn(vals):
        raise RuntimeError("attribute query failed")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), vals))


def measure(csrc: str) -> dict:
    """Build from ``csrc`` and time both kernels (this process only)."""
    from ..ops import _build

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    src = pathlib.Path(csrc).resolve()
    _build.CSRC = src
    _build.BUILD_DIR = src / "_build"
    from ..ops import aac_dense as ad
    from ..ops import mp3_dense as md

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    lib = _build.lib()
    res = {"csrc": str(src),
           "m1": _attributes(lib.mp3_hybrid_attributes),
           "a3": _attributes(lib.aac_ola_attributes)}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    G, C = 4096, 2
    dense = md.Mp3Dense.from_numpy(md.reference_tables(), dev)
    bt = rng.integers(0, 4, size=(G, C)).astype(np.int32)
    cut = rng.random(G) < 0.01
    cut[0] = False
    args = (t((rng.standard_normal((G, C, 576)) * 0.1).astype(np.float32)),
            t(bt), t((bt == 2) & (rng.random((G, C)) < 0.5)), t(cut),
            t((rng.standard_normal((C, 32, 18)) * 0.1).astype(np.float32)),
            dense.hybrid, dense.cs, dense.ca, dense.finv)
    got, ref = md.mp3_hybrid(*args), md.mp3_hybrid_plain(*args)
    res["m1_max_abs_err"] = max(float((a - b).abs().max())
                                for a, b in zip(got, ref))
    for g in (G, G // 4, 64):
        a = tuple(x[:g].contiguous() for x in args[:4]) + args[4:]
        res[f"m1_graph_ms_G{g}"] = {
            r: round(_graph_ms(lambda: md.mp3_hybrid(*a, run=r)), 5)
            for r in md.RUN_LENGTHS}

    L = 16384
    ola = ad.AacDense.from_numpy(ad.reference_tables(), dev)
    lanes = (t((rng.standard_normal((L, 2048)) * 0.05).astype(np.float32)),
             t(rng.integers(0, 4, L).astype(np.int32)),
             t(rng.integers(0, 2, L).astype(np.int32)),
             t(rng.integers(0, 2, L).astype(np.int32)),
             t(rng.random(L) < 0.01))
    res["a3_bits_equal"] = bool(torch.equal(
        ola.ola(*lanes).view(torch.int32),
        ad.aac_ola_plain(*lanes, *ola.ola_tables).view(torch.int32)))
    res["a3_ms"] = round(_event_ms(lambda: ola.ola(*lanes)), 5)
    res["a3_graph_ms"] = round(_graph_ms(lambda: ola.ola(*lanes)), 5)

    res.update(_measure_r1(lib, dev))

    # The clock and power while M1 runs: a graph of 200 calls replayed 100
    # times before each reading.
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(200):
            md.mp3_hybrid(*args)
    for _ in range(6):
        for _ in range(100):
            g.replay()
        res["clocks_sm_power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        torch.cuda.synchronize()
    return res


def _measure_r1(lib, dev) -> dict:
    """R1 at the bench tool's shape and at FLAC partitions, 33.5M symbols
    each: bit-equality with the twin (residuals and end cursors) and the
    device time."""
    from ..ops import rice_device as rd
    from ..testing.rice_streams import make_mixed_streams

    res = {}
    try:
        res["r1"] = _attributes(lib.rice_decode_attributes)
    except AttributeError:  # a source from before the export
        res["r1"] = None
    data, cur, _ = rd.make_test_streams(8192, 4096, 4)
    mixed = make_mixed_streams(131072, 256, SEED)
    for name, (data, cur, par, n) in {
            "bench": (data, cur, np.full(8192, 4), 4096),
            "flac_partitions": (mixed[0], mixed[1], mixed[2], 256)}.items():
        args = (torch.from_numpy(rd.pack_bits_u32(data)).to(dev),
                torch.from_numpy(cur).to(dev),
                torch.from_numpy(par.astype(np.int32)).to(dev), n)
        got, want = rd.rice_decode_lanes(*args), rd.rice_decode_lanes_plain(
            *args)
        res[f"r1_bits_equal_{name}"] = all(
            bool(torch.equal(a, b)) for a, b in zip(got, want))
        del got, want
        res[f"r1_graph_ms_{name}"] = round(
            _graph_ms(lambda: rd.rice_decode_lanes(*args), 10), 5)
    return res


def main(argv=None) -> int:
    dirs = sys.argv[1:] if argv is None else list(argv)
    if not dirs:
        print(__doc__)
        return 2
    if len(dirs) == 1:
        print(json.dumps(measure(dirs[0])), flush=True)
        return 0
    rc = 0
    for d in dirs:  # a process each: a process loads one library
        rc |= subprocess.run([sys.executable, "-m", __spec__.name, d]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
