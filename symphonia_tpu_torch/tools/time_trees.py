"""Time the entry step, A1 and V1 in whole checkouts of the repository.

    python3 -m symphonia_tpu_torch.tools.time_trees ROOT [ROOT ...]

Each ROOT is a checkout (for example the parent commit unpacked with ``git
archive`` into a git-ignored directory). For each, in the order given, a
fresh process imports ``symphonia_tpu_torch`` from ROOT (so its wrappers
and its ``csrc/`` go together), builds its kernels into ROOT's own
``_build/``, and prints one JSON line: A1's and V1's registers, spill
bytes and blocks per SM; A1 on contiguous rows (long with its dequant
prologue, 80% handoff, and without it at [16384, 1024], short at [8192,
128]) and V1 at [16384, 1024] -> 2048, CUDA-event means; the entry step
(``entry.decode_step`` at ``chip_smoke.py``'s full width and seed) eager,
and each of its four codec stages alone; a digest of the step's outputs,
so that two trees can be seen to compute the same bits; the SM clock,
power draw and power limit. Give the trees in turns (parent, change,
change, parent) to compare two versions on one card. Needs a CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

SEED = 20261016
STEP_SIZE = dict(F=8192, N=4096, G=4096, A=16384, V=16384, n1=2048)


def _event_ms(fn, reps: int) -> float:
    import torch

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


def _attributes(fn, *args) -> dict:
    import ctypes

    vals = (ctypes.c_int * 3)()
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    if fn(*args, vals):
        raise RuntimeError("attribute query failed")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), vals))


def measure(root: str) -> dict:
    """Import the package from ``root`` and time it (this process only)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import symphonia_tpu_torch
    from symphonia_tpu_torch import entry
    from symphonia_tpu_torch.codecs.aac import subband_info
    from symphonia_tpu_torch.ops import _build
    from symphonia_tpu_torch.ops import aac_dense as ad
    from symphonia_tpu_torch.ops import vorbis_dense as vd

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = _build.lib()
    res = {"root": root, "package": symphonia_tpu_torch.__file__,
           "build_s": round(time.perf_counter() - t0, 2),
           "aac_imdct_prologue": _attributes(lib.aac_imdct_attributes, 1),
           "aac_imdct": _attributes(lib.aac_imdct_attributes, 0),
           "vorbis_imdct": _attributes(lib.vorbis_imdct_attributes)}
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    L = 16384
    dense = ad.AacDense.from_numpy(ad.reference_tables(), dev)
    x = t((rng.standard_normal((L, 1024)) * 0.1).astype(np.float32))
    qbuf = np.clip(np.rint(rng.laplace(0.0, 4.0, (L, 1024))), -60, 60)
    scales = np.exp2((rng.integers(60, 100, (L, 64)) - 100) / 4.0)
    deq = (rng.random(L) >= 0.8).astype(np.int32)
    quant = dense.quant(t(qbuf.astype(np.int16)),
                        t(scales.astype(np.float32)), t(deq),
                        subband_info(44100)[1])
    xs = t((rng.standard_normal((8192, 128)) * 0.1).astype(np.float32))
    v = vd.VorbisDense({}, dev)
    m2048 = v.matrix(2048)
    res["ms"] = {
        "aac_imdct_long_prologue": _event_ms(
            lambda: ad.aac_imdct(x, dense.imdct_long, quant), 10),
        "aac_imdct_long": _event_ms(
            lambda: ad.aac_imdct(x, dense.imdct_long), 10),
        "aac_imdct_short": _event_ms(
            lambda: ad.aac_imdct(xs, dense.imdct_short), 10),
        "vorbis_imdct_2048": _event_ms(lambda: vd.vorbis_imdct(x, m2048),
                                       10)}
    del x, xs, quant

    host = entry.example_batch(**STEP_SIZE, seed=SEED)
    args = [torch.from_numpy(a).to(dev) for a in host]
    N = STEP_SIZE["N"]
    outs = entry.decode_step(*args, n_samples=N)
    torch.cuda.synchronize()
    res["step_digest"] = {
        name: hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()[:16]
        for name, o in zip(("flac", "mp3", "aac", "vorbis"), outs)}
    del outs
    step = [_event_ms(lambda: entry.decode_step(*args, n_samples=N), 10)
            for _ in range(2)]
    stages = {
        "flac": lambda: entry.flac_step(entry._stages(False), *args[0:6], N),
        "mp3": lambda: entry.mp3_step(entry._stages(False), *args[6:9]),
        "aac": lambda: entry.aac_step(entry._stages(False), *args[9:17]),
        "vorbis": lambda: entry.vorbis_step(entry._stages(False), args[17])}
    res["step_ms"] = step
    res["stage_ms"] = {k: _event_ms(f, 10) for k, f in stages.items()}
    res["clocks_sm_power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args[:1] == ["--in-process"]:
        print(json.dumps(measure(args[1])), flush=True)
        return 0
    if not args:
        print(__doc__)
        return 2
    rc = 0
    for r in args:  # a process each, with nothing of this tree on its path
        rc |= subprocess.run([sys.executable, "-P", __file__, "--in-process",
                              os.path.abspath(r)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
