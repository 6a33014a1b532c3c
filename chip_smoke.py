#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (symphonia_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. environment: CUDA card, native host library, nvcc build of csrc/*.cu;
  2. each kernel (F1 flac_lpc, F2 flac_decorrelate, M1 mp3_hybrid,
     M2 mp3_synth) against its plain PyTorch twin on the card at the main
     path's shapes, with CUDA-event times for both; the MP3 dense stage
     against the reference's numpy oracle on a small input, and chained
     over two calls against one call;
  3. the slice: ``symphonia_tpu_torch.batch.decode_many`` on a mixed
     FLAC + MP3 Layer III batch built from a fixed seed with the repo's
     test encoders, on ``device="cuda"``: FLAC bit-exact to the source with
     STREAMINFO MD5 verified, MP3 against the port's CPU-twin path, no host
     route, every kernel launched.
The line before the last is a JSON object of per-kernel results; the last
is ``{"ok": true, "device": {...}}``. Exits non-zero and prints no result
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SR = 44100
FLAC_SECONDS = 10
MP3_FRAMES = 1149  # 30 s of MPEG-1 Layer III at 44.1 kHz (1152 per frame)
N_FLAC_ENTRIES = 64

# (stereo mode, subframe kind, bits per sample, builder keyword arguments)
FLAC_SPECS = [
    ("independent", "lpc", 16, dict(order=12)),
    ("left_side", "lpc", 16, dict(order=32)),
    ("right_side", "fixed", 16, dict(order=2, wasted=3)),
    ("mid_side", "verbatim", 16, dict()),
    ("mid_side", "lpc", 24, dict(order=8)),
]
MP3_SPECS = [(2, s) for s in range(16)] + [(1, 100), (1, 101)]

# Kernel -> (route, source, the TPU program it replaces)
KERNEL_INFO = {
    "flac_lpc": ("cuda", "symphonia_tpu_torch/csrc/flac_dense.cu",
                 "symphonia_tpu/ops/flac_dense.py:44"),
    "flac_decorrelate": ("cuda", "symphonia_tpu_torch/csrc/flac_dense.cu",
                         "symphonia_tpu/ops/flac_dense.py:84"),
    "mp3_hybrid": ("cuda", "symphonia_tpu_torch/csrc/mp3_dense.cu",
                   "symphonia_tpu/ops/mp3_dense.py:346"),
    "mp3_synth": ("cuda", "symphonia_tpu_torch/csrc/mp3_dense.cu",
                  "symphonia_tpu/ops/mp3_dense.py:346"),
}


def _paths() -> None:
    for p in (ROOT, os.path.join(ROOT, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def _lpc_coefs(order: int, seed: int):
    """Coefficients the encoder can code (15-bit precision, shift 12) that
    predict a smooth signal well: x[n-1] plus a zero-sum perturbation over
    the remaining taps, the last tap nonzero."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 41, size=order - 1) * rng.choice([-1, 1], order - 1)
    d[0] -= d.sum()
    return [4096] + [int(v) for v in d]


def build_flac(i: int):
    """One FLAC test stream -> (bytes, planar int64 source samples)."""
    _paths()
    from flac_builder import build_flac_file, random_walk

    mode, kind, bps, kw = FLAC_SPECS[i]
    n = SR * FLAC_SECONDS
    if kw.get("wasted"):
        w = kw["wasted"]
        chans = [c << w for c in random_walk(n, bps - w, seed=SEED + i, ch=2)]
        args = dict(kind=kind, order=kw["order"], wasted=w)
    else:
        chans = random_walk(n, bps, seed=SEED + i, ch=2)
        args = dict(kind=kind)
        if kind == "lpc":
            args.update(lpc_coefs=_lpc_coefs(kw["order"], SEED + i),
                        lpc_shift=12, lpc_precision=15)
        elif kind == "fixed":
            args.update(order=kw["order"])
    data = build_flac_file(chans, sample_rate=SR, bps=bps, block_size=4096,
                           stereo_mode=mode, **args)
    return data, np.stack(chans)


def build_mp3(i: int) -> bytes:
    _paths()
    from mp3_builder import build_mpeg1_l3_stream

    n_ch, seed = MP3_SPECS[i]
    return build_mpeg1_l3_stream(MP3_FRAMES, n_ch=n_ch, seed=SEED + seed)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_env() -> dict:
    import torch

    _paths()
    from symphonia_tpu import native
    from symphonia_tpu_torch.ops import _build

    if not native.available():
        raise RuntimeError("native host library unavailable (g++ build)")
    # The port's kernels do their own fp32 arithmetic; the plain twins that
    # phase 2 compares them with use torch.matmul, which must be true fp32
    # too (TF32 keeps ~10 mantissa bits, far outside the MP3 bar).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    _build.lib()
    load_s = time.perf_counter() - t0
    info = {
        "card": card_line(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_build_s": _build.build_seconds, "load_s": round(load_s, 3),
        "twin_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "twin_matmul_precision": torch.get_float32_matmul_precision(),
    }
    print("phase 1 environment:", json.dumps(info), flush=True)
    return info


def phase_kernels(L: int = 16384, n: int = 4112, G: int = 4096) -> dict:
    """Each kernel against its twin on the card at the main path's shapes."""
    import torch

    from symphonia_tpu.ops.mp3_dense import GranuleDenseState, granule_dense_np
    from symphonia_tpu_torch.ops import flac_dense as fd
    from symphonia_tpu_torch.ops import mp3_dense as md

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out = {}

    # F1: random orders 0-32, shifts 0-15, wasted 0-3; the sums wrap, and
    # both sides must wrap identically, so the comparison is exact.
    res = torch.from_numpy(rng.integers(-2**25, 2**25, size=(L, n),
                                        dtype=np.int32)).to(dev)
    coefs = torch.from_numpy(rng.integers(-2**14, 2**14, size=(L, 32),
                                          dtype=np.int32)).to(dev)
    order = torch.from_numpy(rng.integers(0, 33, size=L,
                                          dtype=np.int32)).to(dev)
    shift = torch.from_numpy(rng.integers(0, 16, size=L,
                                          dtype=np.int32)).to(dev)
    wasted = torch.from_numpy(rng.integers(0, 4, size=L,
                                           dtype=np.int32)).to(dev)
    got = fd.lpc_reconstruct_batch(res, coefs, order, shift, n, wasted=wasted)
    ref = fd.apply_wasted_bits(
        fd.lpc_reconstruct_plain(res, coefs, order, shift, n), wasted)
    torch.cuda.synchronize()
    err = int((got.long() - ref.long()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"flac_lpc differs from its twin: {err}")
    out["flac_lpc"] = dict(
        max_abs_err=err, shape=[L, n],
        ms=cuda_ms(lambda: fd.lpc_reconstruct_batch(
            res, coefs, order, shift, n, wasted=wasted), 5),
        plain_ms=cuda_ms(lambda: fd.apply_wasted_bits(
            fd.lpc_reconstruct_plain(res, coefs, order, shift, n), wasted), 1))

    # F2 on F1's output as frames [L/2, 2, n], all four assignments.
    x = got.reshape(L // 2, 2, n)
    assign = torch.from_numpy(rng.integers(0, 4, size=L // 2,
                                           dtype=np.int32)).to(dev)
    got2 = fd.decorrelate_batch(x, assign)
    ref2 = fd.decorrelate_plain(x, assign)
    torch.cuda.synchronize()
    if not torch.equal(got2, ref2):
        raise AssertionError("flac_decorrelate differs from its twin")
    out["flac_decorrelate"] = dict(
        max_abs_err=int((got2.long() - ref2.long()).abs().max()),
        shape=[L // 2, 2, n],
        ms=cuda_ms(lambda: fd.decorrelate_batch(x, assign), 20),
        plain_ms=cuda_ms(lambda: fd.decorrelate_plain(x, assign), 5))

    # M1 -> M2 at G granules, C = 2: every block type and mixed flag, a
    # boundary mask, nonzero carried tails; spectra at x0.1.
    C = 2
    dense = md.Mp3Dense.from_numpy(md.reference_tables(), dev)
    xs = torch.from_numpy((rng.standard_normal((G, C, 576)) * 0.1)
                          .astype(np.float32)).to(dev)
    bt_np = rng.integers(0, 4, size=(G, C)).astype(np.int32)
    bt = torch.from_numpy(bt_np).to(dev)
    mixed = torch.from_numpy((bt_np == 2) & (rng.random((G, C)) < 0.5)).to(dev)
    bd_np = rng.random(G) < 0.01
    bd_np[0] = False
    boundary = torch.from_numpy(bd_np).to(dev)
    ht0 = torch.from_numpy((rng.standard_normal((C, 32, 18)) * 0.1)
                           .astype(np.float32)).to(dev)
    st0 = torch.from_numpy((rng.standard_normal((C, 480)) * 0.1)
                           .astype(np.float32)).to(dev)
    hyb_args = (xs, bt, mixed, boundary, ht0, dense.hybrid, dense.cs,
                dense.ca, dense.finv)
    S, tail = md.mp3_hybrid(*hyb_args)
    S_ref, tail_ref = md.mp3_hybrid_plain(*hyb_args)
    e_m1 = max(float((S - S_ref).abs().max()),
               float((tail - tail_ref).abs().max()))
    syn_args = (S, dense.polyphase, st0, boundary)
    pcm, st = md.mp3_synth(*syn_args)
    pcm_ref, st_ref = md.mp3_synth_plain(*syn_args)
    e_m2 = max(float((pcm - pcm_ref).abs().max()),
               float((st - st_ref).abs().max()))
    # The whole chain, kernels vs twins on the CPU, at the parity bar.
    chain = dense(xs, bt, mixed, ht0, st0, boundary=boundary)
    dense_cpu = md.Mp3Dense.from_numpy(md.reference_tables(), "cpu")
    chain_cpu = dense_cpu(*(t.cpu() for t in (xs, bt, mixed, ht0, st0)),
                          boundary=boundary.cpu())
    e_chain = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(chain, chain_cpu))
    if max(e_m1, e_m2, e_chain) > 2e-5:
        raise AssertionError(f"mp3 kernels vs twins: M1 {e_m1} M2 {e_m2} "
                             f"chain {e_chain} > 2e-5")
    # Two chained calls against one call (the reference's 1e-6 bar).
    h = G // 2 + 3
    first = dense(xs[:h], bt[:h], mixed[:h], ht0, st0, boundary=boundary[:h])
    second = dense(xs[h:], bt[h:], mixed[h:], first[1], first[2],
                   boundary=boundary[h:])
    e_chunks = max(float((torch.cat([first[0], second[0]]) - chain[0])
                         .abs().max()),
                   float((second[1] - chain[1]).abs().max()),
                   float((second[2] - chain[2]).abs().max()))
    if e_chunks > 1e-6:
        raise AssertionError(f"mp3 chained calls vs one call: {e_chunks}")
    out["mp3_hybrid"] = dict(
        max_abs_err=e_m1, shape=[G, C, 576],
        ms=cuda_ms(lambda: md.mp3_hybrid(*hyb_args), 20),
        plain_ms=cuda_ms(lambda: md.mp3_hybrid_plain(*hyb_args), 5))
    out["mp3_synth"] = dict(
        max_abs_err=e_m2, shape=[G, C, 576],
        ms=cuda_ms(lambda: md.mp3_synth(*syn_args), 20),
        plain_ms=cuda_ms(lambda: md.mp3_synth_plain(*syn_args), 20))

    # The reference's own oracle: the stateful numpy per-granule chain.
    g_small = 6
    x_s = xs[:g_small].cpu().numpy()
    bt_s, mx_s = bt_np[:g_small], mixed[:g_small].cpu().numpy()
    states = [GranuleDenseState() for _ in range(C)]
    expect = np.stack([np.stack([
        granule_dense_np(x_s[g, c].copy(), int(bt_s[g, c]), bool(mx_s[g, c]),
                         states[c]) for c in range(C)]) for g in range(g_small)])
    small = dense(xs[:g_small].contiguous(), bt[:g_small].contiguous(),
                  mixed[:g_small].contiguous())[0].cpu().numpy()
    e_oracle = float(np.abs(small - expect).max())
    if e_oracle > 2e-5:
        raise AssertionError(f"mp3 dense vs numpy oracle: {e_oracle}")
    print("phase 2 kernels vs twins:", json.dumps(
        {**{k: {kk: (round(vv, 4) if kk.endswith("ms") else vv)
                for kk, vv in v.items()} for k, v in out.items()},
         "mp3_chain_vs_cpu_twin": e_chain, "mp3_vs_numpy_oracle": e_oracle,
         "mp3_chunks_vs_one_call": e_chunks}), flush=True)
    return out


def build_inputs():
    """FLAC and MP3 streams from the fixed seed, built in worker processes."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        flac_f = [pool.submit(build_flac, i) for i in range(len(FLAC_SPECS))]
        mp3_f = [pool.submit(build_mp3, i) for i in range(len(MP3_SPECS))]
        flacs = [f.result() for f in flac_f]
        mp3s = [f.result() for f in mp3_f]
    return flacs, mp3s, time.perf_counter() - t0


def phase_slice() -> dict:
    import torch

    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.ops import _build

    flacs, mp3s, build_s = build_inputs()
    # The batch: FLAC entries cycle over the distinct streams, MP3 streams
    # interleave, so input order is exercised across codecs.
    items = [("flac", i % len(flacs)) for i in range(N_FLAC_ENTRIES)]
    for j in range(len(mp3s)):
        items.insert(3 * j + 1, ("mp3", j))
    datas = [flacs[i][0] if kind == "flac" else mp3s[i] for kind, i in items]
    audio_s = 0.0

    torch.cuda.synchronize()
    batch.host_routes = 0
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = batch.decode_many(datas, device="cuda", verify=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    routes = batch.host_routes

    if routes != 0:
        raise AssertionError(f"host_routes == {routes}")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    mp3_outs = []
    for (kind, i), out in zip(items, outs):
        audio_s += out.samples.shape[1] / out.sample_rate
        if kind == "flac":
            src = flacs[i][1]
            if out.md5_ok is not True:
                raise AssertionError(f"flac entry {i}: md5_ok={out.md5_ok}")
            if not np.array_equal(out.samples.astype(np.int64), src):
                raise AssertionError(f"flac entry {i} differs from source")
        else:
            mp3_outs.append(out)
    # MP3 against the port's CPU-twin path (K = 576 fp32 sums in another
    # order; builder streams reach |pcm| ~ 6, hence 1e-4).
    cpu = batch.Mp3BatchDecoder(device="cpu").decode_many(mp3s)
    e_mp3 = 0.0
    for a, b in zip(mp3_outs, cpu):
        if a.samples.shape != b.samples.shape:
            raise AssertionError("mp3 shape differs from the CPU twin path")
        if not np.isfinite(a.samples).all():
            raise AssertionError("mp3 output not finite")
        e_mp3 = max(e_mp3, float(np.abs(a.samples - b.samples).max()))
    if e_mp3 > 1e-4:
        raise AssertionError(f"mp3 vs CPU twin path: {e_mp3} > 1e-4")
    info = {
        "entries": len(datas), "flac_entries": N_FLAC_ENTRIES,
        "mp3_entries": len(mp3s), "input_build_s": round(build_s, 1),
        "wall_s": round(wall, 3), "audio_s": round(audio_s, 1),
        "realtime_x": round(audio_s / wall, 1), "host_routes": routes,
        "launches": launches, "mp3_max_abs_err_vs_cpu": e_mp3,
        "card": card_line(),
    }
    print("phase 3 slice decode_many:", json.dumps(info), flush=True)
    return info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    _paths()
    env = phase_env()
    kern = phase_kernels()
    sl = phase_slice()
    rows = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        k = kern[name]
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces,
                     "launches": sl["launches"][name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"]})
    print(env["card"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
