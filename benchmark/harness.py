"""The benchmark's run: one cell of ``BENCHMARK.json``, one seed.

Everything a cell is made of is found by name: its configuration file
(``configs/<config>.json``, whose ``codec`` names the generator
``gen/<codec>.py``, the reference ``reference/<codec>.py`` and the kernel
work ``work/<codec>.py``), its traffic file (``traffic/<traffic>.json``,
read by :mod:`benchmark.traffic`) and one reader per metric
(``metrics/``). A run generates the inputs from the seed, warms up, drives
``symphonia_tpu_torch.batch.decode_many`` for the window, then checks every
output against the reference and prints one JSON line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import traffic as traffic_mod
from .spans import REQUEST, WINDOW, Spans, reduce_trace

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "symphonia_tpu")


class RunError(RuntimeError):
    """A run that must not print a result."""


@dataclass
class Context:
    """What the metric readers read."""

    setup_s: float
    window_s: float = 0.0
    requests: int = 0
    streams: int = 0
    audio_s: float = 0.0
    latencies_ms: list = field(default_factory=list)
    self_s: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)
    launches: int = 0
    least_kernel_s: float = 0.0
    trace: dict | None = None

    def share(self, names) -> float | None:
        """Percent of the window in the self time of ``names``; None when
        none of them was called."""
        if not any(self.calls.get(n) for n in names) or self.window_s <= 0:
            return None
        return 100.0 * sum(self.self_s.get(n, 0.0) for n in names) / (
            self.window_s)


# ---------------------------------------------------------------------------
# Finding a cell's parts
# ---------------------------------------------------------------------------

def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def paths(spec: dict, workload: str, root: Path) -> dict:
    """Every file a cell is made of, found by the names in
    ``BENCHMARK.json`` (a missing one raises)."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    out = {"config": root / c["file"],
           "traffic": bench / "traffic" / f"{w['traffic']}.json"}
    codec = json.loads(out["config"].read_text())["codec"]
    for kind in ("gen", "reference", "work"):
        out[kind] = bench / kind / f"{codec}.py"
    for m in spec["end_to_end"] + spec["per_layer"]:
        if workload in m.get("workloads", [workload]):
            out["metric:" + m["name"]] = reader_path(m["name"], root)
    for k, p in out.items():
        if not p.is_file():
            raise RunError(f"{k}: {p} is missing")
    return out


def cell(spec: dict, workload: str, root: Path) -> dict:
    """The workload entry, its configuration and traffic, and the metrics
    it reports by ``--trace``."""
    files = paths(spec, workload, root)
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    cfg = json.loads(files["config"].read_text())
    tr = json.loads(files["traffic"].read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {"workload": w, "config": cfg, "traffic": tr,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def reader_path(name: str, root: Path) -> Path:
    """``metrics/<name>.py``, else the file of the name's part before its
    first dot (``dispatch_share.bulk`` -> ``dispatch_share.py``)."""
    for stem in (name, name.split(".")[0]):
        path = root / "benchmark" / "metrics" / f"{stem}.py"
        if path.is_file():
            return path
    raise RunError(f"no reader for metric {name!r}")


def reader(name: str, root: Path):
    """The metric's reader module, loaded from its file."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def codec_module(kind: str, codec: str):
    return importlib.import_module(f"benchmark.{kind}.{codec}")


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name, power limit and SM clock from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "nvidia-smi unavailable"


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise RunError(f"the cell asks for {n} cards, "
                       f"{torch.cuda.device_count()} present")


def host_counters() -> dict:
    """This process's CPU seconds, all and in the kernel: read at the
    window's ends, they tell a host that ran slower from one that
    stalled."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime}


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", root: Path | None = None, decode=None) -> dict:
    """One run -> the result dict (``checks`` last). ``t0`` is the
    process's start on the ``time.perf_counter`` clock. ``device`` and
    ``decode`` (in place of ``batch.decode_many``) are for the tests."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    root = root or HERE.parent
    spec = load_spec(root)
    c = cell(spec, workload, root)
    cfg, tr = c["config"], c["traffic"]
    codec = cfg["codec"]
    gen, ref, work = (codec_module(k, codec)
                      for k in ("gen", "reference", "work"))

    from symphonia_tpu_torch import batch, native
    from symphonia_tpu_torch.ops import _build

    if not native.available():
        raise RunError("the native host library is not available: the "
                       "Python fallback is not the path measured")
    decode = decode or batch.decode_many
    kw = dict(device=device, verify=bool(cfg.get("verify", False)))

    t_gen = time.perf_counter()
    pool = gen.make_pool(cfg, int(tr["pool"]), seed, device)
    audio = np.array([s.seconds for s in pool])
    t_warm = time.perf_counter()
    for idx in traffic_mod.warm_up(tr, pool):
        decode([pool[i].data for i in idx], **kw)
    log(f"set-up: to the inputs {t_gen - t0:.3f} s, inputs "
        f"{t_warm - t_gen:.3f} s, warm-up {time.perf_counter() - t_warm:.3f}"
        f" s; pool {len(pool)} streams, {audio.sum():.3f} s of audio, "
        f"{sum(len(s.data) for s in pool)} bytes")
    if device == "cuda":
        # The caching allocator keeps what warm-up reserved, so the window
        # allocates nothing anew; the peak is counted from here.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    wraps = {w for m in c["per_layer"] for w in reader(m["name"], root).WRAPS}
    spans = Spans(wraps if trace else [], annotate=trace)
    spans.install()
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    launches0 = sum(_build.LAUNCHES.values())
    requests, lat_ms, failed = [], [], 0
    reqs = traffic_mod.requests(tr, seed)

    # The window: one caller, each request in as the last one returns.
    host0 = host_counters()
    start = time.perf_counter()
    ctx = Context(setup_s=start - t0)
    end = start
    spans.active = True
    with record_function(WINDOW):
        while end - start < seconds:
            idx = next(reqs)
            t_in = time.perf_counter()
            try:
                with record_function(REQUEST):
                    outs = decode([pool[i].data for i in idx], **kw)
            except Exception as e:  # noqa: BLE001 - counted and judged
                log(f"request failed: {type(e).__name__}: {e}")
                failed += 1
                outs = []
            end = time.perf_counter()
            lat_ms.append((end - t_in) * 1e3)
            # Outputs kept for the check: the same requests for every
            # seed (keeping all would make the window measure the host's
            # memory growth).
            keep = traffic_mod.kept(tr, len(requests))
            requests.append((idx, list(outs) if keep else None, len(outs)))
    spans.active = False
    ctx.window_s = end - start
    host = {k: v - host0[k] for k, v in host_counters().items()}
    if prof is not None:
        prof.__exit__(None, None, None)
    spans.uninstall()
    ctx.launches = sum(_build.LAUNCHES.values()) - launches0
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    banned = banned_modules()
    if banned:
        raise RunError("modules of JAX or the JAX package were loaded: "
                       + ", ".join(banned))
    if batch.host_routes or batch.packet_routes:
        raise RunError(f"streams left the batch path: host_routes="
                       f"{batch.host_routes} packet_routes="
                       f"{batch.packet_routes}")

    ok_req = [(idx, n) for idx, _, n in requests if n]
    kept = [(idx, outs) for idx, outs, _ in requests if outs is not None]
    ctx.requests = len(requests)
    ctx.streams = sum(len(idx) for idx, _, _ in requests)
    ctx.audio_s = float(sum(audio[idx].sum() for idx, _ in ok_req))
    ctx.latencies_ms = lat_ms
    ctx.self_s, ctx.calls = dict(spans.self_s), dict(spans.calls)
    ctx.least_kernel_s = sum(work.least_s(pool, idx) for idx, _ in ok_req)
    if prof is not None:
        ctx.trace = reduce_trace(prof)
        del prof

    # The checks, once the window has closed and the peak is read.
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    missing = sum(max(0, len(idx) - n) for idx, _, n in requests)
    numbers = {"requests_failed": failed, "streams_missing": missing}
    numbers.update(ref.judge(pool, kept, device))
    limits = dict(cfg["checks"], requests_failed=0, streams_missing=0)
    correct = bool(kept) and numbers["streams_compared"] > 0 and all(
        numbers[k] <= v for k, v in limits.items())
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    q = np.percentile(lat_ms, [0, 50, 95, 100]) if lat_ms else [0] * 4
    log(f"requests={ctx.requests} streams={ctx.streams} "
        f"latency_samples={len(lat_ms)} latency_ms min/p50/p95/max="
        f"{q[0]:.3f}/{q[1]:.3f}/{q[2]:.3f}/{q[3]:.3f} "
        f"window_s={ctx.window_s:.6f} audio_s={ctx.audio_s:.3f} "
        f"compared_requests={len(kept)} "
        f"check_s={time.perf_counter() - t_check:.3f}")

    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        v = reader(m["name"], root).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": int(c["workload"]["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": ctx.requests, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        t = ctx.trace or {}
        dev["busy_s"] = t.get("busy_s", 0.0)
        dev["window_s"] = t.get("window_s", ctx.window_s)
        if t:
            out["breakdown"] = t["breakdown"]
    log(f"host in the window: cpu_s={host['cpu_s']:.3f} "
        f"sys_s={host['sys_s']:.3f} cpu_share="
        f"{100.0 * host['cpu_s'] / max(ctx.window_s, 1e-9):.2f}%")
    log("latency_ms by fifth of the window (p50/p95): " + " ".join(
        f"{np.percentile(b, 50):.3f}/{np.percentile(b, 95):.3f}"
        for b in np.array_split(np.array(lat_ms), 5) if len(b)))
    for k, v in checks.items():
        log(f"check {k} = {v['value']} (limit {v['limit']})")
    out["checks"] = checks
    return out


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    t0 = time.perf_counter() if t0 is None else t0
    try:
        spec = load_spec(HERE.parent)
        chips = int(cell(spec, a.workload, HERE.parent)["workload"]["chips"])
        require_cards(chips)
        log(f"card: {card_line()}")
        res = run(a.workload, a.seed, a.seconds, bool(a.trace), t0)
    except RunError as e:
        log(f"benchmark: {e}")
        return 2
    print(json.dumps(res), flush=True)
    return 0
