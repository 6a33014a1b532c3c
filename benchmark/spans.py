"""Host spans around named callables of the port, and the device trace.

The benchmark records spans from its own files: at set-up it wraps the
callables that the cell's per-layer metrics name (``WRAPS`` in each
metric's file, ``"module:Qualified.name"``), and each call inside the
window adds its self time (its duration less that of wrapped calls inside
it) to its name. In a traced run each span is also a
``torch.profiler.record_function`` range, so that the device's idle gaps
can be named by the span that was open on the host. A name that no longer
resolves fails the run.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import time
from collections import defaultdict
from contextlib import nullcontext

WINDOW = "benchmark.window"
REQUEST = "benchmark.request"


def resolve(target: str):
    """``"module:Qual.name"`` -> (owner object, attribute, its value)."""
    mod_name, _, qual = target.partition(":")
    owner = importlib.import_module(mod_name)
    *path, attr = qual.split(".")
    for p in path:
        owner = getattr(owner, p)
    if not hasattr(owner, attr):
        raise AttributeError(f"span target {target} does not resolve")
    return owner, attr, inspect.getattr_static(owner, attr)


class Spans:
    """Self time and calls per wrapped callable, while ``active``."""

    def __init__(self, targets, annotate: bool):
        self.targets = sorted(set(targets))
        self.annotate = annotate
        self.active = False
        self.self_s = defaultdict(float)
        self.calls = defaultdict(int)
        self._stack: list = []
        self._saved: list = []

    def install(self) -> None:
        for t in self.targets:
            owner, attr, raw = resolve(t)
            self._saved.append((owner, attr, raw))
            static = isinstance(raw, staticmethod)
            wrapped = self._wrap(t, raw.__func__ if static else raw)
            setattr(owner, attr, staticmethod(wrapped) if static else wrapped)

    def uninstall(self) -> None:
        for owner, attr, raw in reversed(self._saved):
            setattr(owner, attr, raw)
        self._saved.clear()

    def _wrap(self, name: str, fn):
        from torch.profiler import record_function

        spans = self

        @functools.wraps(fn)
        def span(*args, **kw):
            if not spans.active:
                return fn(*args, **kw)
            frame = [time.perf_counter(), 0.0]
            spans._stack.append(frame)
            ctx = (record_function("span:" + name) if spans.annotate
                   else nullcontext())
            try:
                with ctx:
                    return fn(*args, **kw)
            finally:
                dur = time.perf_counter() - frame[0]
                spans._stack.pop()
                if spans._stack:
                    spans._stack[-1][1] += dur
                spans.self_s[name] += dur - frame[1]
                spans.calls[name] += 1

        return span


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------

def _union(intervals):
    """Merged (start, end) pairs of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(merged) -> int:
    return sum(b - a for a, b in merged)


def reduce_trace(prof) -> dict | None:
    """The traced window's device numbers (seconds), or None when the
    trace holds no device operation: the window, the union of kernel and
    copy intervals (busy), kernels' summed time, the union of copies, time
    by operation name, and idle time by the innermost span open on the
    host (``breakdown``)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    spans, kernels, copies, ops = [], [], [], defaultdict(int)
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        name = e.name()
        if e.device_type() == DeviceType.CPU or e.is_user_annotation() or (
                name.startswith(("span:", "benchmark."))):
            if e.device_type() != DeviceType.CPU:
                continue  # the annotations' copies on the device's rows
            if name == WINDOW:
                window = (a, b)
            elif name.startswith("span:") or name == REQUEST:
                spans.append((a, b, name))
            continue
        if b <= a:
            continue
        ops[name] += b - a
        (copies if name.startswith("Memcpy") else kernels).append((a, b))
    if window is None or not (kernels or copies):
        return None
    w0, w1 = window
    clip = [(max(a, w0), min(b, w1)) for a, b in kernels + copies
            if b > w0 and a < w1]
    busy = _union(clip)
    copy_u = _union([(max(a, w0), min(b, w1)) for a, b in copies
                     if b > w0 and a < w1])
    kernel_ns = sum(min(b, w1) - max(a, w0) for a, b in kernels
                    if b > w0 and a < w1)
    # Idle time by the innermost span open on the host at each instant:
    # one sweep over span starts and ends (they nest) and the edges of the
    # device's idle gaps.
    idle = defaultdict(int)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    marks = [(s0, 1, n) for s0, _, n in spans]
    marks += [(s1, 0, n) for _, s1, n in spans]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            marks += [(a, 2, None), (b, 3, None)]
    stack: list = []
    in_gap, last = False, w0
    for t, kind, name in sorted(marks, key=lambda m: (m[0], m[1])):
        if in_gap and t > last:
            top = stack[-1] if stack else "outside requests"
            idle[top.removeprefix("span:")] += t - last
        last = t
        if kind == 1:
            stack.append(name)
        elif kind == 0:
            if name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        else:
            in_gap = kind == 2
    top = lambda d: [[k, v * 1e-9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": _length(busy) * 1e-9,
            "kernel_s": kernel_ns * 1e-9, "copy_s": _length(copy_u) * 1e-9,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}
