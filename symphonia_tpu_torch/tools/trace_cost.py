"""What a span of :mod:`symphonia_tpu_torch.trace` costs the host.

Off: ``n_off`` spans opened and closed with no profiler (one flag read and
the shared no-op context each). On: ``n_on`` spans under
``torch.profiler.profile`` (CPU activity, and CUDA where a card is
present), each a stored span and a ``record_function`` range, timed inside
the profiled block. Prints and returns ns per span, best of three.

Usage: python -m symphonia_tpu_torch.tools.trace_cost [n_off n_on]
"""

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import trace


def _loop(n: int) -> float:
    """ns per span over ``n`` closed spans."""
    span = trace.span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("decode_many"):
            pass
    return (time.perf_counter_ns() - t0) / n


def main(n_off: int = 10**6, n_on: int = 10**4) -> dict:
    if trace.enabled():
        raise RuntimeError("a profiler is already recording")
    off = min(_loop(n_off) for _ in range(3))
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    on = []
    for _ in range(3):
        with profile(activities=acts):
            on.append(_loop(n_on))
        trace.reset()
    out = {"off_ns_per_span": off, "on_ns_per_span": min(on),
           "n_off": n_off, "n_on": n_on,
           "profiler": [str(a).split(".")[-1] for a in acts]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
