"""The work of the dense kernels, from the shapes the generator knows.

Frozen copies of ``chip_smoke.py``'s ``work_*`` functions and ``bound``
(bytes each input read once and each output written once, fp32
multiply-adds), fed from the lane counts of the streams a request
decoded. The least time of a request's kernel work is the sum over its
kernels of the larger of bytes / HBM rate and operations / fp32 rate at
the published peaks (``peaks.json``), so the roofline share reads the same
work whatever kernels a later change runs.
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(nbytes: float, macs: float) -> float:
    """Least seconds for ``nbytes`` of traffic and ``macs`` fp32
    multiply-adds (two operations each) at the published peaks."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               2.0 * macs / PEAKS["fp32_flop_per_s"])


def bytes_bound_s(nbytes: float) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]
