"""The reader of the compiled MPEG walk's counters (``scan_native_pct``):
declared for both MP3 cells, nothing read where the port counted no
reader (an untraced window, or a port without the compiled walk), the
compiled walk's share of the readers where it did, and traced CPU runs
of both cells at a small size."""

import time

import numpy as np
import pytest

from benchmark import harness
from conftest import ROOT, SPEC

NAMES = {"scan_native_pct.fma_mp3": ("realtime_x", "fma_mp3.shard32"),
         "scan_native_pct.commonvoice_mp3": ("request_p95_ms",
                                             "commonvoice_mp3.online")}


class Req:
    root = type("S", (), {"name": "decode_many"})()
    calls, self_ns = {"decode_many": 1}, {"decode_many": 5}

    def __init__(self, **counters):
        self.counters = counters


@pytest.fixture
def window(monkeypatch):
    """Sets the traced window's requests to the ones given."""
    import symphonia_tpu_torch.trace as tr

    def use(*reqs):
        monkeypatch.setattr(tr, "requests", lambda last=None: list(reqs))
        return harness.Context(setup_s=1.0, window_s=1.0, requests=len(reqs))
    return use


@pytest.mark.parametrize("name", sorted(NAMES))
def test_entry_declared(name):
    m = {e["name"]: e for e in SPEC["per_layer"]}[name]
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["better"] == "higher" and m["layer"] == "demux"
    assert (m["moves"], m["workloads"]) == (NAMES[name][0], [NAMES[name][1]])
    assert harness.reader(name, ROOT).WRAPS == []


@pytest.mark.parametrize("reqs,want", [
    ([dict(mpa_walk_native_streams=32)], 100.0),
    ([dict(mpa_walk_native_streams=3, mpa_walk_host_streams=1)], 75.0),
    ([dict(mpa_walk_host_streams=2)], 0.0),
    ([dict(mpa_walk_native_streams=4), dict(mpa_walk_host_streams=4)], 50.0),
    # The parent's counters: M0's and M3's, no reader counted.
    ([dict(mp3_card_streams=32, mp3_placed_streams=32)], None),
    ([dict(mpa_walk_native_streams=0)], None)])
def test_reads_the_compiled_share(window, reqs, want):
    reader = harness.reader("scan_native_pct.fma_mp3", ROOT)
    assert reader.read(window(*(Req(**c) for c in reqs))) == want


def test_nothing_counted_reads_none():
    reader = harness.reader("scan_native_pct.fma_mp3", ROOT)
    ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=0)
    ctx.trace = None
    assert reader.read(ctx) is None


@pytest.mark.parametrize("name", sorted(NAMES))
def test_traced_cell_reports_it(small_root, name):
    r = harness.run(NAMES[name][1], 2**31 + 17, 0.6, True,
                    time.perf_counter(), device="cpu", root=small_root)
    assert r["correct"], r["checks"]
    v = r["metrics"][name]["value"]
    assert np.isfinite(v) and v == 100.0
