"""The reader of M3's counter (``place_card_pct``): declared for the MP3
cell, nothing read where the port counted no placement (an untraced
window, or a port without M3), the card's share of the Layer III clips
where it did, and a traced CPU run of the cell at a small size."""

import time

import numpy as np
import pytest

from benchmark import harness
from conftest import ROOT, SPEC

NAME = "place_card_pct.fma_mp3"


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


def test_entry_declared():
    m = {e["name"]: e for e in SPEC["per_layer"]}[NAME]
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["better"] == "higher"
    assert m["layer"] == "stitch / verify" and m["moves"] == "realtime_x"
    assert m["workloads"] == ["fma_mp3.shard32"]
    assert harness.reader(NAME, ROOT).WRAPS == []


@pytest.mark.parametrize("reqs,want", [
    ([dict(mp3_card_streams=32, mp3_placed_streams=32)], 100.0),
    ([dict(mp3_card_streams=3, mp3_host_streams=1, mp3_placed_streams=3)],
     75.0),
    ([dict(mp3_host_streams=2, mp3_placed_streams=0)], 0.0),
    ([dict(mp3_card_streams=4, mp3_placed_streams=4),
      dict(mp3_host_streams=4)], 50.0),
    # The parent's counters: M0's, no placement counted.
    ([dict(mp3_card_streams=32, mp3_frames=36800)], None),
    ([dict(mp3_placed_streams=0)], None)])
def test_reads_the_cards_share(window, reqs, want):
    reader = harness.reader(NAME, ROOT)
    assert reader.read(window(*(Req(**c) for c in reqs))) == want


def test_nothing_counted_reads_none():
    reader = harness.reader(NAME, ROOT)
    ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=0)
    ctx.trace = None
    assert reader.read(ctx) is None


def test_traced_cell_reports_it(small_root):
    r = harness.run("fma_mp3.shard32", 2**31 + 13, 0.6, True,
                    time.perf_counter(), device="cpu", root=small_root)
    assert r["correct"], r["checks"]
    v = r["metrics"][NAME]["value"]
    assert np.isfinite(v) and v == 100.0
