"""The readers of M0's counters (``entropy_card_pct``, ``m0_roofline``):
declared for the MP3 cell, nothing read where the port counted nothing (an
untraced window, or a port without M0), the card's share of the clips,
and M0's roofline share at a known least time."""

import pytest

from benchmark import harness
from conftest import ROOT, SPEC


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
        ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=len(reqs))
        ctx.trace = {"breakdown": {"device_ops": [
            ["(anonymous namespace)::mp3_entropy_kernel(Ctx, long, float*)",
             0.004], ["x::mp3_hybrid_kernel(", 1.0]]}}
        return ctx
    return use


@pytest.mark.parametrize("name,source,layer", [
    ("entropy_card_pct", "program_counter", "host entropy"),
    ("m0_roofline", "device_trace", "dense kernels")])
def test_entries_declared(name, source, layer):
    m = {e["name"]: e for e in SPEC["per_layer"]}[f"{name}.fma_mp3"]
    assert m["source"] == source and m["unit"] == "%"
    assert m["layer"] == layer and m["moves"] == "realtime_x"
    assert m["workloads"] == ["fma_mp3.shard32"]
    assert harness.reader(f"{name}.fma_mp3", ROOT).WRAPS == []


@pytest.mark.parametrize("counters,want", [
    ({"mp3_card_streams": 32}, 100.0),
    ({"mp3_host_streams": 3}, 0.0),
    ({"mp3_card_streams": 3, "mp3_host_streams": 1}, 75.0),
    ({"mp3_frames": 1150}, None)])
def test_entropy_card_pct(window, counters, want):
    reader = harness.reader("entropy_card_pct.fma_mp3", ROOT)
    assert reader.read(window(Req(**counters), Req())) == want


def test_nothing_counted_reads_none():
    for name in ("entropy_card_pct.fma_mp3", "m0_roofline.fma_mp3"):
        reader = harness.reader(name, ROOT)
        ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=0)
        ctx.trace = None
        assert reader.read(ctx) is None


def test_m0_roofline_at_a_known_least_time(window):
    reader = harness.reader("m0_roofline.fma_mp3", ROOT)
    # 3.35e9 bytes, 1 ms at the published 3.35 TB/s, over 4 ms of M0.
    lanes = 1000
    card = Req(mp3_card_bytes=3_350_000_000 - lanes * (576 * 4 + 8),
               mp3_card_lanes=lanes)
    assert reader.read(window(card)) == pytest.approx(25.0)
    assert reader.read(window(Req(mp3_lanes=4))) is None
    ctx = window(card)
    ctx.trace["breakdown"]["device_ops"] = [["x::mp3_hybrid_kernel(", 1.0]]
    assert reader.read(ctx) is None
    ctx.trace = None
    assert reader.read(ctx) is None
