"""The reader of F3's chain counters (``md5_chain_pct.musdb_flac``):
declared for the music cell alone, the chained bytes over the hashed
bytes of the whole window where the port counted both, and None without
them (a parent's port, every MD5 on the host, an untraced run)."""

import pytest

from benchmark import harness
from conftest import ROOT, SPEC

NAME = "md5_chain_pct.musdb_flac"


class Req:
    root = type("S", (), {"name": "decode_many"})()

    def __init__(self, **counters):
        self.counters = counters
        self.self_ns = {"decode_many": 5}


@pytest.fixture
def window(monkeypatch):
    """A traced window whose requests are the ones given."""
    import symphonia_tpu_torch.trace as tr

    def use(*reqs):
        monkeypatch.setattr(tr, "requests", lambda last=None: list(reqs))
        return harness.Context(setup_s=1.0, window_s=2.0,
                               requests=len(reqs))
    return use


def test_entry_declared():
    (e,) = [e for e in SPEC["per_layer"] if e["name"] == NAME]
    assert e == {"name": NAME, "unit": "%", "better": "lower",
                 "source": "program_counter", "layer": "stitch / verify",
                 "moves": "realtime_x", "workloads": ["musdb_flac.tracks8"]}
    assert harness.reader(NAME, ROOT).WRAPS == []


def test_reads_the_chained_share(window):
    mc = harness.reader(NAME, ROOT)
    ctx = window(Req(md5_card_bytes=300, md5_chain_bytes=50),
                 Req(md5_card_bytes=100, md5_chain_bytes=30))
    assert mc.read(ctx) == pytest.approx(20.0)
    assert mc.read(window(Req(md5_card_bytes=80, md5_chain_bytes=80))) == (
        pytest.approx(100.0))


@pytest.mark.parametrize("counters", [
    dict(h2d_bytes=10),
    dict(md5_card_bytes=0, md5_chain_bytes=0),
    dict(md5_card_bytes=10),
    dict(md5_chain_bytes=10),
], ids=["parent", "zero", "no_chain", "no_card"])
def test_nothing_counted_reads_none(window, counters):
    mc = harness.reader(NAME, ROOT)
    assert mc.read(window(Req(**counters))) is None


def test_untraced_window_reads_none():
    mc = harness.reader(NAME, ROOT)
    ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=0)
    assert mc.read(ctx) is None
