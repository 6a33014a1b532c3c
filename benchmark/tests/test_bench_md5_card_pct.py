"""The reader of the port's MD5 placement counters (``md5_card_pct``):
declared for both FLAC cells, nothing read where the port counted nothing
(an untraced window, or a port without the counters), the card's share of
the verified streams where it did, and a traced CPU run of each FLAC cell
at a small size."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness
from conftest import ROOT, SPEC


def test_both_entries_declared():
    m = {e["name"]: e for e in SPEC["per_layer"]}
    for cell, moves in (("bulk", "realtime_x"),
                        ("online", "request_p95_ms")):
        e = m[f"md5_card_pct.{cell}"]
        assert e["source"] == "program_counter" and e["unit"] == "%"
        assert e["layer"] == "stitch / verify" and e["moves"] == moves
        assert f"librispeech_flac.{cell}" in e["workloads"]


def _streams(n, seed=2**31 + 5):
    """n short LibriSpeech-shaped streams from the benchmark's generator."""
    from benchmark.gen import flac

    cfg = json.loads((ROOT / "benchmark/configs/librispeech_flac.json")
                     .read_text())
    cfg["duration_s"].update(min=0.1, max=0.3)
    return [s.data for s in flac.make_pool(cfg, n, seed)]


def _window(calls):
    """The reader's value over traced ``decode_many`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from symphonia_tpu_torch import batch, trace

    reader = harness.reader("md5_card_pct.bulk", ROOT)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for datas, verify in calls:
            batch.decode_many(datas, device="cpu", verify=verify)
    try:
        return reader.read(SimpleNamespace(requests=len(calls)))
    finally:
        trace.reset()


def test_nothing_counted_reads_none():
    reader = harness.reader("md5_card_pct.online", ROOT)
    assert reader.WRAPS == []
    assert reader.read(SimpleNamespace(requests=0)) is None
    assert _window([(_streams(3), False)]) is None


def test_reads_the_cards_share():
    many = _streams(24)
    assert _window([(many, True)]) == 100.0
    assert _window([(many[:1], True)]) == 0.0
    assert _window([(many, True), (many[:1], True)]) == pytest.approx(
        100.0 * 24 / 25)


@pytest.mark.parametrize("w", ["librispeech_flac.bulk",
                               "librispeech_flac.online"])
def test_traced_cells_report_it(small_root, w):
    r = harness.run(w, 2**31 + 11, 0.6, True, time.perf_counter(),
                    device="cpu", root=small_root)
    assert r["correct"], r["checks"]
    v = r["metrics"][f"md5_card_pct.{w.split('.')[1]}"]["value"]
    assert np.isfinite(v) and 0.0 <= v <= 100.0
    if w.endswith("online"):
        assert v == 0.0  # one stream a request: the host's
