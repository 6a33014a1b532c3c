"""Every part of a cell is a file found by its name, and a later change
adds a cell, a traffic mix or a metric by adding files alone."""

import json
import shutil

import pytest

from benchmark import harness
from conftest import ROOT, SPEC


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_every_workload_resolves(w):
    files = harness.paths(SPEC, w, ROOT)
    assert {"config", "traffic", "gen", "reference", "work"} <= set(files)
    assert all(p.is_file() for p in files.values())
    c = harness.cell(SPEC, w, ROOT)
    assert {m["name"] for m in c["end_to_end"]} & {"realtime_x",
                                                    "request_p95_ms"}
    assert "setup_s" in {m["name"] for m in c["end_to_end"]}
    assert c["per_layer"]
    for m in c["per_layer"] + c["end_to_end"]:
        r = harness.reader(m["name"], ROOT)
        assert callable(r.read) and isinstance(r.WRAPS, list)


def test_every_span_target_resolves():
    from benchmark.spans import resolve

    for m in SPEC["per_layer"]:
        for t in harness.reader(m["name"], ROOT).WRAPS:
            resolve(t)


def test_a_new_cell_needs_no_edit(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (tmp_path / "benchmark/traffic/burst.json").write_text(json.dumps(
        {"why": "pairs", "pool": 8, "batch": 2, "compare_every": 4}))
    (tmp_path / "benchmark/metrics/gap_ms.py").write_text(
        "WRAPS = []\n\ndef read(ctx):\n    return 1.0\n")
    spec["workloads"].append({"name": "librispeech_flac.burst",
                              "config": "librispeech_flac",
                              "traffic": "burst", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "gap_ms.burst", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "facade / routing",
                              "moves": "request_p95_ms",
                              "workloads": ["librispeech_flac.burst"]})
    spec["end_to_end"][1]["workloads"].append("librispeech_flac.burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    files = harness.paths(spec, "librispeech_flac.burst", tmp_path)
    assert files["traffic"].name == "burst.json"
    assert files["metric:gap_ms.burst"].name == "gap_ms.py"
    c = harness.cell(spec, "librispeech_flac.burst", tmp_path)
    assert c["traffic"]["batch"] == 2
    assert [m["name"] for m in c["per_layer"]] == ["gap_ms.burst"]


def test_a_missing_file_fails_loudly(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tmp_path / "benchmark/traffic/bulk.json").unlink()
    with pytest.raises(harness.RunError):
        harness.paths(SPEC, "librispeech_flac.bulk", tmp_path)


def test_traffic_is_the_same_work_for_every_seed():
    """Every seed sends each stream equally often, in its own order, and
    keeps the outputs of the same requests."""
    from benchmark import traffic

    tr = {"pool": 16, "batch": 3, "compare_every": 5}
    orders = []
    for seed in (1, 2**31 + 3):
        it = traffic.requests(tr, seed)
        reqs = [next(it) for _ in range(64)]
        assert all(len(r) == 3 for r in reqs)
        assert sorted(i for r in reqs[:16] for i in r) == sorted(
            list(range(16)) * 3)
        orders.append(reqs)
    assert orders[0] != orders[1]
    assert [n for n in range(64) if traffic.kept(tr, n)] == list(
        range(0, 64, 5))
