"""A run end to end on the CPU at a small size (the harness's look for a
card skipped): the last line's shape, the refusal without a card, and
``correct`` false under each fault a decode cell can have."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness
from conftest import ROOT, SPEC

CELLS = [w["name"] for w in SPEC["workloads"]]


def run(root, w, trace=False, decode=None, seconds=0.6):
    return harness.run(w, 2**31 + 99, seconds, trace, time.perf_counter(),
                       device="cpu", root=root, decode=decode)


@pytest.mark.parametrize("w", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_shape(small_root, w, trace):
    r = run(small_root, w, trace)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    c = harness.cell(spec, w, small_root)
    names = {m["name"] for m in (c["per_layer"] if trace else
                                 c["end_to_end"])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_refuses_without_a_card():
    p = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"),
                        "--workload", "librispeech_flac.bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(ROOT))
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_refuses_without_the_port(tmp_path):
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "librispeech_flac.bulk", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


# The faults: each breaks the timed path underneath and must read false.

def _half_left_out(real):
    def decode(datas, **kw):
        return real(datas[: max(1, len(datas) // 2)], **kw)
    return decode


def _answer_altered(real):
    def decode(datas, **kw):
        outs = real(datas, **kw)
        s = outs[-1].samples
        s.flat[len(s.flat) // 2] += 1 if s.dtype.kind == "i" else 1e-3
        return outs
    return decode


def _unchanged_state(real):
    """Each output is the first request's again (a decoder that keeps
    returning what it had)."""
    first = {}

    def decode(datas, **kw):
        outs = real(datas, **kw)
        if not first:
            first["outs"] = outs
        return [first["outs"][0]] * len(outs)
    return decode


FAULTS = [(w, f) for w in CELLS for f in (_answer_altered, _unchanged_state)]
# Half of the batch left out: a fault of the bulk cells only (one stream
# a request online).
FAULTS += [(w, _half_left_out) for w in CELLS if w.endswith(".bulk")]


@pytest.mark.parametrize("w,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_faults_read_incorrect(small_root, w, fault):
    from symphonia_tpu_torch import batch

    r = run(small_root, w, decode=fault(batch.decode_many), seconds=0.4)
    assert r["correct"] is False


def test_a_fixed_stride_is_kept(small_root, monkeypatch):
    """With a stride above one, the outputs of request 0 and of every
    stride-th request after it reach the check, whatever the seed."""
    import json as js

    for t in (small_root / "benchmark/traffic").glob("*.json"):
        d = js.loads(t.read_text())
        d["compare_every"] = 2
        t.write_text(js.dumps(d))
    from benchmark.reference import flac

    seen = []
    real = flac.judge
    monkeypatch.setattr(flac, "judge", lambda pool, reqs, dev: (
        seen.append(len(reqs)), real(pool, reqs, dev))[1])
    r = run(small_root, "librispeech_flac.bulk", seconds=1.5)
    assert r["correct"] and seen[0] == (r["attempted"] + 1) // 2
