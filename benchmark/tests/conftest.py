"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest benchmark/tests -q``. Tests marked ``card`` need a CUDA
card and skip without one (decided inside the test, never at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def with_aac(spec: dict) -> dict:
    """``spec`` with the AAC cells added back as data alone, the way a
    later change would restore them (``aac_cells.json``: their
    configuration and workload entries). Each metric reported by the FLAC
    cell of the same traffic is reported by the AAC cell too, but for
    ``md5_share``, which is FLAC's alone. The harness runs them as it runs
    any cell; ``BENCHMARK.json`` leaves them out (PERF.md)."""
    spec = json.loads(json.dumps(spec))
    aac = json.loads((Path(__file__).parent / "aac_cells.json").read_text())
    spec["configs"] += aac["configs"]
    spec["workloads"] += aac["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and not m["name"].startswith("md5_share"):
            m["workloads"] += [
                w["name"] for w in aac["workloads"]
                if f"librispeech_flac.{w['traffic']}" in m["workloads"]]
    return spec


SPEC = with_aac(json.loads((ROOT / "BENCHMARK.json").read_text()))


def shrink(root: Path) -> None:
    """Cells small enough for the CPU: short utterances and clips, pools
    of four, and every request's outputs checked (a window of a few
    requests holds too few for a stride of them)."""
    b = root / "benchmark"
    p = b / "configs" / "librispeech_flac.json"
    f = json.loads(p.read_text())
    f["duration_s"].update(min=1.0, max=2.5)
    p.write_text(json.dumps(f))
    p = b / "configs" / "audioset_aac.json"
    a = json.loads(p.read_text())
    a["seconds"] = 0.5
    p.write_text(json.dumps(a))
    for t in (b / "traffic").glob("*.json"):
        d = json.loads(t.read_text())
        d["pool"] = 4
        d["batch"] = min(d["batch"], 4)
        d["compare_every"] = 1
        t.write_text(json.dumps(d))


@pytest.fixture
def small_root(tmp_path):
    """A copy of BENCHMARK.json, with the AAC cells added back, and of
    benchmark/, with every cell shrunk."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".tree",
                                                  "__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    shrink(tmp_path)
    return tmp_path
