"""The readers of the port's own spans and copy counters
(``symphonia_tpu_torch/trace.py``) in traced CPU runs of the FLAC cells at
a small size: every entry reported, each window read alone, and the
layers' shares covering the window."""

import gc
import math
import time

import pytest

from benchmark import harness
from conftest import SPEC

FLAC = [w["name"] for w in SPEC["workloads"]
        if w["config"] == "librispeech_flac"]
NEW = ("facade_share", "pack_share", "copy_wait_share", "enqueue_share",
       "stitch_share", "h2d_bytes_per_audio_s", "d2h_bytes_per_audio_s")
SHARES = NEW[:5] + ("host_extract_share", "md5_share")


def traced(root, w, seed=2**31 + 7, seconds=0.8):
    # A full collection of the test process's heap can take 0.1-0.7 s, as
    # long as a request of these windows; it is kept out of them.
    gc.collect()
    gc.disable()
    try:
        r = harness.run(w, seed, seconds, True, time.perf_counter(),
                        device="cpu", root=root)
    finally:
        gc.enable()
    assert r["correct"], r["checks"]
    return {k.split(".")[0]: v["value"] for k, v in r["metrics"].items()}


def test_every_new_entry_is_declared():
    names = {m["name"] for m in SPEC["per_layer"]}
    for base in NEW:
        for cell in ("bulk", "online"):
            assert f"{base}.{cell}" in names


@pytest.mark.parametrize("w", FLAC)
def test_new_entries_reported(small_root, w):
    m = traced(small_root, w)
    for base in NEW:
        assert base in m and math.isfinite(m[base]), base
    for base in NEW[:5]:
        assert 0.0 <= m[base] <= 100.0, (base, m[base])
    assert m["h2d_bytes_per_audio_s"] > 0 and m["d2h_bytes_per_audio_s"] > 0


def test_each_window_read_alone(small_root):
    # Every bulk request decodes the whole pool, so bytes per second of
    # audio are the same in any window: a reader that summed both windows'
    # counters would read the second higher.
    first = traced(small_root, "librispeech_flac.bulk", seconds=0.6)
    second = traced(small_root, "librispeech_flac.bulk", seconds=1.2)
    for base in ("h2d_bytes_per_audio_s", "d2h_bytes_per_audio_s"):
        assert second[base] == pytest.approx(first[base], rel=1e-12)


@pytest.mark.parametrize("w", FLAC)
def test_layers_cover_the_window(small_root, w):
    m = traced(small_root, w)
    total = sum(m[k] for k in SHARES)
    assert 90.0 <= total <= 102.0, {k: m[k] for k in SHARES}
