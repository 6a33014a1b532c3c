"""The stereo FLAC music cell (``musdb_flac.tracks8``): its generator
deterministic per seed, byte-equal to the port's FLAC test encoder in
every channel assignment and with the source's MD5; its reference's
``judge`` exact, its control and the broken paths (mid/side without the
side's low bit, 24-bit streams hashed at 2 bytes, a track left out) read
false; the cell resolved and run ``correct`` at a small size on the CPU,
traced and untraced; and its new readers (``verify_share``,
``f1_roofline``, ``f2_roofline``) on synthetic windows. The test shrinks
its own copy of the configuration."""

import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.gen import flac_music as gen
from benchmark.reference import flac_music as ref
from benchmark.work import flac_music as work
from conftest import ROOT, SPEC

CFG = json.loads((ROOT / "benchmark/configs/musdb_flac.json").read_text())
SMALL = dict(CFG, duration_s=dict(CFG["duration_s"], min=0.2, max=0.4),
             hires_ranks=[1])
CELL = "musdb_flac.tracks8"
NEW = ("verify_share", "f1_roofline", "f2_roofline")
OLD = ("facade_share", "extract_share", "pack_share", "copy_wait_share",
       "enqueue_share", "stitch_share", "h2d_bytes_per_audio_s",
       "d2h_bytes_per_audio_s", "device_idle_pct", "md5_card_pct",
       "launches_per_stream")


def test_entries_declared():
    c = harness.cell(SPEC, CELL, ROOT)
    assert c["workload"]["chips"] == 1
    assert c["traffic"] == dict(c["traffic"], pool=8, batch=8,
                                compare_every=8)
    assert [m["name"] for m in c["end_to_end"]] == ["realtime_x", "setup_s"]
    assert {m["name"] for m in c["per_layer"]} == {
        f"{n}.musdb_flac" for n in OLD + NEW}
    for m in c["per_layer"]:
        assert m["moves"] == "realtime_x" and m["workloads"] == [CELL]
    for n in NEW:
        assert harness.reader(f"{n}.musdb_flac", ROOT).WRAPS == []


def test_deterministic_by_seed_with_the_durations_set():
    a = gen.make_pool(SMALL, 3, 2**31 + 21)
    b = gen.make_pool(SMALL, 3, 2**31 + 21)
    c = gen.make_pool(SMALL, 3, 2**31 + 22)
    assert [s.data for s in a] == [s.data for s in b]
    assert [s.data for s in a] != [s.data for s in c]
    # The same durations and depths for every seed, in another order.
    assert sorted((s.pcm.shape[1], s.bits) for s in a) == sorted(
        (s.pcm.shape[1], s.bits) for s in c)
    assert all(s.pcm.dtype == np.int32 and s.pcm.shape[0] == 2 for s in a)


def test_the_cells_pool_shape():
    """The configuration's eight durations and depths (no encoding)."""
    from benchmark.gen import flac as mono

    secs = mono.durations(CFG, 8)
    np.testing.assert_allclose(secs, [199.8, 216.8, 230.3, 243.0, 256.0,
                                      270.0, 286.7, 311.5], atol=0.05)
    n = [mono.n_samples(CFG, s) for s in secs]
    assert sum(-(-k // 4096) for k in n) == 21687
    assert gen.depths(CFG, 8).tolist() == [16, 16, 16, 24, 16, 16, 24, 16]


@pytest.mark.parametrize("bps", [16, 24])
def test_streaminfo_md5_is_hashlibs(bps):
    (s,) = gen.make_pool(dict(SMALL, hires_ranks=[0] if bps == 24 else []),
                         1, 5)
    assert s.bits == bps
    inter = s.pcm.T.reshape(-1).astype("<i4").view(np.uint8).reshape(-1, 4)
    want = hashlib.md5(inter[:, : bps // 8].tobytes()).digest()
    assert s.data[8 + 18 : 8 + 34] == want


@pytest.mark.parametrize("assign", range(4))
@pytest.mark.parametrize("po", [0, 3])
def test_frames_equal_the_test_encoder(assign, po):
    """For the same samples, assignment, predictor (one for both
    subframes, as the builder takes it) and partition order, the
    generator writes the builder's frames."""
    from symphonia_tpu_torch.testing import flac_builder as fb

    rng = np.random.default_rng(assign * 10 + po)
    n = 2 * 4096 + 777
    lr = np.cumsum(rng.integers(-300, 301, size=(2, n)), 1)
    lr = np.clip(lr // 4, -30000, 30000).astype(np.int64)
    q, sh, prec = np.array([3, -3, 1, 0, 0, 0, 0, 0]), 0, 12
    B = 4096
    F = -(-n // B)
    X = np.zeros((F, 2, B), np.int64)
    for f in range(F):
        b = min(B, n - f * B)
        X[f, :, :b] = lr[:, f * B : f * B + b]
    x4 = gen.candidates(torch.from_numpy(X))
    pair = torch.as_tensor(gen.PAIRS)[assign]
    blocks = torch.tensor([min(B, n - f * B) for f in range(F)])
    out, flen = gen.encode_frames(
        x4[:, pair], blocks, torch.full((F,), assign),
        torch.from_numpy(np.tile(q, (F, 2, 1))),
        torch.full((F, 2), sh), prec, 16, range(F),
        force_po=np.full((F, 2), po))
    out = gen.seal(out, flen)
    modes = ("independent", "left_side", "right_side", "mid_side")
    want = b"".join(fb.encode_frame(
        [lr[0, f * B : f * B + B], lr[1, f * B : f * B + B]], f, 16,
        modes[assign], kind="lpc", lpc_coefs=list(q), lpc_shift=sh,
        lpc_precision=prec, partition_order=po) for f in range(F))
    assert out.tobytes() == want


def test_judge_reads_the_port_exact():
    from symphonia_tpu_torch import batch

    pool = gen.make_pool(SMALL, 3, 7)
    outs = batch.decode_many([s.data for s in pool], device="cpu",
                             verify=True)
    got = ref.judge(pool, [([2, 0, 1], [outs[2], outs[0], outs[1]])], "cpu")
    assert got == {"streams_wrong_shape": 0, "mismatched_samples": 0,
                   "md5_not_verified": 0, "streams_compared": 3}
    short = ref.Decoded(outs[0].samples[:, :-1], 44100, True)
    assert ref.judge(pool, [([0], [short])], "cpu")[
        "streams_wrong_shape"] == 1


def test_control_reads_false():
    pool = gen.make_pool(SMALL, 2, 9)
    got = ref.judge(pool, [([0, 1], ref.control(pool))], "cpu")
    assert got["mismatched_samples"] > 0 and got["md5_not_verified"] == 2
    assert any(got[k] > v for k, v in CFG["checks"].items())


@pytest.fixture
def music_root(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the cell small enough
    for the CPU: tracks of 0.2-0.4 s (one at 24 bits), a pool of 3, every
    request's outputs checked."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".tree",
                                                  "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = tmp_path / "benchmark/configs/musdb_flac.json"
    p.write_text(json.dumps(SMALL))
    p = tmp_path / "benchmark/traffic/tracks8.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), pool=3,
                                 batch=3, compare_every=1)))
    return tmp_path


def run(root, trace=False, decode=None, seconds=0.8):
    return harness.run(CELL, 2**31 + 77, seconds, trace, time.perf_counter(),
                       device="cpu", root=root, decode=decode)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_end_to_end(music_root, trace):
    r = run(music_root, trace)
    assert r["correct"] is True and r["failed"] == 0
    m = r["metrics"]
    if not trace:
        assert set(m) == {"realtime_x", "setup_s"}
        return
    # No device trace on the CPU: the rooflines and the idle share are
    # silent; every span and counter reader reads.
    assert set(m) == {f"{n}.musdb_flac" for n in OLD + ("verify_share",)
                      if n != "device_idle_pct"}
    assert m["md5_card_pct.musdb_flac"]["value"] == 0.0
    # Every frame's two rows of 4,112 int32 samples come down.
    pool = gen.make_pool(SMALL, 3, 2**31 + 77)
    frames = sum(len(s.blocks) for s in pool)
    seconds = sum(s.seconds for s in pool)
    assert m["d2h_bytes_per_audio_s.musdb_flac"]["value"] == pytest.approx(
        2 * 4112 * 4 * frames / seconds)


def test_broken_paths_read_false(music_root, monkeypatch):
    from symphonia_tpu_torch import batch
    from symphonia_tpu_torch.codecs import flac as codec
    from symphonia_tpu_torch.ops import flac_dense as fd

    real = batch.decode_many
    # A track left out of each request.
    r = run(music_root, decode=lambda datas, **kw: real(datas[:-1], **kw))
    assert r["correct"] is False
    assert r["checks"]["streams_missing"]["value"] > 0
    # 24-bit streams hashed at 2 bytes a sample.
    md5_bytes_of = codec.md5_bytes_of
    monkeypatch.setattr(codec, "md5_bytes_of",
                        lambda s, bps: md5_bytes_of(s, min(bps, 16)))
    r = run(music_root)
    assert r["correct"] is False
    assert r["checks"]["md5_not_verified"]["value"] > 0
    monkeypatch.setattr(codec, "md5_bytes_of", md5_bytes_of)
    # Mid/side without the side's low bit (F2's twin stands in for F2).
    plain = fd.decorrelate_plain

    def slipped(x, assignment):
        out = plain(x, assignment)
        ms = assignment == fd.ASSIGN_MID_SIDE
        c0, c1 = x[:, 0].to(torch.int64), x[:, 1].to(torch.int64)
        out[ms, 0] = (((c0 << 1) + c1) >> 1)[ms].to(torch.int32)
        out[ms, 1] = (((c0 << 1) - c1) >> 1)[ms].to(torch.int32)
        return out

    monkeypatch.setattr(fd, "decorrelate_plain", slipped)
    r = run(music_root)
    assert r["correct"] is False
    assert r["checks"]["mismatched_samples"]["value"] > 0


class Req:
    root = type("S", (), {"name": "decode_many"})()
    calls = {"decode_many": 1, "verify": 1}

    def __init__(self, verify_ns=0, **counters):
        self.counters = counters
        self.self_ns = {"decode_many": 5, "verify": verify_ns}


@pytest.fixture
def window(monkeypatch):
    """The traced window's requests set to the ones given, and a trace
    with F1's, its helper's, F2's and F3's rows."""
    import symphonia_tpu_torch.trace as tr

    def use(*reqs, ops=None):
        monkeypatch.setattr(tr, "requests", lambda last=None: list(reqs))
        ctx = harness.Context(setup_s=1.0, window_s=2.0, requests=len(reqs))
        ctx.trace = {"breakdown": {"device_ops": ops or [
            ["(anonymous namespace)::flac_lpc_kernel(int const*, long)",
             0.004],
            ["(anonymous namespace)::flac_lane_taps_kernel(int const*)",
             1.0],
            ["(anonymous namespace)::flac_decorrelate_kernel(int const*)",
             0.002],
            ["(anonymous namespace)::flac_md5_kernel(int const*)", 1.0]]}}
        return ctx
    return use


def test_f1_and_f2_rooflines_at_known_least_times(window):
    f1 = harness.reader("f1_roofline.musdb_flac", ROOT)
    f2 = harness.reader("f2_roofline.musdb_flac", ROOT)
    # F1: 3.35e9 bytes (1 ms at 3.35 TB/s) over 4 ms of its rows; F2:
    # 3.35e9 bytes over 2 ms. Two requests share the counts.
    lanes, frames = 1000, 500
    s1 = (3_350_000_000 - 140 * lanes) // 8
    s2 = (3_350_000_000 - 4 * frames) // 16
    a = Req(flac_lanes=lanes // 2, flac_lane_samples=s1 // 2,
            flac_stereo_frames=frames // 2, flac_stereo_samples=s2 // 2)
    b = Req(flac_lanes=lanes // 2, flac_lane_samples=s1 - s1 // 2,
            flac_stereo_frames=frames // 2, flac_stereo_samples=s2 - s2 // 2)
    assert work.lpc_bytes(lanes, s1) == pytest.approx(3.35e9, abs=8)
    assert f1.read(window(a, b)) == pytest.approx(25.0)
    assert f2.read(window(a, b)) == pytest.approx(50.0)


def test_readers_read_nothing_without_what_they_read(window):
    """A parent's port (no FLAC counters), a mono window (no F2), a trace
    without the kernel's rows, an untraced run: None, never a raise."""
    f1 = harness.reader("f1_roofline.musdb_flac", ROOT)
    f2 = harness.reader("f2_roofline.musdb_flac", ROOT)
    vs = harness.reader("verify_share.musdb_flac", ROOT)
    parent = Req(h2d_bytes=10, d2h_bytes=10)
    assert f1.read(window(parent)) is None and f2.read(window(parent)) is None
    mono = Req(flac_lanes=10, flac_lane_samples=41120)
    assert f1.read(window(mono)) is not None and f2.read(window(mono)) is None
    stereo = Req(flac_lanes=10, flac_lane_samples=41120,
                 flac_stereo_frames=5, flac_stereo_samples=20560)
    ctx = window(stereo, ops=[["x::flac_md5_kernel(", 1.0]])
    assert f1.read(ctx) is None and f2.read(ctx) is None
    ctx.trace = None
    assert f1.read(ctx) is None and f2.read(ctx) is None
    ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=0)
    assert vs.read(ctx) is None and f1.read(ctx) is None


def test_verify_share(window):
    vs = harness.reader("verify_share.musdb_flac", ROOT)
    ctx = window(Req(verify_ns=300_000_000), Req(verify_ns=200_000_000))
    assert vs.read(ctx) == pytest.approx(25.0)
