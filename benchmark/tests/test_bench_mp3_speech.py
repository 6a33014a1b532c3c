"""The MP3 speech cell (``commonvoice_mp3.online``): its generator
byte-equal to the port's LAME-style test encoder at 48 kHz mono 64 kbit/s
and deterministic per seed, its reference equal to the port's plain
reference, the cell resolved and run ``correct`` at a small size on the
CPU, the TF32 control and the broken paths (a clip dropped, the gapless
trim skipped, the 44.1 kHz band tables) read incorrect, the ``tables``
reader silent on a port without the span, and its kernel work
chip_smoke.py's at one channel."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.gen import mp3_speech as gen
from benchmark.reference import mp3_speech as ref
from conftest import ROOT, SPEC

CFG = json.loads((ROOT / "benchmark/configs/commonvoice_mp3.json").read_text())
SMALL = dict(CFG, duration_s=dict(CFG["duration_s"], min=1.0, max=2.0))
CELL = "commonvoice_mp3.online"


def builder():
    from symphonia_tpu_torch.testing import mp3_lame_builder as lb

    return lb, lb.Format(48000, 1, 64)


def granules(fields):
    lb, _ = builder()
    return lb.Granules(**{k: np.asarray(v).astype(np.int64)
                          for k, v in fields.items()})


def shrink(root):
    """The cell small enough for the CPU: clips of 1-2 s, a pool of 4,
    every request's outputs checked."""
    p = root / "benchmark/configs/commonvoice_mp3.json"
    p.write_text(json.dumps(SMALL))
    p = root / "benchmark/traffic/online.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), pool=4,
                                 compare_every=1)))


@pytest.fixture
def speech_root(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".tree",
                                                  "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shrink(tmp_path)
    return tmp_path


def test_deterministic_by_seed():
    a = gen.make_pool(SMALL, 2, 2**31 + 5)
    b = gen.make_pool(SMALL, 2, 2**31 + 5)
    c = gen.make_pool(SMALL, 2, 2**31 + 6)
    assert [s.data for s in a] == [s.data for s in b]
    assert [s.data for s in a] != [s.data for s in c]


@pytest.mark.parametrize("cfg,silent_frames", [
    (SMALL, False),
    (dict(SMALL, onset_every=4, scfsi_share=0.6, subblock_share=0.8),
     False),
    (dict(SMALL, spectrum=dict(SMALL["spectrum"], laplace_scale=[
        2 * v for v in SMALL["spectrum"]["laplace_scale"]])), True)],
    ids=["config", "features", "silent_frames"])
def test_streams_equal_the_test_encoder(cfg, silent_frames):
    """For the same draws (clips of three lengths, padded to the longest)
    the generator writes the test encoder's bytes, silent frames
    included."""
    lb, fmt = builder()
    rng = np.random.default_rng(3)
    tg = torch.Generator().manual_seed(4)
    ns = [48000, 61000, 75000]
    draws = gen.draw(cfg, rng, tg, ns, "cpu")
    datas, written, silent = gen.encode_streams(dict(draws), ns)
    for s, n in enumerate(ns):
        F = lb.n_frames(n)
        g = granules({k: v[s, : F if k in ("scfsi", "ms") else 2 * F].numpy()
                      for k, v in draws.items()})
        b = lb.build_stream(g, n, tags={}, fmt=fmt)
        assert datas[s] == b.data
        assert np.flatnonzero(silent[s, :F]).tolist() == b.silent.tolist()
        np.testing.assert_array_equal(written["quant"][s, : 2 * F].numpy(),
                                      b.granules.quant)
    assert bool(silent.any()) == silent_frames


def test_a_pool_clip_as_the_configuration_draws_it():
    """A pool clip is the encoder's bytes for its granules: mono, 192-byte
    frames, a low-level lead-in and tail, short blocks in the speech, the
    reservoir reaching back over earlier frames."""
    lb, fmt = builder()
    for s in gen.make_pool(SMALL, 2, 2**33 + 1):
        g = granules(s.granules)
        b = lb.build_stream(g, s.n_samples, tags={}, fmt=fmt)
        assert s.data == b.data and s.sample_rate == 48000
        assert not s.data.startswith(b"ID3") and b"Info" in s.data[:64]
        assert g.quant.shape[1] == 1 and np.abs(g.quant[0]).max() <= 1
        assert np.abs(g.quant[-1]).max() <= 1
        assert (g.block_type == gen.SHORT).any()
        assert b.main_data_begin.max() > 171
        assert len(s.data) == 192 * (lb.n_frames(s.n_samples) + 1)


def test_reference_equals_the_ports_plain_reference():
    from symphonia_tpu_torch.testing import mp3_reference as plain

    pool = gen.make_pool(SMALL, 2, 19)
    got = ref.expected(pool, [0, 1], "cpu")
    for i, s in enumerate(pool):
        want = plain.synthesise(granules(s.granules), s.n_samples,
                                s.enc_padding, sample_rate=48000)
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-12)


def test_port_within_the_limit_and_the_control_outside():
    from symphonia_tpu_torch import batch

    pool = gen.make_pool(SMALL, 3, 2**31 + 17)
    reqs = [([i], batch.decode_many([s.data], device="cpu"))
            for i, s in enumerate(pool)]
    got = ref.judge(pool, reqs, "cpu")
    assert got["streams_wrong_shape"] == 0 and got["streams_compared"] == 3
    assert got["max_rel_err"] < CFG["checks"]["max_rel_err"] / 10
    ctl = ref.judge(pool, [([0, 1, 2], ref.control(pool))], "cpu")
    assert ctl["max_rel_err"] > 10 * CFG["checks"]["max_rel_err"]


def run(root, trace=False, decode=None, seconds=0.6):
    return harness.run(CELL, 2**31 + 99, seconds, trace, time.perf_counter(),
                       device="cpu", root=root, decode=decode)


def _clip_dropped(real, clips):
    def decode(datas, **kw):
        return real(datas[:-1], **kw)
    return decode


def _trim_left_out(real, clips):
    """Layer III decoded without the LAME tag's gapless trim."""
    from symphonia_tpu_torch import batch

    def decode(datas, **kw):
        return batch.Mp3BatchDecoder(device=kw["device"],
                                     gapless=False).decode_many(datas)
    return decode


def _band_tables_44k(real, clips):
    """A decoder that requantises and reorders with the 44.1 kHz band
    tables: the synthesis of each clip's own integers with them, at the
    right rate and length (``clips``: the run's pool by its bytes)."""
    from benchmark.reference import mp3 as ref44

    def decode(datas, **kw):
        return [ref.Decoded(ref.expected(
            [clips[d]], [0], "cpu", consts_type=ref44._Consts)[0].numpy(),
            48000) for d in datas]
    return decode


@pytest.mark.parametrize("fault", [_clip_dropped, _trim_left_out,
                                   _band_tables_44k])
def test_broken_paths_read_incorrect(speech_root, fault, monkeypatch):
    from symphonia_tpu_torch import batch

    clips = {}
    real_pool = gen.make_pool

    def make_pool(*a, **kw):
        pool = real_pool(*a, **kw)
        clips.update({s.data: s for s in pool})
        return pool

    monkeypatch.setattr(gen, "make_pool", make_pool)
    r = run(speech_root, decode=fault(batch.decode_many, clips), seconds=0.3)
    assert clips and r["correct"] is False


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_end_to_end(speech_root, trace):
    # A window long enough for the 20 requests the p95 needs.
    r = run(speech_root, trace, seconds=2.0)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    m = r["metrics"]
    if not trace:
        assert {"request_p95_ms", "setup_s"} <= set(m)
        return
    # The CPU has no device trace and no M0: the kernels' roofline, the
    # idle share and the card's share of the entropy stage are left out
    # or read 0; every span and counter reader reads.
    want = {f"{n}.commonvoice_mp3" for n in (
        "request_p50_ms", "facade_share", "scan_share", "extract_share",
        "pack_share", "copy_wait_share", "enqueue_share", "stitch_share",
        "launches_per_stream", "h2d_bytes_per_audio_s",
        "d2h_bytes_per_audio_s", "entropy_card_pct", "place_card_pct",
        "tables_share")}
    assert want <= set(m)
    assert m["tables_share.commonvoice_mp3"]["value"] > 0
    assert m["place_card_pct.commonvoice_mp3"]["value"] == 100
    # PCM down: 4 bytes a sample of one channel at 48 kHz.
    assert m["d2h_bytes_per_audio_s.commonvoice_mp3"]["value"] == \
        pytest.approx(4 * 48000)


def test_entries_declared():
    names = [m["name"] for m in SPEC["per_layer"]
             if CELL in m.get("workloads", [])]
    assert len(names) == 16 and all(n.endswith(".commonvoice_mp3")
                                    for n in names)
    for m in SPEC["per_layer"]:
        if m["name"] in names:
            assert m["moves"] == "request_p95_ms"
            assert m["workloads"] == [CELL]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert CELL in e2e["request_p95_ms"]["workloads"]
    assert CELL not in e2e["realtime_x"]["workloads"]
    w = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "commonvoice_mp3", "online", 1)


def test_tables_share_reads_nothing_without_the_span(monkeypatch):
    """On a port without the ``tables`` span (the parent of this cell) the
    reader returns nothing and does not raise; with it, its self time."""
    import symphonia_tpu_torch.trace as tr

    class Req:
        root = type("S", (), {"name": "decode_many"})()
        calls, counters = {"decode_many": 1}, {}
        self_ns = {"decode_many": 5}

    reader = harness.reader("tables_share.commonvoice_mp3", ROOT)
    assert reader.WRAPS == []
    ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=1)
    monkeypatch.setattr(tr, "requests", lambda last=None: [Req()])
    assert reader.read(ctx) is None
    Req.calls = {"decode_many": 1, "tables": 1}
    Req.self_ns = {"decode_many": 5, "tables": 250_000_000}
    assert reader.read(ctx) == pytest.approx(25.0)


def test_work_equals_chip_smokes_at_one_channel():
    import chip_smoke
    from benchmark.work import bound_s
    from benchmark.work import mp3_speech as work

    class Clip:
        def __init__(self, G):
            self.granules = {"block_type": np.zeros((G, 1))}

    for G in (2, 420, 836):
        want = (bound_s(*chip_smoke.work_mp3_hybrid(G, 1))
                + bound_s(*chip_smoke.work_mp3_synth(G, 1)))
        assert work.least_s([Clip(G)], [0]) == pytest.approx(want, rel=1e-12)
