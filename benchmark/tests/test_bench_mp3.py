"""The MP3 cell: its generator byte-equal to the port's LAME-style test
encoder, its reference equal to the port's plain reference and within
the configuration's limit of the port's CPU path, the control and broken
paths read incorrect, the harness runs the cell end to end on the CPU,
and its kernel work is chip_smoke.py's."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.gen import mp3 as gen
from benchmark.reference import mp3 as ref
from conftest import ROOT

CFG = json.loads((ROOT / "benchmark/configs/fma_mp3.json").read_text())
SMALL = dict(CFG, seconds=1.0)
CELL = "fma_mp3.shard32"


def granules(stream_fields):
    from symphonia_tpu_torch.testing import mp3_lame_builder as lb

    return lb.Granules(**{k: np.asarray(v).astype(np.int64)
                          for k, v in stream_fields.items()})


def shrink(root):
    """The MP3 cell small enough for the CPU: clips of 1 s, a pool of 4,
    requests of 2, every request's outputs checked."""
    p = root / "benchmark/configs/fma_mp3.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), seconds=1.0)))
    p = root / "benchmark/traffic/shard32.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), pool=4, batch=2,
                                 compare_every=1)))


@pytest.fixture
def mp3_root(tmp_path):
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
    (dict(SMALL, transient_every=4, ms_share=0.5, scfsi_share=0.6), False),
    (dict(SMALL, spectrum=dict(SMALL["spectrum"], laplace_scale=[
        2 * v for v in SMALL["spectrum"]["laplace_scale"]])), True)],
    ids=["config", "features", "silent_frames"])
def test_streams_equal_the_test_encoder(cfg, silent_frames):
    """For the same draws the generator writes the test encoder's bytes,
    silent frames included."""
    from symphonia_tpu_torch.testing import mp3_lame_builder as lb

    rng = np.random.default_rng(3)
    tg = torch.Generator().manual_seed(4)
    draws = gen.draw(cfg, rng, tg, 3, "cpu")
    n = int(round(cfg["seconds"] * gen.SAMPLE_RATE))
    tags = [gen.default_tags(i * 7919) for i in range(3)]
    datas, written, silent = gen.encode_streams(dict(draws), n, tags)
    for s in range(3):
        g = granules({k: v[s].numpy() for k, v in draws.items()})
        b = lb.build_stream(g, n, tags=tags[s])
        assert datas[s] == b.data
        assert np.flatnonzero(silent[s]).tolist() == b.silent.tolist()
        np.testing.assert_array_equal(written["quant"][s].numpy(),
                                      b.granules.quant)
    if silent_frames:
        assert silent.any()


def test_a_pool_stream_decodes_as_the_encoder_wrote_it():
    from symphonia_tpu_torch.testing import mp3_lame_builder as lb

    (s,) = gen.make_pool(SMALL, 1, 2**33 + 1)
    assert s.data == lb.build_stream(granules(s.granules), s.n_samples,
                                     tags=s.tags).data


def test_reference_equals_the_ports_plain_reference():
    from symphonia_tpu_torch.testing import mp3_reference as plain

    pool = gen.make_pool(dict(SMALL, transient_every=6), 2, 19)
    got = ref.expected(pool, [0, 1], "cpu")
    for i, s in enumerate(pool):
        want = plain.synthesise(granules(s.granules), s.n_samples,
                                s.enc_padding)
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-12)


def test_port_within_the_limit_and_the_control_outside():
    from symphonia_tpu_torch import batch

    pool = gen.make_pool(SMALL, 3, 2**31 + 17)
    idx = [0, 1, 2]
    got = ref.judge(pool, [(idx, batch.decode_many(
        [s.data for s in pool], device="cpu"))], "cpu")
    assert got["streams_wrong_shape"] == 0 and got["streams_compared"] == 3
    assert got["max_rel_err"] < CFG["checks"]["max_rel_err"] / 10
    ctl = ref.judge(pool, [(idx, ref.control(pool))], "cpu")
    assert ctl["max_rel_err"] > 10 * CFG["checks"]["max_rel_err"]


def run(root, trace=False, decode=None, seconds=0.6):
    return harness.run(CELL, 2**31 + 99, seconds, trace, time.perf_counter(),
                       device="cpu", root=root, decode=decode)


def _sample_altered(real):
    def decode(datas, **kw):
        outs = real(datas, **kw)
        s = outs[-1].samples
        s[0, s.shape[1] // 2] += 1e-3
        return outs
    return decode


def _clip_dropped(real):
    """A merged request that loses its last clip."""
    def decode(datas, **kw):
        return real(datas[:-1], **kw)
    return decode


def _trim_left_out(real):
    """Layer III decoded without the LAME tag's gapless trim."""
    from symphonia_tpu_torch import batch

    def decode(datas, **kw):
        return batch.Mp3BatchDecoder(device=kw["device"],
                                     gapless=False).decode_many(datas)
    return decode


@pytest.mark.parametrize("fault", [_sample_altered, _clip_dropped,
                                   _trim_left_out])
def test_broken_paths_read_incorrect(mp3_root, fault):
    from symphonia_tpu_torch import batch

    r = run(mp3_root, decode=fault(batch.decode_many), seconds=0.3)
    assert r["correct"] is False


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_end_to_end(mp3_root, trace):
    r = run(mp3_root, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    m = r["metrics"]
    if not trace:
        assert {"realtime_x", "setup_s"} <= set(m)
        return
    # The CPU has no device trace: the kernels' rooflines and the idle
    # share are left out, every span and counter reader reads.
    want = {f"{n}.fma_mp3" for n in (
        "scan_share", "extract_share", "pack_share", "copy_wait_share",
        "stitch_share", "facade_share", "enqueue_share",
        "h2d_bytes_per_audio_s", "d2h_bytes_per_audio_s")}
    assert want <= set(m)
    assert m["scan_share.fma_mp3"]["value"] > 0
    # A frame sends 4 lanes up, each 576 float32 spectra, its block type
    # (int32) and mixed flag, and its 2 granules' boundary bytes; a clip
    # is 1 s of audio after the trim.
    frames = gen.n_frames(gen.SAMPLE_RATE)
    assert m["h2d_bytes_per_audio_s.fma_mp3"]["value"] == frames * (
        4 * (576 * 4 + 4 + 1) + 2)


def test_readers_read_nothing_without_the_ports_counters():
    """On a port without the MP3 counters or the scan span (the parent of
    this cell), the new readers return nothing and do not raise."""
    from benchmark.metrics import m1_roofline, m2_roofline, scan_share

    class Req:
        root = type("S", (), {"name": "decode_many"})()
        calls, counters, self_ns = {"decode_many": 1}, {}, {"decode_many": 5}

    ctx = harness.Context(setup_s=1.0, window_s=1.0, requests=1)
    ctx.trace = {"breakdown": {"device_ops": [["x::mp3_hybrid_kernel(", 1.0],
                                              ["x::synth_kernel<18, false>(",
                                               1.0]]}}
    import symphonia_tpu_torch.trace as tr

    real = tr.requests
    tr.requests = lambda last=None: [Req()]
    try:
        assert scan_share.read(ctx) is None
        assert m1_roofline.read(ctx) is None
        assert m2_roofline.read(ctx) is None
        Req.counters = {"mp3_lanes": 4600, "mp3_frames": 1150}
        a, b = m1_roofline.read(ctx), m2_roofline.read(ctx)
        assert 0 < a < 100 and 0 < b < 100
    finally:
        tr.requests = real


def test_work_equals_chip_smokes():
    import chip_smoke
    from benchmark.work import mp3 as work

    for G, C in ((1, 2), (4096, 2), (73600, 2)):
        assert work.work_mp3_hybrid(G * C, G) == chip_smoke.work_mp3_hybrid(
            G, C)
        assert work.work_mp3_synth(G * C, G, C) == chip_smoke.work_mp3_synth(
            G, C)
