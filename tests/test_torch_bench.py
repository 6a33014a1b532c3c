"""The port's bench (``symphonia_tpu_torch/tools/bench.py``) against the
repository's ``bench.py`` on the CPU: each device stage on the same seeded
inputs at a few lanes against the JAX stage's own expression, the host
stages' audio seconds on the tracked files, the aggregate, a failing stage,
and the last line."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as ref
from symphonia_tpu_torch.tools import bench as port

CPU = torch.device("cpu")


def _cpu(arrays):
    return port._to(CPU, arrays)


def test_flac_device_stage_bit_exact():
    # F1 (wasted bits fused), then F2, on bench.py's inputs at 4 frames.
    from symphonia_tpu.ops import flac_dense

    inp = port.flac_device_inputs(n_frames=4, block=4096, order=8)
    got = port.flac_device_call(_cpu(inp)).numpy()
    block = 4096
    x = flac_dense.lpc_reconstruct_batch(
        jnp.asarray(inp["res"]), jnp.asarray(inp["coefs"]),
        jnp.asarray(inp["order"]), jnp.asarray(inp["shift"]), block)
    x = flac_dense.apply_wasted_bits(x, jnp.asarray(inp["wasted"]))
    want = np.asarray(flac_dense.decorrelate_batch(
        x.reshape(-1, 2, block), jnp.asarray(inp["assign"]))).reshape(
            -1, block)
    assert got.shape == (8, 4096) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 2000  # the recurrence ran


def test_flac_device_inputs_are_bench_pys():
    # The same generator draws in the same order as bench.py's stage.
    inp = port.flac_device_inputs(n_frames=3, block=64, order=8)
    rng = np.random.default_rng(0)
    res = rng.integers(-2000, 2000, size=(6, 64)).astype(np.int32)
    coefs = rng.integers(-(2**13), 2**13, size=(6, 8))
    assign = rng.integers(0, 4, size=3)
    np.testing.assert_array_equal(inp["res"], res)
    np.testing.assert_array_equal(inp["coefs"][:, :8], coefs)
    assert not inp["coefs"][:, 8:].any()
    np.testing.assert_array_equal(inp["assign"], assign)
    assert (inp["order"] == 8).all() and (inp["shift"] == 12).all()


def test_mp3_device_stage():
    from symphonia_tpu.ops.mp3_dense import mp3_dense_batch_jax

    inp = port.mp3_device_inputs(n_granules=12)
    got = port.mp3_device_call(port.mp3_device_dense(CPU), _cpu(inp))
    want = mp3_dense_batch_jax(jnp.asarray(inp["x"]), jnp.asarray(inp["bt"]),
                               jnp.asarray(inp["mixed"]))
    assert got[0].shape == (12, 2, 576)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5)
    assert set(inp["bt"].ravel()) == {0, 1, 2, 3}


def _aac_jax(inp):
    """bench.py's AAC stage body (bench.py:300-310) on numpy inputs:
    (dequantized coefficients, window/OLA output)."""
    from symphonia_tpu.codecs.aac import imdct_matrix_scaled, subband_info
    from symphonia_tpu.native import aac_pow43, aac_sfb_map
    from symphonia_tpu.ops.aac_dense import _ola_jax

    _, bl, _ = subband_info(44100)
    smap = jnp.asarray(aac_sfb_map(bl))
    p43_rows = jnp.asarray(aac_pow43().reshape(64, 128))
    q = jnp.asarray(inp["qbuf"]).astype(jnp.int32)
    mag = jnp.minimum(jnp.abs(q), 8191)
    rows = jnp.take(p43_rows, mag >> 7, axis=0)
    sel = (jnp.arange(128) == (mag & 127)[..., None]).astype(jnp.float32)
    co = (rows * sel).sum(-1) * jnp.asarray(inp["scales"])[:, smap]
    co = jnp.where(q < 0, -co, co)
    pcm = co @ jnp.asarray(imdct_matrix_scaled(1024)).T
    z = jnp.asarray(inp["seq"])
    return np.asarray(co), np.asarray(_ola_jax()(pcm, z, z, z))


def test_aac_device_stage():
    from symphonia_tpu_torch.ops.aac_dense import aac_dequant_plain

    inp = port.aac_device_inputs(n_frames=10)
    dense = port.aac_device_dense(CPU)
    bl = port.aac_bands_long()
    t = _cpu(inp)
    got = port.aac_device_call(dense, t, bl).numpy()
    co_want, want = _aac_jax(inp)
    # The dequant prologue's coefficients, bit for bit (the same sfb map
    # from the same subband_info(44100)).
    co = aac_dequant_plain(t["coeffs"], *dense.quant(
        t["qbuf"], t["scales"], t["deq"], bl)).numpy()
    np.testing.assert_array_equal(co, co_want)
    assert got.shape == want.shape == (10, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got).max() > 1e-3


def test_aac_device_sfb_map_is_bench_pys():
    from symphonia_tpu.codecs.aac import subband_info
    from symphonia_tpu.native import aac_sfb_map

    dense = port.aac_device_dense(CPU)
    np.testing.assert_array_equal(
        dense.sfb_map(port.aac_bands_long()).numpy(),
        aac_sfb_map(subband_info(44100)[1]))


def test_vorbis_device_stage():
    # Unit-normal spectra give outputs of peak ~90, where one float32 ulp
    # is ~8e-6: 1e-5 is taken relative to the peak.
    from symphonia_tpu.codecs.vorbis import imdct_matrix

    inp = port.vorbis_device_inputs(n_lanes=12)
    got = port.vorbis_device_call(_cpu(inp),
                                  port.vorbis_device_matrix(CPU)).numpy()
    want = np.asarray(jnp.asarray(inp["x"])
                      @ jnp.asarray(imdct_matrix(2048)).T)
    assert got.shape == want.shape == (12, 2048)
    peak = np.abs(want).max()
    assert peak > 10
    assert np.abs(got - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("stage", ["flac", "aac", "alac", "l2"])
def test_host_stage_audio_seconds(stage):
    # The tracked .bench_cache files, read by both benches.
    a_ref, w_ref = getattr(ref, f"bench_{stage}_host")(repeats=1)
    a_port, w_port = getattr(port, f"bench_{stage}_host")(repeats=1)
    assert a_port == a_ref > 7.5
    assert w_port > 0 and w_ref > 0


@pytest.mark.parametrize("stage", ["mp3", "vorbis", "adpcm"])
def test_generated_host_stage_audio_seconds(stage):
    # In-memory inputs (bench.py reads two of them from an installed
    # package): about 8 s of audio each.
    audio, wall = getattr(port, f"bench_{stage}_host")(repeats=1)
    assert 7.5 < audio < 8.5 and wall > 0


def test_stand_in_cost_on_bench_pys_files():
    # bench.py's MP3 and Vorbis inputs beside the stand-ins, one pass: the
    # file's audio seconds are bench.py's own.
    mp3 = Path(ref.HOUSE_MP3)
    res = port.stand_in_cost(mp3.read_bytes(),
                             mp3.with_suffix(".ogg").read_bytes(),
                             passes=1, repeats=1)
    a_ref, _ = ref.bench_mp3_host(repeats=1)
    assert res["audio_s"]["mp3_file"] == a_ref
    assert 7.5 < res["audio_s"]["mp3_stand_in"] < 8.5
    for k in ("mp3_file", "mp3_stand_in", "vorbis_file", "vorbis_stand_in",
              "mp3_ratio", "vorbis_ratio"):
        assert res[k] > 0
    assert res["mp3_ratio"] == res["mp3_stand_in"] / res["mp3_file"]


def test_tracked_inputs_are_unchanged():
    # The port's generators reproduce bench.py's cached files when they
    # are missing; where they exist both read the same bytes.
    assert port._gen_flac() == ref._gen_flac()
    assert port._gen_adts() == ref._gen_adts()
    frames, cookie, n = port._gen_alac()
    frames_ref, cookie_ref, n_ref = ref._gen_alac()
    assert (frames, cookie, n) == (frames_ref, cookie_ref, n_ref)


# Fixed stage results (audio seconds, wall seconds) for the aggregate test.
FIXED = {"flac_host": (8.0, 0.001), "mp3_host": (8.0, 0.002),
         "aac_host": (8.0, 0.004), "vorbis_host": (8.0, 0.02),
         "alac_host": (8.0, 0.01), "adpcm_host": (8.0, 0.009),
         "l2_host": (8.0, 0.008), "flac_device": (760.0, 0.001),
         "mp3_device": (2568.0, 0.5), "aac_device": (760.0, 0.002),
         "vorbis_device": (1520.0, 0.003)}


def _fake(name, fail=None, first=False):
    # Device stages of the port also return their first call's seconds.
    def fn(*a, **kw):
        if name == fail:
            raise RuntimeError(f"stage {name} failed")
        return FIXED[name] + ((0.5,) if first else ())

    return fn


def _patch_stages(monkeypatch, module, fail=None):
    for name in FIXED:
        first = module is port and name.endswith("_device")
        monkeypatch.setattr(module, f"bench_{name}",
                            _fake(name, fail, first))
    monkeypatch.setattr(module.time, "sleep", lambda s: None)


def _run(fn):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        fn()
    return out.getvalue().splitlines(), err.getvalue().splitlines()


def test_aggregate_matches_bench_py(monkeypatch):
    _patch_stages(monkeypatch, ref)
    _patch_stages(monkeypatch, port)
    monkeypatch.setattr(ref, "_configure_jax", lambda: None)
    out_ref, err_ref = _run(ref.main)
    out_port, err_port = _run(lambda: port.main(device="cpu"))
    want, got = json.loads(out_ref[-1]), json.loads(out_port[-1])
    assert got["value"] == want["value"] > 0
    assert got["unit"] == want["unit"]
    # The stage line and the pipelined line, as bench.py prints them.
    assert err_port[-2:] == err_ref[-2:]
    pipelined, rtx = port.aggregate({k: a / w for k, (a, w) in FIXED.items()})
    assert pipelined == {"flac": 8000.0, "mp3": 4000.0, "aac": 2000.0}
    assert rtx == pytest.approx(3 / (1 / 8000 + 1 / 4000 + 1 / 2000))
    assert round(rtx, 1) == want["value"]


def test_aggregate_is_zero_when_a_stage_is():
    stages = {k: a / w for k, (a, w) in FIXED.items()}
    stages["mp3_device"] = 0.0
    assert port.aggregate(stages)[1] == 0.0


@pytest.mark.parametrize("fail", list(FIXED))
def test_failing_stage_raises(monkeypatch, fail):
    _patch_stages(monkeypatch, port, fail=fail)
    with pytest.raises(RuntimeError, match=f"stage {fail} failed"):
        _run(lambda: port.main(device="cpu"))


def test_last_line(monkeypatch):
    # A whole run on the CPU, every stage real, at a few lanes and one
    # pass: the card line, then the JSON line with exactly bench.py's keys.
    small = {"flac_device": dict(n_frames=2, block=256, iters=1),
             "mp3_device": dict(n_granules=4, iters=1),
             "aac_device": dict(n_frames=4, iters=1),
             "vorbis_device": dict(n_lanes=4, iters=1)}
    res = {}
    out, err = _run(lambda: res.update(port.main(
        device="cpu", passes=1, min_passes=1, sizes=small)))
    line = json.loads(out[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["vs_baseline"] is None
    assert line["value"] > 0 and line["unit"] == "x realtime"
    assert out[-2] == "card: cpu"
    assert len(res["stages"]) == 11 and all(
        v > 0 for v in res["stages"].values())
    assert set(res["first_call_s"]) == {"flac_device", "mp3_device",
                                        "aac_device", "vorbis_device"}
    assert err[-2].startswith("stage realtime-x: ")
    assert err[-1].startswith("pipelined: ")
    assert "on one CPU" in line["metric"]
