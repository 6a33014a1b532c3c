"""Common Voice-shaped speech MP3 on the port's normal path: LAME-style
48 kHz mono 64 kbit/s Layer III streams (``testing/mp3_lame_builder.py``
with ``Format(48000, 1, 64)``: 192-byte frames, 17-byte side info, a lead-in
and a tail of low-level granules, short blocks, the reservoir in use)
through ``batch.decode_many`` on the CPU, against the plain float64
reference (``testing/mp3_reference.py``) at the 48 kHz scalefactor bands;
the 44.1 kHz bands refused; merged against per-file output; the reference
against the JAX package's decode of the same bytes.

The tolerance, 1e-5 of the stream's peak, is the MP3 cell's
(``tests/test_torch_mp3_fma.py``): the port computes in float32, which
leaves a few 1e-7 of the peak here; TF32 operands leave ~5e-4, and the
44.1 kHz band tables more than 1e-2.
"""

import numpy as np
import pytest
import torch

from symphonia_tpu_torch import batch
from symphonia_tpu_torch.testing import mp3_lame_builder as lb
from symphonia_tpu_torch.testing import mp3_reference as ref

TOL = 1e-5
FMT = lb.Format(48000, 1, 64)
# Four clips of 0.5-1.5 s: (seed, seconds, lead-in and tail granules).
CLIPS = ((101, 0.5, 8, 6), (102, 0.8, 16, 10), (103, 1.1, 24, 12),
         (104, 1.5, 30, 20))


def rel_err(got, want: torch.Tensor) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def speech(seed, seconds, lead, tail, **draw):
    """A speech-shaped clip: a low-level lead-in and tail, spectra of a
    14 kHz envelope between them that the frames' 171 bytes of main data
    hold with the reservoir, a short-block triple every 8 granules."""
    n = int(seconds * FMT.sample_rate)
    env = lb.envelope(bandwidth_hz=14000, scale=0.15, sample_rate=48000)
    kw = dict(env=env, transient_every=8, silence=(lead, tail), fmt=FMT)
    g = lb.draw(np.random.default_rng(seed), n, **dict(kw, **draw))
    return lb.build_stream(g, n, tags={}, fmt=FMT), n


def _want(b, n, sample_rate=48000, precision="float64"):
    return ref.synthesise(b.granules, n, lb.enc_padding(n),
                          precision=precision, sample_rate=sample_rate)


@pytest.mark.parametrize("clip", range(len(CLIPS)))
def test_clip_against_the_reference(clip):
    seed, seconds, lead, tail = CLIPS[clip]
    b, n = speech(*CLIPS[clip])
    g = b.granules
    # What the clip holds: the silences, short blocks, the reservoir.
    assert g.quant.shape[1] == 1 and not g.ms.any()
    assert np.abs(g.quant[:lead]).max() == 1 and not g.scalefac[:lead].any()
    assert np.abs(g.quant[-tail:]).max() == 1
    assert (g.block_type == lb.SHORT).any()
    assert (b.main_data_begin > 0).any() and len(b.silent) == 0
    routes = (batch.host_routes, batch.packet_routes)
    out = batch.decode_many([b.data], device="cpu")[0]
    assert (batch.host_routes, batch.packet_routes) == routes
    want = _want(b, n)
    assert out.sample_rate == 48000
    assert out.samples.shape == tuple(want.shape) == (1, n)
    assert rel_err(out.samples, want) < TOL


def test_merged_equals_per_file():
    streams = [speech(*c)[0].data for c in CLIPS]
    merged = batch.decode_many(streams, device="cpu")
    for data, m in zip(streams, merged):
        (alone,) = batch.decode_many([data], device="cpu")
        assert m.samples.shape == alone.samples.shape
        np.testing.assert_array_equal(m.samples, alone.samples)


@pytest.mark.parametrize("control", ["band_tables_44k", "tf32"])
def test_the_controls_fail_the_tolerance(control):
    """The 44.1 kHz band tables on a 48 kHz clip, and TF32 operands, are
    both refused."""
    b, n = speech(*CLIPS[1])
    want = _want(b, n)
    if control == "tf32":
        got = _want(b, n, precision="tf32")
    else:
        got = _want(b, n, sample_rate=44100)
    assert rel_err(got, want) > 10 * TOL


def test_frames_as_the_standard_lays_them_out():
    """192-byte mono frames at 64 kbit/s and 48 kHz, the 17-byte side
    info's main_data_begin as written, the Info tag's trim."""
    from symphonia_tpu_torch.core.formats import FormatOptions
    from symphonia_tpu_torch.core.io import MediaSourceStream
    from symphonia_tpu_torch.formats.mpa import MpaReader

    b, n = speech(*CLIPS[2])
    r = MpaReader(MediaSourceStream(b.data), FormatOptions())
    t = r.default_track()
    F = lb.n_frames(n)
    assert len(r._offsets) == F and set(r._sizes.tolist()) == {192}
    assert r.header.n_channels == 1 and r.header.sample_rate == 48000
    assert t.delay == lb.ENC_DELAY + lb.DECODER_DELAY
    assert t.padding == lb.enc_padding(n) - lb.DECODER_DELAY
    for f, off in enumerate(r._offsets.tolist()):
        frame = b.data[off : off + 192]
        assert frame[:4] == lb.header(0, False, FMT)
        assert (frame[4] << 1 | frame[5] >> 7) == b.main_data_begin[f]
        assert frame[5] & 0x7C == 0          # the 5 private bits


@pytest.mark.parametrize("rate", [32000, 44100, 48000])
def test_band_tables_are_the_standards(rate):
    """The reference's band edges of each rate (its own copy of table
    B.8) equal the port's and the test encoder's."""
    from symphonia_tpu_torch.codecs.mpa_layer3 import tables

    t = tables()
    i = (44100, 48000, 32000).index(rate)
    long_, short = ref.SFB[rate]
    assert list(long_) == t["sfb_long"][i].tolist()
    widths = np.diff(short)
    edges = np.concatenate([[0], np.cumsum(np.repeat(widths, 3))])
    assert edges.tolist() == t["sfb_short"][i].tolist()
    assert lb.SFB[rate] == ref.SFB[rate]


@pytest.mark.parametrize("fmt", [dict(sample_rate=22050),
                                 dict(channels=3), dict(bitrate_kbps=65)],
                         ids=["rate", "channels", "bitrate"])
def test_format_refuses_what_mpeg1_layer3_has_not(fmt):
    with pytest.raises(ValueError):
        lb.Format(**fmt)


@pytest.mark.parametrize("clip", range(len(CLIPS)))
def test_reference_against_the_jax_package(clip):
    """The JAX package's decode of each clip against the reference, and
    the port's decode of the same bytes against the JAX package's, each
    within the tolerance of the peak."""
    from symphonia_tpu import batch as jax_batch

    b, n = speech(*CLIPS[clip])
    got = np.asarray(jax_batch.decode_bytes(b.data).samples)
    want = _want(b, n)
    assert got.shape == tuple(want.shape)
    assert rel_err(got, want) < TOL
    port = batch.decode_many([b.data], device="cpu")[0].samples
    assert port.shape == got.shape
    assert rel_err(port, torch.from_numpy(got.astype(np.float64))) < TOL


def test_chip_smoke_phase_14_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 14 rehearsed on the CPU at a pool of two
    clips, the timers stubbed: the kernels' twins stand in for the
    kernels, so this holds the phase's wiring (M0's plan and lanes, the
    chain as decode_many runs it, the layouts compared) and its line."""
    import json

    import chip_smoke
    from symphonia_tpu_torch.ops import mp3_dense as md

    for name in ("cuda_ms", "enqueue_ms", "graph_ms"):
        monkeypatch.setattr(chip_smoke, name, lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    info = chip_smoke.phase_mp3_speech(2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "phase 14 mp3_speech: " + json.dumps(info)
    clip, k = info["clip"], info["kernels"]
    assert clip["granules"] == 2 * clip["frames"] > 0
    assert clip["frame_bytes"] == 192 * clip["frames"]
    assert clip["reservoir_frames"] > 1
    assert info["checked"]["speech_pool"]["clips"] == 2
    assert info["decode_many_bits_equal"]
    assert k["mp3_hybrid"]["run"] == md.run_length(clip["granules"], 1) == 1
    assert k["mp3_hybrid"]["shape"] == [clip["granules"], 1, 576]
    assert all(k[n]["bits_equal_twin"] for n in ("mp3_hybrid", "mp3_synth",
                                                 "mp3_place"))
    assert k["mp3_place"]["bits_equal_host"]
