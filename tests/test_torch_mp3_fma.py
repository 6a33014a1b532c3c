"""FMA-shaped MP3 on the port's normal path: LAME-style 256 kbps joint-stereo
Layer III streams (``testing/mp3_lame_builder.py``) through
``batch.decode_many`` on the CPU, against the plain float64 reference
(``testing/mp3_reference.py``), with each feature of the syntax on and
off; merged against per-file output; the reference against the JAX
package's decode of the same bytes; the ``scan`` span and the MP3
counters.

The tolerance, 1e-5 of the stream's peak: the port computes in float32
(the native library's requantisation through its |is|^(4/3) table, M1's
IMDCT, M2's synthesis), which leaves about 4e-7 of the peak against the
float64 synthesis on these streams; the same synthesis with the IMDCT's
and the matrixing's operands rounded to TF32 leaves about 5e-4, which the
tolerance refuses by more than ten times.
"""

import numpy as np
import pytest
import torch

from symphonia_tpu_torch import batch, trace
from symphonia_tpu_torch.testing import mp3_lame_builder as lb
from symphonia_tpu_torch.testing import mp3_reference as ref

TOL = 1e-5
N = 30000          # samples a channel: 29 frames, 0.68 s


def rel_err(got, want: torch.Tensor) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def built(seed, n=N, tweak=None, build=None, **draw):
    rng = np.random.default_rng(seed)
    g = lb.draw(rng, n, **draw)
    if tweak is not None:
        tweak(g, rng)
    return lb.build_stream(g, n, **(build or {}))


def decode_against_reference(b, n=N, gapless=True):
    routes = (batch.host_routes, batch.packet_routes)
    out = batch.decode_many([b.data], device="cpu")[0]
    assert (batch.host_routes, batch.packet_routes) == routes
    want = ref.synthesise(b.granules, n, lb.enc_padding(n), gapless=gapless)
    assert out.sample_rate == lb.SAMPLE_RATE
    assert out.samples.shape == tuple(want.shape)
    assert rel_err(out.samples, want) < TOL
    return out


def _fields(b):
    return [c for fr in b.fields for gr in fr for c in gr]


def _tail(dense: bool):
    """The long granules' lines 300-507 as +-1 values: all of them (the
    quad table B codes them cheaper) or one in ten (table A)."""
    def tweak(g, rng):
        share = 1.0 if dense else 0.1
        v = np.where(rng.random((len(g.quant), 2, 208)) < share,
                     rng.choice([-1, 1], (len(g.quant), 2, 208)), 0)
        long_ = (g.block_type == lb.LONG)[..., None]
        g.quant[..., 300:508] = np.where(long_, v, g.quant[..., 300:508])
        g.quant[..., 508:] = np.where(long_, 0, g.quant[..., 508:])
    return tweak


# Each feature on and off: (draw and build arguments, what the stream
# holds when it is on).
FEATURES = {
    "mid_side": (dict(ms_share=1.0), dict(ms_share=0.0),
                 lambda b: b.granules.ms.any()),
    "start_short_stop": (dict(transient_every=6), dict(transient_every=0),
                         lambda b: any(f["block_type"] == lb.SHORT
                                       for f in _fields(b))),
    # Values above 15 take a linbits table (16-31) and escapes.
    "linbits": (dict(), dict(max_value=15),
                lambda b: np.abs(b.granules.quant).max() > 15),
    "count1_table_b": (dict(tweak=_tail(True)), dict(tweak=_tail(False)),
                       lambda b: any(f["count1table"] for f in _fields(b)
                                     if f["block_type"] == lb.LONG)),
    "scfsi": (dict(scfsi_share=0.5), dict(scfsi_share=0.0),
              lambda b: b.granules.scfsi.any()),
    "reservoir": (dict(), dict(env=lb.envelope(scale=1.0),
                               build=dict(reservoir=False)),
                  lambda b: (b.main_data_begin > 0).any()),
    "subblock_gain_preflag": (dict(transient_every=6, subblock_share=0.6,
                                   preflag_share=0.5),
                              dict(transient_every=6, subblock_share=0.0,
                                   preflag_share=0.0),
                              lambda b: b.granules.subblock_gain.any()
                              and b.granules.preflag.any()),
}


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_against_the_reference(feature, on):
    kw_on, kw_off, holds = FEATURES[feature]
    b = built(11 + sorted(FEATURES).index(feature), **(kw_on if on
                                                       else kw_off))
    assert bool(holds(b)) == on
    decode_against_reference(b)


def test_count1_regions_in_both_quad_tables():
    """The count1 region coded with quad table A where its quads are
    sparse and with B where they are dense, both decoded exactly."""
    for dense in (False, True):
        b = built(5, tweak=_tail(dense))
        tables = {f["count1table"] for f in _fields(b)
                  if f["block_type"] == lb.LONG}
        assert tables == {int(dense)}
        decode_against_reference(b)


@pytest.mark.parametrize("info", [True, False], ids=["info", "no_info"])
def test_info_frame_and_its_trim(info):
    """With the LAME Info frame the output is trimmed to the stream's
    samples (delay 576 + 529, padding less 529); without it every
    frame's 1152 samples come out."""
    b = built(21, build=dict(info=info))
    assert (b"Info" in b.data[:2000]) == info
    out = decode_against_reference(b, gapless=info)
    F = lb.n_frames(N)
    assert out.samples.shape[1] == (N if info else F * lb.SPF)


@pytest.mark.parametrize("tags", [None, {}], ids=["id3v2", "no_tag"])
def test_id3v2_tag(tags):
    b = built(23, build=dict(tags=tags))
    assert b.data.startswith(b"ID3\x04") == (tags is None)
    decode_against_reference(b)


def test_the_reader_takes_the_tags():
    from symphonia_tpu_torch.core.formats import FormatOptions
    from symphonia_tpu_torch.core.io import MediaSourceStream
    from symphonia_tpu_torch.formats.mpa import MpaReader

    b = built(3, n=44100)
    r = MpaReader(MediaSourceStream(b.data), FormatOptions())
    t = r.default_track()
    assert len(r._offsets) == lb.n_frames(44100)
    assert t.delay == lb.ENC_DELAY + lb.DECODER_DELAY
    assert t.padding == lb.enc_padding(44100) - lb.DECODER_DELAY
    assert set(r._sizes.tolist()) == {835, 836}


def test_silent_frames_where_the_reservoir_runs_dry():
    """Spectra beyond the frames' bytes: the frames that would not fit are
    written silent, and the port decodes what was written."""
    b = built(31, env=lb.envelope(scale=2.5))
    assert len(b.silent) > 0
    assert not b.granules.quant[2 * b.silent[0] : 2 * b.silent[0] + 2].any()
    decode_against_reference(b)


def test_merged_equals_per_file():
    streams = [built(40 + i, n=n).data
               for i, n in enumerate((N, 2 * N, N // 2))]
    merged = batch.decode_many(streams, device="cpu")
    for data, m in zip(streams, merged):
        (alone,) = batch.decode_many([data], device="cpu")
        assert m.samples.shape == alone.samples.shape
        np.testing.assert_array_equal(m.samples, alone.samples)


def test_reference_against_the_jax_package():
    from symphonia_tpu import batch as jax_batch

    b = built(51)
    got = jax_batch.decode_bytes(b.data)
    want = ref.synthesise(b.granules, N, lb.enc_padding(N))
    assert np.asarray(got.samples).shape == tuple(want.shape)
    assert rel_err(got.samples, want) < TOL


def test_the_tf32_control_fails_the_tolerance():
    b = built(61)
    want = ref.synthesise(b.granules, N, lb.enc_padding(N))
    tf32 = ref.synthesise(b.granules, N, lb.enc_padding(N), precision="tf32")
    assert rel_err(tf32, want) > 10 * TOL


def test_scan_span_and_counters():
    from torch.profiler import ProfilerActivity, profile

    bs = [built(71), built(72, n=2 * N)]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        batch.decode_many([b.data for b in bs], device="cpu")
    (r,) = trace.requests()
    trace.reset()
    frames = sum(len(b.granules.ms) for b in bs)
    short = sum(int((b.granules.block_type == lb.SHORT).sum()) for b in bs)
    assert r.calls["scan"] == len(bs)           # the probe's walk alone
    assert r.counters["mp3_frames"] == frames
    assert r.counters["mp3_lanes"] == 4 * frames
    assert r.counters["mp3_short_lanes"] == short > 0
    # The lanes, the boundary mask, and Layer III's constant operators
    # (uploaded once a call, span ``tables``).
    assert r.counters["mp3_table_bytes"] == 22976
    assert r.counters["h2d_bytes"] == 4 * frames * (576 * 4 + 4 + 1) + \
        2 * frames + 22976
