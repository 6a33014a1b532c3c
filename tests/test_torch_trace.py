"""The port's spans and copy counters (``symphonia_tpu_torch/trace.py``)
on the CPU: nothing recorded without a profiler, the same PCM with one, one
root a ``decode_many`` call with every span under it, the layer spans where
``batch.py`` puts them, self times that add up to the root, one profiler
range a span, and copy bytes equal to those reckoned from the packed
shapes."""

import functools
import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from symphonia_tpu_torch import batch, trace
from symphonia_tpu_torch.core.io import MediaSourceStream
from symphonia_tpu_torch.formats.flac import FlacReader
from symphonia_tpu_torch.testing.flac_builder import (build_flac_file,
                                                      random_walk)

FIVE = ("pack", "h2d", "enqueue", "d2h", "stitch")


def _flac(n, ch, block, seed):
    return build_flac_file(random_walk(n, 16, seed=seed, ch=ch),
                           block_size=block, stereo_mode="mid_side"
                           if ch == 2 else "independent", kind="fixed",
                           order=2)


@functools.lru_cache(maxsize=None)
def flacs(kind):
    """Three mono streams, two stereo ones, or all five interleaved
    (built on first use: the stream builder takes seconds)."""
    if kind == "mono":
        return tuple(_flac(1024 * (2 + s), 1, 256, s) for s in range(3))
    if kind == "stereo":
        return tuple(_flac(640 * (2 + s), 2, 256, 10 + s) for s in range(2))
    m, st = flacs("mono"), flacs("stereo")
    return m[:2] + st[:1] + m[2:] + st[1:]


@pytest.fixture(autouse=True)
def empty_store():
    trace.reset()
    yield
    trace.reset()


def traced(fn, *a, **kw):
    """``fn`` under a CPU profiler -> (its result, the profiler, the
    requests it stored)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*a, **kw)
    return out, prof, trace.requests()


def test_switch_is_the_profiler():
    assert not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
    assert not trace.enabled()


def test_untraced_calls_store_nothing():
    batch.decode_many(flacs("mixed"), device="cpu", verify=True)
    assert trace.requests() == []
    assert trace.span("x") is trace.span("y")  # the shared no-op context


def test_nothing_recorded_after_the_profiler_exits():
    traced(batch.decode_many, flacs("mono"), device="cpu")
    n = len(trace.requests())
    batch.decode_many(flacs("mono"), device="cpu")
    with trace.span("decode_many"):
        trace.count("h2d_bytes", 8)
    assert len(trace.requests()) == n == 1


@pytest.mark.parametrize("verify", [False, True])
def test_same_pcm_with_and_without_a_profiler(verify):
    want = batch.decode_many(flacs("mixed"), device="cpu", verify=verify)
    got, _, _ = traced(batch.decode_many, flacs("mixed"), device="cpu",
                       verify=verify)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.samples, w.samples)
        assert g.md5_ok == w.md5_ok


def test_one_root_a_call_and_every_span_under_it():
    def three():
        return [batch.decode_many(d, device="cpu")
                for d in map(flacs, ("mono", "stereo", "mixed"))]

    _, _, reqs = traced(three)
    assert [r.root.name for r in reqs] == ["decode_many"] * 3
    ids = [r.id for r in reqs]
    assert ids == sorted(ids) and len(set(ids)) == 3
    for r in reqs:
        assert r.root.parent is None
        assert all(s.request == r.id for s in r.spans)
        for i, s in enumerate(r.spans[1:], 1):
            seen = set()
            while s.parent is not None:
                assert s.parent < i and s.parent not in seen
                seen.add(s.parent)
                i, s = s.parent, r.spans[s.parent]
            assert s is r.root
            assert r.root.start_ns <= s.start_ns


def test_a_direct_decoder_call_is_its_own_root():
    dec = batch.FlacBatchDecoder(device="cpu")
    _, _, reqs = traced(dec.decode_bytes, flacs("mono")[0])
    assert reqs and all(r.root.parent is None for r in reqs)
    assert "decode_many" not in {r.root.name for r in reqs}


@pytest.mark.parametrize("verify", [False, True])
def test_per_stream_spans(verify):
    _, _, (r,) = traced(batch.decode_many, flacs("mixed"), device="cpu",
                        verify=verify)
    n = len(flacs("mixed"))
    assert r.calls["decode_many"] == r.calls["setup"] == 1
    for name in ("probe", "extract"):
        assert r.calls[name] == n, name
    assert "open" not in r.calls  # the decoder takes the probe's reader
    assert r.calls.get("verify", 0) == (n if verify else 0)


@pytest.mark.parametrize("kind,C", [("mono", 1), ("stereo", 2)])
def test_copy_and_kernel_spans_run_per_chunk(monkeypatch, kind, C):
    monkeypatch.setitem(batch.FlacBatchDecoder.__init__.__kwdefaults__,
                        "lane_chunk", 8)
    streams = flacs(kind)
    _, _, (r,) = traced(batch.decode_many, streams, device="cpu")
    frames = sum(_packed_shape(d)[0] for d in streams)
    chunks = math.ceil(frames / (8 // C))
    assert chunks >= 2
    for name in ("h2d", "enqueue", "d2h"):
        assert r.calls[name] == chunks, name
    assert r.calls["pack"] >= chunks and r.calls["stitch"] >= chunks
    seq = " ".join(s.name for s in r.spans if s.name in FIVE)
    assert " ".join(FIVE * chunks) in seq


def test_self_times_add_up_to_the_root():
    _, _, reqs = traced(lambda: [batch.decode_many(d, device="cpu",
                                                   verify=True)
                                 for d in map(flacs, ("mono", "mixed"))])
    for r in reqs:
        assert sum(r.self_ns.values()) == r.root.end_ns - r.root.start_ns
        assert all(v >= 0 for v in r.self_ns.values())


def test_one_profiler_range_a_span():
    # Each stored span is one CPU range ``span:<name>`` of the profiler's
    # trace, inside its parent's range.
    _, prof, (r,) = traced(batch.decode_many, flacs("mixed"), device="cpu",
                           verify=True)
    ranges = sorted((e.start_ns(), -e.end_ns(), e.name()[len("span:"):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("span:"))
    assert Counter(n for _, _, n in ranges) == Counter(r.calls)
    assert set(r.calls) >= {"decode_many", "setup", "probe", "extract",
                            "verify"} | set(FIVE)
    assert "open" not in r.calls
    # Opened in start order, the ranges nest as the stored spans do.
    assert [n for _, _, n in ranges] == [s.name for s in r.spans]
    stack = []
    for a, b, n in ranges:
        while stack and stack[-1] <= a:
            stack.pop()
        assert not stack or -b <= stack[-1], n
        stack.append(-b)


def _packed_shape(data):
    """(F, C, n_max) of a stream's packed lanes."""
    reader = FlacReader(MediaSourceStream(data))
    packed, _ = batch.FlacBatchDecoder(device="cpu")._extract_host(reader)
    return int(packed["F"]), int(packed["C"]), int(packed["n_max"])


@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_copy_bytes_equal_the_packed_shapes(kind):
    # Per channel-count group: each lane sends its residual row (the
    # group's widest), 32 coefficients, order, shift and wasted bits as
    # int32, a stereo frame its assignment code; each lane's row comes
    # back whole. F1's lanes and F2's frames are counted with their rows'
    # samples.
    streams = flacs(kind)
    groups = {}
    for d in streams:
        F, C, n_max = _packed_shape(d)
        g = groups.setdefault(C, [0, 0])
        g[0] += F
        g[1] = max(g[1], n_max)
    h2d = sum(4 * F * (C * (n_max + 32 + 3) + (C == 2))
              for C, (F, n_max) in groups.items())
    d2h = sum(4 * F * C * n_max for C, (F, n_max) in groups.items())
    want = {"h2d_bytes": h2d, "d2h_bytes": d2h,
            "flac_lanes": sum(F * C for C, (F, _) in groups.items()),
            "flac_lane_samples": sum(F * C * n for C, (F, n) in
                                     groups.items())}
    if 2 in groups:
        want.update(flac_stereo_frames=groups[2][0],
                    flac_stereo_samples=groups[2][0] * groups[2][1])
    _, _, (r,) = traced(batch.decode_many, streams, device="cpu")
    assert r.counters == want


def _mp3():
    from symphonia_tpu_torch.testing import mp3_builder

    return mp3_builder.build_mpeg1_l3_stream(3, n_ch=2, seed=1)


def _aac():
    from symphonia_tpu_torch.testing.aac_builder import (build_adts,
                                                         build_raw_block)

    q = np.zeros(1024, np.int64)
    q[:8] = [100, -500, 17, -16, 2000, -8000, 15, 1]
    return build_adts([build_raw_block([q, -q], [s, s], 12, 140, 44100)
                       for s in (0, 1, 2, 3)], 44100, 2)


def _vorbis():
    from symphonia_tpu_torch.testing.vorbis_stream import build_vorbis

    return build_vorbis(44100, 8, 11, 0.5, 31)


@pytest.mark.parametrize("make", [_mp3, _aac, _vorbis],
                         ids=["mp3", "aac", "vorbis"])
def test_other_codecs_record_their_layers(make):
    data = make()
    want = batch.decode_many([data, data], device="cpu")
    got, _, (r,) = traced(batch.decode_many, [data, data], device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.samples, w.samples)
    assert r.calls["extract"] == 2
    for name in ("h2d", "enqueue", "d2h", "pack", "stitch"):
        assert r.calls.get(name, 0) >= 1, name
    assert r.counters["h2d_bytes"] > 0 and r.counters["d2h_bytes"] > 0
    assert sum(r.self_ns.values()) == r.root.end_ns - r.root.start_ns


def test_helpers_count_what_they_hand_over():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)[:, ::2]  # a strided view
    b = np.ones(5, bool)

    def copies():
        with trace.span("decode_many"):
            ta, tb = trace.to_device("cpu", a, b)
            back = trace.to_host(ta)
        return ta, tb, back

    (ta, tb, back), _, (r,) = traced(copies)
    assert torch.equal(ta, torch.from_numpy(np.ascontiguousarray(a)))
    assert tb.dtype == torch.bool and np.array_equal(back, a)
    assert r.counters == {"h2d_bytes": 6 * 4 + 5, "d2h_bytes": 6 * 4}
    assert r.calls == {"decode_many": 1, "h2d": 1, "d2h": 1}


def test_cost_tool_measures_both_sides(capsys):
    from symphonia_tpu_torch.tools import trace_cost

    out = trace_cost.main(n_off=1000, n_on=100)
    assert 0 < out["off_ns_per_span"] and 0 < out["on_ns_per_span"]
    assert out["profiler"][0] == "CPU" and trace.requests() == []
    assert '"off_ns_per_span"' in capsys.readouterr().out


def _layer3():
    """A 48 kHz mono Layer III clip of 0.5 s, and its granules."""
    from symphonia_tpu_torch.testing import mp3_lame_builder as lb

    fmt, n = lb.Format(48000, 1, 64), 24000
    g = lb.draw(np.random.default_rng(7), n, transient_every=8, fmt=fmt,
                env=lb.envelope(14000, 0.15, sample_rate=48000))
    return lb.build_stream(g, n, tags={}, fmt=fmt).data, 2 * lb.n_frames(n)


def _layer2():
    from chip_smoke import build_mpa_l12

    return build_mpa_l12("l2", 6, 42), None


@pytest.mark.parametrize("make,module", [(_layer3, "Mp3Dense"),
                                         (_layer2, "L12Dense")],
                         ids=["layer3", "layer2"])
def test_constant_tables_span_and_bytes(make, module):
    """One ``decode_many`` builds its MPEG audio decoder's constant
    operators once, in one ``tables`` span, and counts their bytes as
    ``mp3_table_bytes`` and in ``h2d_bytes`` (Layer III: the lanes, the
    boundary mask and the tables, exactly); untraced, nothing is kept."""
    from symphonia_tpu_torch.ops import mp3_dense

    data, G = make()
    tables = (mp3_dense.reference_tables() if module == "Mp3Dense"
              else mp3_dense.l12_tables())
    dense = getattr(mp3_dense, module).from_numpy(tables, "cpu")
    nbytes = sum(b.numel() * b.element_size() for b in dense.buffers())
    assert nbytes == (22976 if module == "Mp3Dense" else 10240)
    batch.decode_many([data], device="cpu")
    assert trace.requests() == []
    _, _, (r,) = traced(batch.decode_many, [data], device="cpu")
    assert r.calls["tables"] == 1
    assert r.counters["mp3_table_bytes"] == nbytes
    if G is None:
        assert r.counters["h2d_bytes"] > nbytes
    else:
        assert r.counters["h2d_bytes"] == G * (576 * 4 + 4 + 1) + G + nbytes
    assert sum(r.self_ns.values()) == r.root.end_ns - r.root.start_ns
