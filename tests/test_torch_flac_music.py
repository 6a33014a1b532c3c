"""Stereo FLAC music (the musdb_flac configuration) through the port on the
CPU: the benchmark generator's 44.1 kHz stereo streams, 16 and 24 bits, in
every channel assignment (side channels of bps + 1 bits, precision-15
taps at 24 bits), decoded by ``decode_many(verify=True)`` sample for
sample with every MD5 verified; streams across lane chunks with F3's twin
carrying the MD5 at 3 bytes a sample; merged against per-file output; the
host route and the JAX package on the same bytes; the reference's
control read wrong; the MD5 placement at the bulk, online and music
shapes; chip_smoke.py's phase 16 rehearsed."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.gen import flac as gen_mono
from benchmark.gen import flac_music as gen
from benchmark.reference import flac_music as ref
from symphonia_tpu_torch import batch
from symphonia_tpu_torch.ops import flac_dense as fd

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "benchmark/configs/musdb_flac.json").read_text())


def small(lo: float = 0.15, hi: float = 0.3, hires=(1,)) -> dict:
    cfg = json.loads(json.dumps(CFG))
    cfg["duration_s"].update(min=lo, max=hi)
    cfg["hires_ranks"] = list(hires)
    return cfg


def forced(bps: int, assign: int, n: int = 9000, seed: int = 0):
    """A stream whose frames all take ``assign``: left and right near full
    scale in opposite phase, so the side channel needs bps + 1 bits.
    Returns (bytes, int32 [2, n] source)."""
    rng = np.random.default_rng(seed)
    peak = (1 << (bps - 1)) - 1
    t = np.arange(n)
    base = 0.9 * peak * np.sin(2 * np.pi * 441.0 * t / 44100)
    lr = [np.clip(np.round(g * base + rng.normal(0, 0.01 * peak, n)),
                  -peak - 1, peak).astype(np.int64) for g in (1.0, -0.97)]
    left, right = (torch.from_numpy(x) for x in lr)
    assert int((left - right).abs().max()) > peak  # bps + 1 bits
    frames, *_ = gen.encode_track(left, right, bps, CFG, force_assign=assign)
    pcm = np.stack(lr).astype(np.int32)
    return gen.file_bytes(pcm, frames, bps, CFG), pcm


@pytest.mark.parametrize("assign", range(4), ids=["independent", "left_side",
                                                   "right_side", "mid_side"])
@pytest.mark.parametrize("bps", [16, 24])
def test_every_assignment_decodes_exactly(bps, assign):
    data, pcm = forced(bps, assign, seed=bps + assign)
    (out,) = batch.decode_many([data], device="cpu", verify=True)
    assert out.sample_rate == 44100 and out.bits_per_sample == bps
    np.testing.assert_array_equal(out.samples, pcm)
    assert out.md5_ok is True


def test_the_pool_decodes_exactly_with_its_choices():
    """A generated pool: 16- and 24-bit tracks, the encoder's own mix of
    assignments, precision 12 and 15 taps."""
    pool = gen.make_pool(small(hires=(1, 3)), 4, 2**31 + 11)
    assert [s.frames["precision"] for s in pool] == [
        12 if s.bits == 16 else 15 for s in pool]
    assert {s.bits for s in pool} == {16, 24}
    outs = batch.decode_many([s.data for s in pool], device="cpu",
                             verify=True)
    got = ref.judge(pool, [(list(range(4)), outs)], "cpu")
    assert got == {"streams_wrong_shape": 0, "mismatched_samples": 0,
                   "md5_not_verified": 0, "streams_compared": 4}


@pytest.mark.parametrize("lane_chunk", [4, 6])
def test_streams_across_lane_chunks(monkeypatch, lane_chunk):
    """Chunks of 2 or 3 stereo frames: every stream spans several, F3's
    twin carries each MD5 across them (3 bytes a sample for the 24-bit
    ones), forced onto the card whatever the rule says."""
    calls = []
    real = fd.md5_lanes
    monkeypatch.setattr(fd, "md5_lanes",
                        lambda x, *a: (calls.append(x.shape[0]),
                                       real(x, *a))[1])
    monkeypatch.setattr(batch, "_md5_on_card", lambda parts: True)
    pool = gen.make_pool(small(0.3, 0.4, hires=(0,)), 2, 5)
    dec = batch.FlacBatchDecoder(device="cpu", verify=True,
                                 lane_chunk=lane_chunk)
    outs = dec.decode_many([s.data for s in pool])
    for o, s in zip(outs, pool):
        np.testing.assert_array_equal(o.samples, s.pcm)
        assert o.md5_ok is True
    F = sum(len(s.blocks) for s in pool)
    assert sum(calls) == F and len(calls) == -(-F // (lane_chunk // 2))
    assert all(len(s.blocks) > lane_chunk // 2 for s in pool)


def _trimmed(s, cut: int) -> bytes:
    """Stream ``s`` with STREAMINFO's total ``cut`` samples short of what
    its frames hold, and the MD5 of what is left."""
    n = s.pcm.shape[1] - cut
    b = bytearray(s.data)
    v = int.from_bytes(b[8 + 13 : 8 + 18], "big")
    b[8 + 13 : 8 + 18] = ((v >> 36 << 36) | n).to_bytes(5, "big")
    b[8 + 18 : 8 + 34] = gen.md5_of(s.pcm[:, :n], s.bits)
    return bytes(b)


@pytest.mark.parametrize("tracks,chunks", [(5, 3), (8, 6)])
def test_a_group_spread_over_lane_chunks(monkeypatch, tracks, chunks):
    """Unequal 16- and 24-bit tracks, one trimmed by STREAMINFO's total and
    one with the all-zero MD5, over 3 or 6 lane chunks: each chunk holds
    each track's frames as one run within one frame of its share, F3 runs
    once a chunk of at most lane_chunk // 2 frames, and every track
    decodes as the source and as a decode of its file alone."""
    pool = gen.make_pool(small(0.15, 0.35, hires=(1, 3)), tracks, 2**31 + 3)
    F = [len(s.blocks) for s in pool]
    assert len(set(F)) > 2 and {s.bits for s in pool} == {16, 24}
    per_chunk = -(-sum(F) // chunks)
    assert -(-sum(F) // per_chunk) == chunks
    datas = [s.data for s in pool]
    datas[1] = _trimmed(pool[1], 11)
    datas[2] = datas[2][: 8 + 18] + bytes(16) + datas[2][8 + 34 :]
    want = [s.pcm for s in pool]
    want[1] = want[1][:, :-11]

    seen, calls = [], []
    chunked = batch.FlacBatchDecoder._decode_packed_chunked
    real = fd.md5_lanes
    monkeypatch.setattr(batch.FlacBatchDecoder, "_decode_packed_chunked",
                        lambda self, *a: (seen.append(a),
                                          chunked(self, *a))[1])
    monkeypatch.setattr(fd, "md5_lanes",
                        lambda x, *a: (calls.append(x.shape[0]),
                                       real(x, *a))[1])
    monkeypatch.setattr(batch, "_md5_on_card", lambda parts: True)
    dec = batch.FlacBatchDecoder(device="cpu", verify=True,
                                 lane_chunk=2 * per_chunk)
    outs = dec.decode_many(datas)
    assert len(calls) == chunks and max(calls) <= per_chunk
    assert sum(calls) == sum(F)
    (_, _, owner, _, _), = seen
    for k, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_array_equal(o.samples, w)
        assert o.samples.flags.c_contiguous
        assert o.md5_ok is (None if k == 2 else True)
        (one,) = batch.decode_many([datas[k]], device="cpu", verify=True)
        np.testing.assert_array_equal(o.samples, one.samples)
    for c in range(chunks):
        part = owner[c * per_chunk : (c + 1) * per_chunk]
        for s, n in enumerate(F):
            at = np.flatnonzero(part == s)
            assert np.all(np.diff(at) == 1)
            assert abs(len(at) - n * len(part) / sum(F)) < 1


def test_merged_equals_per_file():
    pool = gen.make_pool(small(), 3, 7)
    datas = [s.data for s in pool]
    merged = batch.decode_many(datas, device="cpu", verify=True)
    for o, d in zip(merged, datas):
        (one,) = batch.decode_many([d], device="cpu", verify=True)
        np.testing.assert_array_equal(o.samples, one.samples)
        assert o.md5_ok is one.md5_ok is True


def test_host_route_decodes_the_generator():
    pool = gen.make_pool(small(hires=(0,)), 2, 9)
    for s in pool:
        out = batch._host_decode(s.data, gapless=True)
        np.testing.assert_array_equal(out.samples, s.pcm)


@pytest.mark.parametrize("assign", [None, *range(4)], ids=[
    "generated", "independent", "left_side", "right_side", "mid_side"])
@pytest.mark.parametrize("bps", [16, 24])
def test_jax_package_decodes_a_stream(bps, assign):
    """The port's decode_many and the JAX package's decode_bytes on the same
    bytes: a generated track (the encoder's own choices) or one whose
    frames all take ``assign`` with a side channel of bps + 1 bits, both
    equal to the source."""
    from symphonia_tpu import batch as jax_batch

    if assign is None:
        (s,) = gen.make_pool(small(0.1, 0.1, hires=(0,) if bps == 24 else ()),
                             1, 13)
        assert s.bits == bps
        data, pcm = s.data, s.pcm
    else:
        data, pcm = forced(bps, assign, seed=bps + assign)
    want = np.asarray(jax_batch.decode_bytes(data).samples)
    np.testing.assert_array_equal(want, pcm)
    (out,) = batch.decode_many([data], device="cpu", verify=True)
    np.testing.assert_array_equal(out.samples, want)
    assert out.md5_ok is True


def test_control_reads_mismatched():
    pool = gen.make_pool(small(), 2, 17)
    idx = [0, 1]
    got = ref.judge(pool, [(idx, ref.control(pool))], "cpu")
    assert got["mismatched_samples"] > 0
    assert got["md5_not_verified"] == 2
    # Without the slip the same decoder is exact: the slip alone differs.
    for s in pool:
        np.testing.assert_array_equal(ref.decode_track(s, slip=False), s.pcm)


def _on_card(lengths, bits, C: int) -> bool:
    """The placement the rule gives streams of ``lengths`` samples in one
    merged group of C channels (frames of 4,096, the default lane
    chunk)."""
    spans, blocks = [], []
    for k, (n, b) in enumerate(zip(lengths, bits)):
        F = -(-int(n) // 4096)
        si = SimpleNamespace(md5=b"\x01" * 16, n_samples=int(n),
                             bits_per_sample=int(b))
        spans.append((k, si, int(n), len(blocks), F))
        blocks += [4096] * (F - 1) + [int(n) - (F - 1) * 4096]
    dec = batch.FlacBatchDecoder(device="cpu", verify=True)
    md5, _ = dec._card_md5(C, spans, np.array(blocks, np.int32))
    return md5 is not None


def _shapes():
    bulk = dict(duration_s=dict(min=1.0, max=35.0, beta=[3.0, 5.72]),
                sample_rate=16000, block_size=4096, lpc_order=8)
    n_bulk = [gen_mono.n_samples(bulk, s)
              for s in gen_mono.durations(bulk, 128)]
    n_music = [gen_mono.n_samples(CFG, s) for s in gen_mono.durations(CFG, 8)]
    return {
        # librispeech_flac.bulk: 128 mono streams, 6.3K frames.
        "bulk": (n_bulk, [16] * 128, 1, True),
        # librispeech_flac.online: one stream.
        "online": (n_bulk[-1:], [16], 1, False),
        # musdb_flac.tracks8: 402 MB over six lane chunks, the longest
        # track 75.9 MB: the card, which chip_smoke.py's phase 16 timed
        # faster than the host's MD5 (PERF.md).
        "musdb": (n_music, gen.depths(CFG, 8), 2, True)}


@pytest.mark.parametrize("shape", list(_shapes()))
def test_placement(shape):
    lengths, bits, C, card = _shapes()[shape]
    assert _on_card(lengths, bits, C) is card


def test_chip_smoke_phase_16_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 16 rehearsed on the CPU at four short tracks,
    the timers stubbed: the twins stand in for F1-F3, so this holds the
    phase's wiring (the request exact under each placement, the rule's
    record, F2 and F3 checked) and its line."""
    import chip_smoke
    from symphonia_tpu_torch.ops import _build

    def counted(fn, *kernels):
        def run(*a, **k):
            for name in kernels:
                _build.LAUNCHES[name] += 1
            return fn(*a, **k)
        return run

    # The twins launch nothing: each wrapper counts its kernels as the
    # card's does, once a call.
    for name, kernels in (
            ("lpc_reconstruct_batch", ("flac_lane_order", "flac_lpc")),
            ("decorrelate_batch", ("flac_decorrelate",)),
            ("md5_lanes", ("flac_md5",))):
        monkeypatch.setattr(fd, name, counted(getattr(fd, name), *kernels))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    info = chip_smoke.phase_musdb_flac(
        tracks=4, seconds=(0.15, 0.3), passes=1, f2_shape=(8, 2, 64),
        md5_lengths=(5000, 9001, 4097), device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "phase 16 musdb_flac: " + json.dumps(info)
    assert info["exact"] == {"mismatched": 0, "md5_ok": True}
    for k in ("rule", "card", "host"):
        assert info["placements"][k]["mismatched"] == 0
        assert info["placements"][k]["md5_ok"]
    rule = info["rule"]
    assert rule["card"] is (rule["total_bytes"] > 4 * rule["max_bytes"])
    assert rule["chunks"] == 1 and rule["chain_bytes"] == rule["max_bytes"]
    assert info["traced"] == dict(
        f3_ms=None, md5_card_bytes=info["message_bytes"] * rule["card"],
        md5_chain_bytes=rule["chain_bytes"] * rule["card"])
    assert info["decorrelate"]["bits_equal_twin"]
    assert all(v["equal_hashlib"] for v in info["md5"].values())
    assert set(info["md5"]) == {"width2", "width3"}
    assert info["bits"].count(24) == 1
    # The first request's launches alone: F2's and F3's twin checks after
    # it are not counted.
    assert {k: info["launches"][k] for k in chip_smoke.MUSDB_PATH} == {
        "flac_lane_order": 1, "flac_lpc": 1, "flac_decorrelate": 1,
        "flac_md5": int(rule["card"])}
