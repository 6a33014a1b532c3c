"""STREAMINFO MD5 of a merged FLAC dispatch, computed from the decoded lanes
(F3 ``flac_md5``, ``csrc/flac_dense.cu``), on the CPU: the plain twin
against ``hashlib.md5(md5_bytes_of(...))`` at every channel count and
sample width, across frame, block and chunk boundaries and trims; the
kernel's step table against RFC 1321; and ``decode_many``'s choice of the
card or the host, its counters, and its answers."""

import functools
import hashlib
import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from symphonia_tpu_torch import batch, trace
from symphonia_tpu_torch.codecs.flac import md5_bytes_of
from symphonia_tpu_torch.ops import _build
from symphonia_tpu_torch.ops import flac_dense as fd
from symphonia_tpu_torch.testing.flac_builder import (build_flac_file,
                                                      random_walk)


def _want(x, blocks, first, frames, n_hash, bps):
    """hashlib's digest of a stream's samples, as the stitch hands them
    to the host path."""
    pcm = np.concatenate([x[f, :, : blocks[f]]
                          for f in range(first, first + frames)], axis=1)
    return hashlib.md5(md5_bytes_of(pcm[:, :n_hash].astype(np.int64),
                                    bps)).digest()


def _run(x, blocks, first, frames, n_hash, width, cuts):
    """Digests from :class:`LaneMd5`, chunk by chunk at ``cuts``."""
    md5 = fd.LaneMd5(first, frames, n_hash, width, blocks, "cpu")
    edges = [0] + list(cuts) + [x.shape[0]]
    for i, j in zip(edges, edges[1:]):
        md5.update(torch.from_numpy(np.ascontiguousarray(x[i:j])),
                   torch.from_numpy(md5.table(i, j)))
    return md5.digests()


@pytest.mark.parametrize("bps", [8, 12, 16, 20, 24])
@pytest.mark.parametrize("C", [1, 2, 6, 8])
def test_twin_equals_hashlib(C, bps):
    # Four streams: frames of 32 samples (whole 64-byte blocks at one
    # channel of 2 bytes), random block sizes, a one-frame stream of 7
    # samples, and full frames with a partial last one; trims inside the
    # last frame and inside an earlier one; chunks that split streams.
    rng = np.random.default_rng(C * 100 + bps)
    n_max = 96
    frames = [3, 5, 1, 4]
    F = sum(frames)
    blocks = np.concatenate([
        np.full(3, 32), rng.integers(1, n_max + 1, size=5), [7],
        [n_max, n_max, n_max, 19]]).astype(np.int32)
    lim = 1 << (bps - 1)
    x = rng.integers(-lim, lim, size=(F, C, n_max)).astype(np.int32)
    first = np.cumsum([0] + frames[:-1])
    whole = [int(blocks[f : f + n].sum()) for f, n in zip(first, frames)]
    n_hash = [whole[0], whole[1] - 3, whole[2], n_max + 5]
    w = (bps + 7) // 8
    for cuts in ([], [2, 3, 9], list(range(1, F))):
        got = _run(x, blocks, first, frames, n_hash, [w] * 4, cuts)
        for k in range(4):
            assert got[k] == _want(x, blocks, first[k], frames[k],
                                   n_hash[k], bps), (cuts, k)


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_variable_block_sizes_and_every_length_mod_64(w):
    # One stream of many frames of varying block size, hashed at every
    # length from 0 to 130 bytes a side of the pad's 56-byte edge, as one
    # chunk and frame by frame.
    rng = np.random.default_rng(w)
    F, n_max = 12, 40
    blocks = rng.integers(1, n_max + 1, size=F).astype(np.int32)
    x = rng.integers(-2**31, 2**31, size=(F, 1, n_max),
                     dtype=np.int64).astype(np.int32)
    bps = 8 * w
    for n in range(0, min(int(blocks.sum()), 130 // w + 1)):
        for cuts in ([], list(range(1, F))):
            (got,) = _run(x, blocks, [0], [F], [n], [w], cuts)
            assert got == _want(x, blocks, 0, F, n, bps), (n, cuts)


def test_streams_out_of_a_chunk_are_left_alone():
    rng = np.random.default_rng(5)
    blocks = np.full(6, 50, np.int32)
    x = rng.integers(-99, 99, size=(6, 2, 50)).astype(np.int32)
    md5 = fd.LaneMd5([0, 4], [4, 2], [200, 100], [2, 2], blocks, "cpu")
    t = md5.table(0, 2)
    rows = t[: 2 * fd.MD5_ROW].reshape(2, fd.MD5_ROW)
    assert rows[1, 1] == 0  # the second stream: no frame here
    assert rows[0].tolist()[:5] == [0, 2, 100, 2, fd.MD5_FIRST]
    assert t[2 * fd.MD5_ROW :].tolist() == [50, 50]
    md5.update(torch.from_numpy(x[:2].copy()), torch.from_numpy(t))
    before = md5.state[1].clone()
    md5.update(torch.from_numpy(x[2:4].copy()),
               torch.from_numpy(md5.table(2, 4)))
    assert torch.equal(md5.state[1], before)
    rows = md5.table(4, 6)[: 2 * fd.MD5_ROW].reshape(2, fd.MD5_ROW)
    assert rows[0, 1] == 0 and rows[1, 4] == fd.MD5_FIRST | fd.MD5_LAST


def test_wrapper_checks_its_inputs():
    x = torch.zeros((2, 1, 8), dtype=torch.int32)
    table = torch.zeros((1, fd.MD5_ROW), dtype=torch.int32)
    blocks = torch.full((2,), 8, dtype=torch.int32)
    state = torch.zeros((1, fd.MD5_STATE_WORDS), dtype=torch.int32)
    fd.md5_lanes(x, table, blocks, state)
    with pytest.raises(ValueError):
        fd.md5_lanes(x.long(), table, blocks, state)
    with pytest.raises(ValueError):
        fd.md5_lanes(x, table, blocks[:1], state)
    with pytest.raises(ValueError):
        fd.md5_lanes(x, table, blocks, state[:, :4])
    with pytest.raises(ValueError):
        fd.LaneMd5([0], [1], [8], [5], blocks.numpy(), "cpu")


def test_kernel_steps_are_rfc_1321():
    # nvcc is not here: the kernel's tables of constants and message words
    # and its 64 written-out steps are read back and held to the RFC's
    # constants, message words, functions and rotations, and to the
    # rotation of a, b, c, d from step to step.
    src = (_build.CSRC / "flac_dense.cu").read_text()

    def table(name):
        body = re.search(name + r"\[64\] = \{([^}]*)\}", src).group(1)
        return [int(v.strip().rstrip("u"), 0) for v in body.split(",")]

    assert table("kMd5K") == list(fd.MD5_K)
    assert table("kMd5G") == list(fd.MD5_G)
    steps = re.findall(r"MD5_STEP\((\w), (\w), (\w), (\w), (\w), (\d+), "
                       r"(\d+)\);", src)
    assert len(steps) == 64
    for i, (fn, a, b, c, d, j, s) in enumerate(steps):
        assert fn == "FGHI"[i // 16] and int(j) == i
        r = (-i) % 4
        assert (a, b, c, d) == tuple("abcd"[(r + k) % 4] for k in range(4))
        assert int(s) == fd.MD5_S[i]
    assert fd.MD5_K[0] == 0xD76AA478 and fd.MD5_K[63] == 0xEB86D391


# ---------------------------------------------------------------------------
# decode_many
# ---------------------------------------------------------------------------


def _flac(n, seed, ch=1, bps=16, block=128, patch=None):
    """A FLAC stream of n samples a channel; ``patch(chans, data)`` may
    rewrite its bytes."""
    chans = random_walk(n, bps, seed=seed, ch=ch)
    data = build_flac_file(chans, bps=bps, block_size=block,
                           stereo_mode="mid_side" if ch == 2
                           else "independent", kind="fixed", order=2)
    return patch(chans, data) if patch else data


# STREAMINFO's place in a file with no other metadata block.
_SI = 8
_TOTAL = slice(_SI + 13, _SI + 18)  # bps's low 4 bits, the 36-bit total
_MD5 = slice(_SI + 18, _SI + 34)


def _set_md5(data: bytes, digest: bytes) -> bytes:
    return data[: _MD5.start] + digest + data[_MD5.stop :]


def _set_total(data: bytes, n: int) -> bytes:
    b = bytearray(data)
    v = int.from_bytes(b[_TOTAL], "big")
    v = (v & ~((1 << 36) - 1)) | n
    b[_TOTAL] = v.to_bytes(5, "big")
    return bytes(b)


def _md5(chans, bps, n=None):
    pcm = np.stack(chans)[:, :n]
    return hashlib.md5(md5_bytes_of(pcm, bps)).digest()


@functools.lru_cache(maxsize=None)
def group(kind):
    """24 short streams of alike length (the card's rule takes them)."""
    ch, bps = {"mono": (1, 16), "stereo24": (2, 24), "mono8": (1, 8)}[kind]
    return tuple(_flac(700 + 37 * s, s, ch=ch, bps=bps, block=160 + 16 * s)
                 for s in range(24))


@functools.lru_cache(maxsize=None)
def pool():
    """128 streams whose lengths have the LibriSpeech pool's shape
    (Beta(3, 5.72) quantiles on [1, 35] s) at 1/100 of its durations."""
    a, b = 3.0, 5.72
    t = (np.arange(1 << 16) + 0.5) / (1 << 16)
    cdf = np.cumsum(t ** (a - 1) * (1 - t) ** (b - 1))
    q = np.interp((np.arange(128) + 0.5) / 128, cdf / cdf[-1], t)
    n = np.round((1 + 34 * q) * 160).astype(int)
    return tuple(_flac(int(k), 1000 + s, block=256)
                 for s, k in enumerate(n))


def traced(datas, **kw):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = batch.decode_many(datas, device="cpu", **kw)
    (r,) = trace.requests()
    trace.reset()
    return outs, r.counters


def test_rule():
    assert not batch._md5_on_card([])
    assert not batch._md5_on_card([1000])
    n = [2 * k for k in (16000, 80000, 560000)]
    assert batch._md5_on_card(n * 40) and not batch._md5_on_card(n[:2])


@pytest.mark.parametrize("kind", ["mono", "stereo24", "mono8"])
def test_group_verifies_on_the_card(kind):
    outs, c = traced(group(kind), verify=True)
    assert [o.md5_ok for o in outs] == [True] * 24
    assert c["md5_card_streams"] == 24 and "md5_host_streams" not in c
    # The same PCM as the host path gives.
    for o, d in zip(outs, group(kind)):
        (h,) = batch.decode_many([d], device="cpu", verify=True)
        np.testing.assert_array_equal(o.samples, h.samples)
        assert h.md5_ok is True


def test_one_stream_verifies_on_the_host():
    outs, c = traced(group("mono")[:1], verify=True)
    assert outs[0].md5_ok is True
    assert c["md5_host_streams"] == 1 and "md5_card_streams" not in c


def test_pool_shaped_streams_verify_on_the_card():
    outs, c = traced(pool(), verify=True)
    assert all(o.md5_ok is True for o in outs)
    assert c["md5_card_streams"] == 128 and "md5_host_streams" not in c


@pytest.mark.parametrize("lane_chunk", [4, 64])
def test_streams_across_lane_chunks(monkeypatch, lane_chunk):
    # Chunks of 2 or 32 stereo frames, 4 or 64 mono ones: most streams
    # span two or more. F3 runs once a chunk (untraced: the profiler
    # would record each of the twin's tensor operations).
    calls = []
    real = fd.md5_lanes
    monkeypatch.setattr(fd, "md5_lanes",
                        lambda x, *a: (calls.append(x.shape[0]),
                                       real(x, *a))[1])
    stereo, mono = group("stereo24")[:10], group("mono")[:10]
    dec = batch.FlacBatchDecoder(device="cpu", verify=True,
                                 lane_chunk=lane_chunk)
    outs = dec.decode_many(stereo + mono)
    assert [o.md5_ok for o in outs] == [True] * 20
    frames = [sum(-(-(700 + 37 * s) // (160 + 16 * s)) for s in range(10))]
    frames = frames * 2
    chunks = sum(-(-F // max(1, lane_chunk // C))
                 for F, C in zip(frames, (2, 1)))
    assert len(calls) == chunks and sum(calls) == sum(frames)
    assert lane_chunk > 8 or chunks > 20


def _flipped(chans, data):
    bad = [c.copy() for c in chans]
    bad[0][len(bad[0]) // 2] += 1
    return _set_md5(data, _md5(bad, 16))


def test_a_flipped_sample_reads_false_and_zero_reads_none():
    datas = list(group("mono"))
    datas[3] = _flac(900, 77, patch=_flipped)
    datas[5] = _set_md5(datas[5], bytes(16))
    outs, c = traced(datas, verify=True)
    want = [True] * 24
    want[3], want[5] = False, None
    assert [o.md5_ok for o in outs] == want
    assert c["md5_card_streams"] == 23 and "md5_host_streams" not in c


def test_trims_and_unknown_lengths():
    # STREAMINFO's total shorter than the frames hold (hashed to it) and
    # 0 (unknown: every decoded sample hashed).
    def short(chans, data):
        n = len(chans[0]) - 11
        return _set_md5(_set_total(data, n), _md5(chans, 16, n))

    datas = list(group("mono"))
    datas[2] = _flac(1000, 91, patch=short)
    datas[7] = _set_total(datas[7], 0)
    outs, c = traced(datas, verify=True)
    assert [o.md5_ok for o in outs] == [True] * 24
    assert outs[2].samples.shape[1] == 1000 - 11
    assert c["md5_card_streams"] == 24


def test_verify_false_launches_and_uploads_nothing(monkeypatch):
    calls = []
    real = fd.md5_lanes
    monkeypatch.setattr(fd, "md5_lanes",
                        lambda *a: (calls.append(1), real(*a))[1])
    outs, c = traced(group("mono"), verify=False)
    assert not calls and all(o.md5_ok is None for o in outs)
    assert set(c) == {"h2d_bytes", "d2h_bytes", "flac_lanes",
                      "flac_lane_samples"}
    _, c2 = traced(group("mono"), verify=True)
    assert calls == [1]
    # The table (a row of 8 int32 a stream and each frame's block size)
    # goes up, the digests (16 bytes a stream) come down.
    F = sum(-(-(700 + 37 * s) // (160 + 16 * s)) for s in range(24))
    assert c2["h2d_bytes"] - c["h2d_bytes"] == 4 * (8 * 24 + F)
    assert c2["d2h_bytes"] - c["d2h_bytes"] == 16 * 24


# ---------------------------------------------------------------------------
# The lane chunks' layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_chunk_runs_spread_each_stream_in_proportion(seed):
    """Every chunk but the last holds ``per_chunk`` frames, each stream's
    runs add up to its frames, and each run lies within one frame of the
    stream's share of its chunk, at random shapes."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        F = rng.integers(0 if seed else 1, 400, size=rng.integers(1, 13))
        F[rng.integers(len(F))] += 1
        per_chunk = int(rng.integers(1, 300))
        runs = batch._chunk_runs(F, per_chunk)
        total = int(F.sum())
        chunks = -(-total // per_chunk)
        size = np.minimum(per_chunk, total - per_chunk * np.arange(chunks))
        assert runs.shape == (len(F), chunks) and runs.min() >= 0
        np.testing.assert_array_equal(runs.sum(1), F)
        np.testing.assert_array_equal(runs.sum(0), size)
        assert np.abs(runs - np.outer(F, size) / total).max() < 1


def test_chunk_runs_keep_one_chunk_and_one_stream_as_they_were():
    np.testing.assert_array_equal(batch._chunk_runs([5, 0, 7], 12),
                                  [[5], [0], [7]])
    np.testing.assert_array_equal(batch._chunk_runs([23], 5),
                                  [[5, 5, 5, 5, 3]])


def _captured(monkeypatch):
    """The groups ``_dispatch_merged`` takes, the merged arrays and frame
    owners ``_decode_packed_chunked`` takes, and F3's (table, blocks) at
    each launch."""
    seen = dict(groups=[], merged=[], f3=[])
    dispatch = batch.FlacBatchDecoder._dispatch_merged
    chunked = batch.FlacBatchDecoder._decode_packed_chunked
    real = fd.md5_lanes
    monkeypatch.setattr(batch.FlacBatchDecoder, "_dispatch_merged",
                        lambda self, C, g, r: (seen["groups"].append(g),
                                               dispatch(self, C, g, r))[1])
    monkeypatch.setattr(batch.FlacBatchDecoder, "_decode_packed_chunked",
                        lambda self, *a: (seen["merged"].append(a),
                                          chunked(self, *a))[1])
    monkeypatch.setattr(fd, "md5_lanes", lambda x, t, b, s: (
        seen["f3"].append((t.numpy().copy(), b.numpy().copy())),
        real(x, t, b, s))[1])
    return seen


def _concatenated(group):
    """The merged arrays and block sizes as the streams' plain
    concatenation lays them out, one stream after another."""
    C = int(group[0][2]["C"])
    n_max = max(int(p["n_max"]) for _, _, p, _ in group)
    out = {k: [] for k in ("res", "coefs", "order", "shift", "wasted",
                           "assign", "blocks")}
    for _, _, p, blocks in group:
        F, n = int(p["F"]), int(p["n_max"])
        res = np.asarray(p["res"]).reshape(F, C, n)
        res = np.pad(res, ((0, 0), (0, 0), (0, n_max - n)))
        out["res"].append(res.reshape(F * C, n_max))
        out["coefs"].append(np.asarray(p["coefs"]).reshape(F * C, 32))
        for k in ("order", "shift", "wasted"):
            out[k].append(np.asarray(p[k]).reshape(F * C))
        out["assign"].append(np.asarray(p["assign"])[:F])
        out["blocks"].append(np.asarray(blocks))
    return {k: np.concatenate(v) for k, v in out.items()}


def _concatenated_tables(group, width, per_chunk):
    """F3's table at each lane chunk of the plain concatenation: a row a
    stream, (first frame in the chunk, frames, samples to hash, width,
    flags), then the chunk's block sizes."""
    frames = np.array([int(p["F"]) for _, _, p, _ in group])
    blocks = np.concatenate([b for *_, b in group])
    cum = np.concatenate([[0], np.cumsum(blocks)])
    first = np.cumsum(frames) - frames
    end = first + frames
    n_hash = np.array([min(int(b.sum()), si.n_samples) for _, si, _, b
                       in group])
    out = []
    for i in range(0, len(blocks), per_chunk):
        j = min(len(blocks), i + per_chunk)
        lo, hi = np.clip(first, i, j), np.clip(end, i, j)
        rows = np.zeros((len(group), 8), np.int32)
        rows[:, 0], rows[:, 1], rows[:, 3] = lo - i, hi - lo, width
        rows[:, 2] = (np.minimum(n_hash, cum[hi] - cum[first])
                      - np.minimum(n_hash, cum[lo] - cum[first]))
        rows[:, 4] = (fd.MD5_FIRST * ((first >= i) & (first < j))
                      + fd.MD5_LAST * ((end > i) & (end <= j)))
        out.append((rows, blocks[i:j]))
    return out


@pytest.mark.parametrize("shape", ["one_chunk", "one_stream"])
def test_one_chunk_or_one_stream_keeps_the_concatenation(monkeypatch, shape):
    """A group in one lane chunk, or of one stream over several, is laid
    out as the streams' plain concatenation: the merged arrays, the block
    sizes and every F3 table byte for byte."""
    seen = _captured(monkeypatch)
    monkeypatch.setattr(batch, "_md5_on_card", lambda parts: True)
    if shape == "one_chunk":
        datas, lane_chunk = group("stereo24")[:10], 8192
    else:
        datas, lane_chunk = [_flac(5000, 3, ch=2, bps=24, block=160)], 16
    dec = batch.FlacBatchDecoder(device="cpu", verify=True,
                                 lane_chunk=lane_chunk)
    outs = dec.decode_many(datas)
    assert all(o.md5_ok is True for o in outs)
    (g,) = seen["groups"]
    (merged, take, owner, streams, _), = seen["merged"]
    want = _concatenated(g)
    for k in ("res", "coefs", "order", "shift", "wasted", "assign"):
        assert merged[k].dtype == want[k].dtype
        assert merged[k].tobytes() == want[k].tobytes(), k
    assert merged["F"] == len(want["blocks"]) == len(owner)
    np.testing.assert_array_equal(take, want["blocks"])  # nothing trimmed
    np.testing.assert_array_equal(
        owner, np.repeat(np.arange(len(g)), [int(p["F"]) for *_, p, _ in g]))
    tables = _concatenated_tables(g, 3, lane_chunk // 2)
    assert len(seen["f3"]) == len(tables) == (1 if shape == "one_chunk"
                                              else 4)
    for (t, b), (rows, blocks) in zip(seen["f3"], tables):
        assert t.tobytes() == rows.tobytes()
        assert b.tobytes() == blocks.astype(np.int32).tobytes()


@pytest.mark.parametrize("lane_chunk", [8, 64])
def test_counters_read_the_chain(monkeypatch, lane_chunk):
    """Under trace, ``md5_card_bytes`` is every hashed byte and
    ``md5_chain_bytes`` each launch's largest row: the longest stream's
    bytes, and at most a frame more a chunk."""
    monkeypatch.setattr(batch, "_md5_on_card", lambda parts: True)
    datas = group("stereo24")[:10]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = batch.FlacBatchDecoder(device="cpu", verify=True,
                                      lane_chunk=lane_chunk).decode_many(
                                          datas)
    # A decoder called directly: its opens are requests of their own.
    c = sum((Counter(r.counters) for r in trace.requests()), Counter())
    trace.reset()
    assert [o.md5_ok for o in outs] == [True] * 10
    hashed = [o.samples.size * 3 for o in outs]
    frame = max(160 + 16 * s for s in range(10)) * 2 * 3
    frames = sum(-(-(700 + 37 * s) // (160 + 16 * s)) for s in range(10))
    chunks = -(-frames // (lane_chunk // 2))
    assert chunks == (11 if lane_chunk == 8 else 2)
    assert c["md5_card_bytes"] == sum(hashed)
    assert (max(hashed) <= c["md5_chain_bytes"]
            <= max(hashed) + chunks * frame)
