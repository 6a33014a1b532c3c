"""Layer III output placement (M3 ``mp3_place``, ``csrc/mp3_place.cu``) on
the CPU: its plain twin and the kernel's own thread body built for the host
with g++ (the file's code outside ``__CUDACC__``, run over the card's grid)
against numpy's concatenate, transpose and ``_gapless_trim`` of the same
chunks, bit for bit: clips straddling chunks of 1, 2 and 5 granules, trims
longer than a chunk and at every ``delay mod 4``, no trim, a trim that
leaves nothing, clips with no granule; ``decode_many`` against the layout
it had before M3 (the chunks brought down, concatenated, transposed and
trimmed on the host), every result C-contiguous and its own; the counters;
the wrapper's refusals."""

import ctypes
import functools
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from symphonia_tpu_torch import batch, trace
from symphonia_tpu_torch.ops import _build
from symphonia_tpu_torch.ops import mp3_dense as md
from symphonia_tpu_torch.testing import mp3_entropy_streams as ms

SOURCE = _build.CSRC / "mp3_place.cu"


def track(delay, padding):
    return SimpleNamespace(delay=delay, padding=padding)


def gapless_trim(pcm, track, gapless):
    """The gapless trim as ``batch._gapless_trim`` made it before M3."""
    if not gapless:
        return pcm
    total = pcm.shape[1]
    start = min(track.delay, total)
    end = max(start, total - track.padding)
    return pcm[:, start:end]


def host_layout(pcm, counts, tracks, gapless):
    """The layout before M3: the group's PCM [G, C, 576] split by clip,
    each transposed to [C, G_i x 576] and trimmed."""
    C = pcm.shape[1]
    out, pos = [], 0
    for n, t in zip(counts, tracks):
        clip = pcm[pos : pos + n].transpose(1, 0, 2).reshape(C, -1)
        out.append(gapless_trim(clip, t, gapless))
        pos += n
    return out


def group(counts, tracks, C, gapless, seed=0):
    """A group's PCM [G, C, 576] (every sample distinct), its table and
    buffer size, and the layout before M3."""
    rng = np.random.default_rng(seed)
    G = int(sum(counts))
    pcm = rng.standard_normal((G, C, 576)).astype(np.float32)
    bounds = [batch._trim_bounds(576 * n, t, gapless)
              for n, t in zip(counts, tracks)]
    table, size = md.place_table(counts, bounds, C)
    return pcm, table, size, host_layout(pcm, counts, tracks, gapless)


def clips(out, table, C):
    return [out[off : off + C * n].reshape(C, n)
            for _, _, _, n, off in table.tolist()]


def place_twin(pcm, table, size, chunk):
    out = torch.full((size,), float("nan"))
    tab = torch.from_numpy(table)
    for i in range(0, pcm.shape[0], chunk):
        j = min(pcm.shape[0], i + chunk)
        md.mp3_place(torch.from_numpy(np.ascontiguousarray(pcm[i:j])), tab,
                     out, i, md.place_rows(table, i, j))
    return out.numpy()


@functools.lru_cache(maxsize=None)
def host_lib(tmp):
    so = f"{tmp}/libmp3_place_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, str(SOURCE)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mp3_place_host.argtypes = [P, I64, I, I, P, I, I, I, P, I64, I]
    lib.mp3_place_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    return host_lib(str(tmp_path_factory.mktemp("m3")))


def place_host(lib, pcm, table, size, chunk, sms):
    """The kernel's thread body over the card's grid for ``sms``
    multiprocessors, chunk by chunk."""
    out = np.full(size + 4, np.nan, np.float32)[:size]  # 16-byte aligned
    assert out.ctypes.data % 16 == 0
    C = pcm.shape[1]
    for i in range(0, pcm.shape[0], chunk):
        j = min(pcm.shape[0], i + chunk)
        part = np.ascontiguousarray(pcm[i:j])
        k0, k1 = md.place_rows(table, i, j)
        assert lib.mp3_place_host(part.ctypes.data, i, j - i, C,
                                  table.ctypes.data, table.shape[0], k0, k1,
                                  out.ctypes.data, size, sms) == 0
    return out


def bit_equal(got, want):
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# (granules a clip, (delay, padding) a clip, gapless)
CASES = {
    "straddling": ([3, 7, 1, 4], [(529, 300), (576, 1224), (0, 0),
                                  (100, 1000)], True),
    "trim_longer_than_chunks": ([9, 6], [(2 * 576 + 17, 3 * 576 + 5),
                                         (1300, 600)], True),
    "delay_mod_4": ([4, 4, 4, 4, 4], [(1104 + r, 31 + r) for r in range(4)]
                    + [(1, 3)], True),
    "ungapless": ([3, 7, 1, 4], [(529, 300)] * 4, False),
    "trim_leaves_nothing": ([2, 3, 2], [(600, 600), (576 * 3, 1),
                                        (5, 576 * 2)], True),
    "zero_granules": ([0, 3, 0, 0, 5, 0], [(529, 300)] * 6, True),
    "one_clip": ([11], [(1105, 1151)], True),
}


@pytest.mark.parametrize("chunk", [1, 2, 5])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_is_the_host_layout(case, C, chunk):
    counts, trims, gapless = CASES[case]
    pcm, table, size, want = group(counts, [track(*t) for t in trims], C,
                                   gapless)
    out = place_twin(pcm, table, size, chunk)
    assert not np.isnan(out).any()  # every float of the buffer written
    for got, w in zip(clips(out, table, C), want):
        bit_equal(got, w)


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("chunk", [1, 2, 5, 4096])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_body_is_the_twin(host, case, C, chunk, sms):
    counts, trims, gapless = CASES[case]
    pcm, table, size, want = group(counts, [track(*t) for t in trims], C,
                                   gapless, seed=1)
    got = place_host(host, pcm, table, size, chunk, sms)
    bit_equal(got, place_twin(pcm, table, size, min(chunk, 64)))
    for g, w in zip(clips(got, table, C), want):
        bit_equal(g, w)


def test_kernel_body_skips_rows_outside_the_buffer(host):
    pcm, table, size, _ = group([2, 2], [track(0, 0)] * 2, 2, True)
    bad = table.copy()
    bad[1, 4] = size - 1  # clip 1 would end past the buffer
    bad[0, 2] = -1        # clip 0 starts before its first sample
    got = place_host(host, pcm, bad, size, 4, 132)
    assert np.isnan(got).all()
    want = place_twin(pcm, bad, size, 4)
    assert np.isnan(want).all()


@pytest.mark.parametrize("total,delay,padding,gapless", [
    (1152, 529, 300, True), (1152, 529, 300, False), (1152, 2000, 0, True),
    (1152, 600, 600, True), (1152, 0, 5000, True), (0, 10, 10, True),
    (1152, 1152, 0, True), (1152, 0, 1152, True)])
def test_trim_bounds_are_the_gapless_trim(total, delay, padding, gapless):
    pcm = np.arange(2 * total, dtype=np.float32).reshape(2, total)
    t = track(delay, padding)
    start, end = batch._trim_bounds(total, t, gapless)
    assert 0 <= start <= end <= total
    bit_equal(pcm[:, start:end], gapless_trim(pcm, t, gapless))
    bit_equal(batch._gapless_trim(pcm, t, gapless),
              gapless_trim(pcm, t, gapless))


def test_table_and_rows():
    table, size = md.place_table([3, 0, 2], [(5, 1700), (0, 0), (0, 1152)], 2)
    assert table.dtype == np.int64
    assert table.tolist() == [[0, 3, 5, 1695, 0], [3, 0, 0, 0, 3390],
                              [3, 2, 0, 1152, 3390]]
    assert size == 2 * (1695 + 1152)
    assert md.place_rows(table, 0, 2) == (0, 1)
    assert md.place_rows(table, 2, 4) == (0, 3)
    assert md.place_rows(table, 3, 5) == (2, 3)
    assert md.place_table([], np.zeros((0, 2)), 2)[1] == 0


# ---------------------------------------------------------------------------
# decode_many
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def streams():
    s = ms.streams(7)
    # C = 1 and C = 2 clips, LAME-tagged ones (delay 1105: mod 4 = 1) among
    # them, in one call.
    return [s[n] for n in ("lame", "mpeg1_mono", "mpeg2_stereo",
                           "lame_short", "mpeg25_mono", "mpeg1_stereo")]


def before_m3(dec, datas):
    """The layout ``decode_many`` gave before M3, from the same lanes: per
    channel count, the merged chunks' PCM brought down, concatenated,
    transposed and trimmed on the host."""
    readers = [dec._open(MediaSource(d)) for d in datas]
    got = {i: dec._extract(r) for i, r in enumerate(readers)}
    out = {}
    for C in sorted({g[0].shape[1] for g in got.values()}):
        idx = [i for i in got if got[i][0].shape[1] == C]
        spectra, bt, mixed = [np.concatenate([got[i][k] for i in idx])
                              for k in range(3)]
        counts = [got[i][0].shape[0] for i in idx]
        boundary = np.zeros(spectra.shape[0], bool)
        boundary[np.cumsum([0] + counts[:-1])] = True
        parts, ht, st = [], None, None
        for i in range(0, spectra.shape[0], dec.granule_chunk):
            j = i + dec.granule_chunk
            x, b, m, bd = (torch.from_numpy(np.ascontiguousarray(a[i:j]))
                           for a in (spectra, bt, mixed, boundary))
            pcm, ht, st = dec.dense(x, b, m, ht, st, boundary=bd)
            parts.append(pcm.numpy())
        pcm = np.concatenate(parts)
        for i, clip in zip(idx, host_layout(
                pcm, counts, [readers[i].default_track() for i in idx],
                dec.gapless)):
            out[i] = clip
    return [out[i] for i in range(len(datas))]


def MediaSource(data):
    from symphonia_tpu_torch.core.io import MediaSourceStream

    return MediaSourceStream(data)


@pytest.mark.parametrize("gapless", [True, False])
@pytest.mark.parametrize("chunk", [2, 5, 4096])
def test_decode_many_is_the_layout_before(chunk, gapless):
    datas = streams()
    dec = batch.Mp3BatchDecoder(device="cpu", granule_chunk=chunk,
                                gapless=gapless)
    got = dec.decode_many(datas)
    want = before_m3(dec, datas)
    assert {w.shape[0] for w in want} == {1, 2}
    for g, w in zip(got, want):
        bit_equal(g.samples, w)
        assert g.samples.flags.c_contiguous
    # Each result holds its own memory, none a view of another's.
    for a in range(len(got)):
        for b in range(a + 1, len(got)):
            assert not np.shares_memory(got[a].samples, got[b].samples)


def test_the_facade_and_a_lone_clip_take_the_same_layout():
    datas = streams()
    merged = batch.decode_many(datas, device="cpu")
    for d, m in zip(datas, merged):
        one = batch.decode_bytes(d, device="cpu")
        bit_equal(one.samples, m.samples)
        assert one.samples.flags.c_contiguous


def test_counters():
    datas = streams()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = batch.decode_many(datas, device="cpu")
    (r,) = trace.requests()
    trace.reset()
    assert r.counters["mp3_placed_streams"] == len(datas)
    assert r.counters["mp3_placed_bytes"] == sum(o.samples.nbytes
                                                 for o in out)
    # The PCM comes down one clip at a time, trimmed.
    assert r.calls["d2h"] == len(datas)
    assert r.counters["d2h_bytes"] == r.counters["mp3_placed_bytes"]
    batch.decode_many(datas, device="cpu")  # no profiler: nothing stored
    assert trace.requests() == []


def test_the_card_path_with_the_twins_is_the_layout_before(monkeypatch):
    # M0's twin hands the group views of its lanes, as on the card.
    datas = streams()
    dec = batch.Mp3BatchDecoder(device="cpu", granule_chunk=5)
    monkeypatch.setattr(dec, "_entropy", lambda readers: dict(zip(
        readers, dec._card_entropy(list(readers.values())))))
    for g, w in zip(dec.decode_many(datas), before_m3(dec, datas)):
        bit_equal(g.samples, w)
        assert g.samples.flags.c_contiguous


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _args():
    pcm, table, size, _ = group([2, 3], [track(529, 300)] * 2, 2, True)
    return (torch.from_numpy(pcm), torch.from_numpy(table),
            torch.zeros(size), 0, (0, 2))


@pytest.mark.parametrize("change", [
    lambda a: (a[0].double(),) + a[1:],
    lambda a: (a[0], a[1].to(torch.int32)) + a[2:],
    lambda a: a[:2] + (a[2].double(),) + a[3:],
    lambda a: (a[0][:, :, :288],) + a[1:],
    lambda a: (a[0][0],) + a[1:],
    lambda a: (a[0], a[1][:, :4]) + a[2:],
    lambda a: a[:2] + (a[2].view(2, -1),) + a[3:],
    lambda a: (a[0].transpose(0, 1).contiguous().transpose(0, 1),) + a[1:],
    lambda a: (a[0], a[1].t().contiguous().t()) + a[2:],
    lambda a: a[:2] + (torch.zeros(2 * a[2].numel())[::2],) + a[3:],
    lambda a: a[:2] + (torch.zeros(a[2].numel() + 1)[1:],) + a[3:],
    lambda a: a[:2] + (a[2].to("meta"),) + a[3:],
    lambda a: (a[0].to("meta"), a[1].to("meta"), a[2].to("meta")) + a[3:],
    lambda a: a[:4] + ((0, 3),),
    lambda a: a[:4] + ((2, 1),),
    lambda a: a[:3] + (-1,) + a[4:],
], ids=["pcm_f64", "table_i32", "out_f64", "pcm_width", "pcm_2d",
        "table_width", "out_2d", "pcm_strided", "table_strided",
        "out_strided", "out_unaligned", "mixed_devices", "meta_device",
        "rows_past_table", "rows_reversed", "negative_g0"])
def test_wrapper_refuses(change):
    args = _args()
    md.mp3_place(*args)  # the unchanged arguments pass
    with pytest.raises(ValueError):
        md.mp3_place(*change(args))


def test_wrapper_on_the_cpu_launches_nothing():
    _build.reset_launches()
    args = _args()
    md.mp3_place(*args)
    assert _build.LAUNCHES["mp3_place"] == 0


def test_source_note_and_entry_points():
    src = SOURCE.read_text()
    assert "replaces no TPU program" in src
    assert 'extern "C" int mp3_place_launch(' in src
    assert 'extern "C" int mp3_place_attributes(' in src
    assert 'extern "C" int mp3_place_host(' in src
    assert "mp3_place" in _build.KERNELS
    assert "mp3_place_launch" in _build._SIGNATURES
