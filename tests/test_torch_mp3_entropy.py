"""Layer III entropy on the card (M0 ``mp3_entropy``, ``csrc/mp3_entropy.cu``)
on the CPU: its plain twin (``ops/mp3_entropy.py``, frame by frame through
the port's ``codecs/mpa_layer3.py``) and the kernel's own frame body built
for the host with g++ (the file's code outside ``__CUDACC__``), each
against ``native.mp3_extract`` on the test encoders' streams of every kind
(``testing/mp3_entropy_streams.py``), and the host build on streams with
bits flipped at seeded places; the host planning (frame and clip tables,
the reservoir's underflow rule, the per-clip fallback); ``decode_many``'s
paths and counters; the wrapper's refusals; the tables against the
kernel's layout."""

import ctypes
import functools
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from symphonia_tpu_torch import batch, trace
from symphonia_tpu_torch.core.formats import FormatOptions
from symphonia_tpu_torch.core.io import MediaSourceStream
from symphonia_tpu_torch.formats.mpa import MpaReader
from symphonia_tpu_torch.ops import _build
from symphonia_tpu_torch.ops import mp3_entropy as me
from symphonia_tpu_torch.testing import mp3_entropy_streams as ms

SOURCE = _build.CSRC / "mp3_entropy.cu"


@functools.lru_cache(maxsize=None)
def streams():
    return ms.streams(7)


NAMES = ("mpeg1_mono", "mpeg1_stereo", "mpeg1_linbits", "mpeg1_table23",
         "mpeg1_table13", "mpeg1_intensity", "mpeg1_intensity_ms",
         "mpeg2_mono", "mpeg2_stereo", "mpeg2_intensity",
         "mpeg2_intensity_ms", "mpeg25_stereo", "mpeg25_mono", "mpeg1_crc",
         "mpeg2_crc", "lame", "lame_plain", "lame_short", "lame_mixed",
         "lame_intensity", "lame_underflow", "lame_flipped0",
         "lame_flipped1", "lame_flipped2", "lame_flipped3", "mpeg2_flipped")


def readers(datas):
    return [MpaReader(MediaSourceStream(d), FormatOptions(enable_gapless=True))
            for d in datas]


def plan_of(rs):
    pl = me.plan([r._offsets for r in rs], [r._sizes for r in rs],
                 [r.header.n_channels for r in rs],
                 [2 if r.header.is_mpeg1 else 1 for r in rs])
    return pl, pl.pack([r._buf for r in rs])


def host_build(tmp):
    """The kernel's source compiled for the host: mp3_entropy_host, its
    frame body over every frame in turn."""
    so = f"{tmp}/libmp3_entropy_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, str(SOURCE)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.mp3_entropy_host.argtypes = [P, I64, P, I64, P, ctypes.c_int, P, P,
                                     P, P, I64, P, P, P]
    lib.mp3_entropy_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    return host_build(str(tmp_path_factory.mktemp("m0")))


def run_host(lib, pl, data):
    F, L = pl.frames.shape[0], pl.n_lanes
    spectra = np.zeros((L, 576), np.float32)
    bt = np.zeros(L, np.int32)
    mixed = np.zeros(L, np.uint8)
    status = np.zeros(F, np.int32)
    t = me.tables()
    assert lib.mp3_entropy_host(
        data.ctypes.data, data.size, pl.frames.ctypes.data, F,
        pl.clips.ctypes.data, pl.clips.shape[0], t["huff"].ctypes.data,
        t["fl"].ctypes.data, t["it"].ctypes.data, spectra.ctypes.data, L,
        bt.ctypes.data, mixed.ctypes.data, status.ctypes.data) == 0
    return spectra, bt, mixed, status


def run_twin(pl, data):
    out = me.mp3_entropy(torch.from_numpy(data), torch.from_numpy(pl.frames),
                         torch.from_numpy(pl.clips), me.device_tables("cpu"),
                         pl.n_lanes)
    return [o.numpy() for o in out]


def test_names_cover_the_streams():
    assert set(NAMES) == set(streams())


@pytest.mark.parametrize("name", NAMES)
def test_plain_twin_equals_native(name):
    rs = readers([streams()[name]])
    pl, data = plan_of(rs)
    res = ms.compare(pl, ms.expected(rs), *run_twin(pl, data))
    assert res["ok"], res
    assert res["values"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_kernel_body_on_the_host_equals_native(host, name):
    rs = readers([streams()[name]])
    pl, data = plan_of(rs)
    res = ms.compare(pl, ms.expected(rs), *run_host(host, pl, data))
    assert res["ok"], res


def test_kernel_body_on_the_host_all_clips_in_one_launch(host):
    rs = readers(list(streams().values()))
    pl, data = plan_of(rs)
    res = ms.compare(pl, ms.expected(rs), *run_host(host, pl, data))
    assert res["ok"], res
    assert res["clips"] == len(NAMES)


@functools.lru_cache(maxsize=None)
def fuzz_bases():
    rng = np.random.default_rng(5)
    return (ms.lame(100, transient_every=4), ms.lame(101),
            ms.lsf_stream(rng, 30, 2, 2.0, mode_ext=3,
                          scalefac_compress=300),
            ms.mpeg1_stream(rng, 30, 2, mode_ext=1, big_table=24,
                            big_max=30))


@pytest.mark.parametrize("seed", range(16))
def test_kernel_body_on_the_host_flipped_bits(host, seed):
    # Side info and main data flipped: headers and side info that fail
    # (-2), scalefactors and Huffman data that fail (-5), reads past the
    # buffer's end, and every status agreeing with the host's.
    bases = fuzz_bases()
    data = ms.flipped(bases[seed % len(bases)], seed, 5 + 7 * seed,
                      (0.3, 0.6, 0.9)[seed % 3])
    rs = readers([data])
    pl, packed = plan_of(rs)
    want = ms.expected(rs)
    res = ms.compare(pl, want, *run_host(host, pl, packed))
    assert res["ok"], res


def test_flipped_streams_reach_every_failure():
    # The seeds above give frames of status -2, -4 and -5 as well as 0.
    bases = fuzz_bases()
    seen = set()
    for seed in range(16):
        data = ms.flipped(bases[seed % len(bases)], seed, 5 + 7 * seed,
                          (0.3, 0.6, 0.9)[seed % 3])
        seen |= set(ms.expected(readers([data]))[0]["status"].tolist())
    assert {0, -2, -5} <= seen


# ---------------------------------------------------------------------------
# Host planning
# ---------------------------------------------------------------------------


def test_plan_tables():
    s = streams()
    datas = [s["lame"], s["mpeg1_mono"], s["mpeg2_stereo"], s["mpeg25_mono"],
             s["lame_short"]]
    rs = readers(datas)
    pl, data = plan_of(rs)
    F = sum(len(r._offsets) for r in rs)
    assert pl.frames.shape == (F, 2) and pl.frames.dtype == np.int64
    assert pl.clips.dtype == np.int64 and pl.clips.shape == (5, 5)
    # The clips table in frame order, covering [0, F), the mono clips'
    # lanes first; each clip's lanes frames x granules x channels.
    first = pl.clips[:, 0]
    assert first[0] == 0 and np.all(np.diff(first) == pl.clips[:-1, 1])
    assert first[-1] + pl.clips[-1, 1] == F
    assert list(pl.clips[:, 3]) == [1, 1, 2, 2, 2]
    assert np.all(np.diff(pl.clips[:, 2]) == (pl.clips[:, 1] * pl.clips[:, 3]
                                              * pl.clips[:, 4])[:-1])
    assert pl.n_lanes == int(pl.lanes.sum())
    for i, r in enumerate(rs):
        gpf = 2 if r.header.is_mpeg1 else 1
        assert pl.lanes[i] == len(r._offsets) * gpf * r.header.n_channels
        for k in range(len(r._offsets)):
            off, size = pl.frames[pl.first[i] + k]
            o, n = int(r._offsets[k]), int(r._sizes[k])
            assert size == n
            assert data[off : off + size].tobytes() == r._buf[o : o + n]
    # Only the spans from each clip's first frame to its last go up.
    assert data.size == sum(int(r._offsets[-1] + r._sizes[-1] - r._offsets[0])
                            for r in rs)


def test_plan_of_clips_without_frames():
    rs = readers([streams()["mpeg1_mono"]])
    pl = me.plan([rs[0]._offsets, np.zeros(0, np.int64)],
                 [rs[0]._sizes, np.zeros(0, np.int64)], [1, 2], [2, 2])
    assert pl.frames.shape[0] == len(rs[0]._offsets)
    assert list(pl.lanes) == [2 * len(rs[0]._offsets), 0]
    assert pl.clean(np.zeros(pl.frames.shape[0], np.int32)).all()
    empty = me.plan([], [], [], [])
    assert empty.frames.shape == (0, 2) and empty.n_lanes == 0


def _main_data_lengths(r):
    from symphonia_tpu_torch.codecs.mpa_common import parse_header

    out = []
    for o, n in zip(r._offsets.tolist(), r._sizes.tolist()):
        h = parse_header(int.from_bytes(r._buf[o : o + 4], "big"))
        out.append(h.frame_size - 4 - (2 if h.has_crc else 0)
                   - h.side_info_len())
    return np.array(out)


@pytest.mark.parametrize("cut", [1, 3, 6])
def test_underflow_rule_is_the_main_data_prefix(cut):
    # Where every frame's side info parses, a frame underflows (-4) where
    # its main_data_begin exceeds the main data of the frames before it,
    # as M0 and its twin reckon it; the host agrees.
    data = ms.cut_start(ms.lame(40 + cut), cut)
    r = readers([data])[0]
    prefix = np.cumsum(_main_data_lengths(r)) - _main_data_lengths(r)
    mdb = []
    for o in r._offsets.tolist():
        mdb.append(int.from_bytes(r._buf[o + 4 : o + 6], "big") >> 7)
    rule = np.where(np.array(mdb) > prefix, -4, 0)
    native_status = ms.expected([r])[0]["status"]
    assert np.array_equal(native_status, rule)
    assert (rule == -4).any()
    pl, packed = plan_of([r])
    assert np.array_equal(run_twin(pl, packed)[3], rule)


def test_clean_is_the_per_clip_fallback():
    s = streams()
    rs = readers([s["lame"], s["lame_underflow"], s["mpeg2_mono"],
                  s["lame_flipped1"]])
    pl, data = plan_of(rs)
    status = run_twin(pl, data)[3]
    want = [bool((w["status"] == 0).all()) for w in ms.expected(rs)]
    assert list(pl.clean(status)) == want == [True, False, True, False]


# ---------------------------------------------------------------------------
# decode_many
# ---------------------------------------------------------------------------


def _batch():
    s = streams()
    return [s[n] for n in ("lame", "mpeg1_mono", "lame_underflow",
                           "mpeg2_stereo", "lame_short", "mpeg25_mono",
                           "lame_flipped1", "mpeg1_intensity")]


def _counters(fn):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    try:
        counters = {}
        for r in trace.requests():
            for k, v in r.counters.items():
                counters[k] = counters.get(k, 0) + v
        return out, counters
    finally:
        trace.reset()


def test_decode_many_on_the_cpu_extracts_on_the_host():
    _build.reset_launches()
    datas = _batch()
    out, c = _counters(lambda: batch.decode_many(datas, device="cpu"))
    assert _build.LAUNCHES["mp3_entropy"] == 0
    assert c["mp3_host_streams"] == len(datas)
    assert "mp3_card_streams" not in c and "mp3_card_lanes" not in c
    for o, d in zip(out, datas):
        one = batch.decode_bytes(d, device="cpu")
        assert np.array_equal(o.samples, one.samples)


def test_the_card_path_with_the_twin_equals_the_host_path(monkeypatch):
    # The card's entropy stage (one M0 launch for the call, the rejected
    # clips per file) run on the CPU with M0's twin, its lanes left as
    # tensors as on the card: the same samples, bit for bit.
    datas = _batch()
    dec = batch.Mp3BatchDecoder(device="cpu")
    want = dec.decode_many(datas)
    monkeypatch.setattr(dec, "_entropy", lambda readers: dict(zip(
        readers, dec._card_entropy(list(readers.values())))))
    def card():
        with trace.span("decode_many"):  # the root batch.decode_many opens
            return dec.decode_many(datas)

    got, c = _counters(card)
    for g, w in zip(got, want):
        assert g.sample_rate == w.sample_rate
        assert np.array_equal(g.samples, w.samples)
    rs = readers(datas)
    assert c["mp3_card_streams"] == 6 and c["mp3_host_streams"] == 2
    assert c["mp3_card_lanes"] == sum(
        len(r._offsets) * (2 if r.header.is_mpeg1 else 1)
        * r.header.n_channels for r in rs)
    assert c["mp3_card_bytes"] == sum(int(r._sizes.sum()) for r in rs)


# ---------------------------------------------------------------------------
# The wrapper and the tables
# ---------------------------------------------------------------------------


def _inputs():
    rs = readers([streams()["mpeg1_stereo"]])
    pl, data = plan_of(rs)
    return (torch.from_numpy(data), torch.from_numpy(pl.frames),
            torch.from_numpy(pl.clips), me.device_tables("cpu"), pl.n_lanes)


def _bad_tables(t):
    t = dict(t)
    t["fl"] = t["fl"].double()
    return t


@pytest.mark.parametrize("change", [
    lambda a: (a[0].to(torch.int8),) + a[1:],
    lambda a: (a[0], a[1].to(torch.int32)) + a[2:],
    lambda a: (a[0], a[1].reshape(-1)) + a[2:],
    lambda a: a[:2] + (a[2][:, :4],) + a[3:],
    lambda a: a[:2] + (a[2][:0],) + a[3:],
    lambda a: a[:3] + (_bad_tables(a[3]), a[4]),
    lambda a: a[:4] + (-1,),
    lambda a: (a[0].to("meta"),) + a[1:],
    lambda a: (a[0], a[1].to("meta")) + a[2:],
], ids=["data_type", "frames_type", "frames_shape", "clips_shape",
        "no_clips", "tables_type", "lanes", "data_device", "frames_device"])
def test_wrapper_refuses(change):
    with pytest.raises(ValueError):
        me.mp3_entropy(*change(_inputs()))


def test_wrapper_takes_the_twin_on_the_cpu():
    _build.reset_launches()
    spectra, bt, mixed, status = me.mp3_entropy(*_inputs())
    assert _build.LAUNCHES["mp3_entropy"] == 0
    assert spectra.dtype == torch.float32 and spectra.shape[1] == 576
    assert bt.dtype == torch.int32 and mixed.dtype == torch.bool
    assert status.dtype == torch.int32 and (status == 0).all()


def _constants():
    """The kernel's constexpr table offsets and sizes, from its source."""
    src = SOURCE.read_text()
    out = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        expr = re.sub(r"//.*", "", expr)
        out[name] = eval(expr, {}, dict(out))
    return out


def test_tables_follow_the_kernels_layout():
    k = _constants()
    t = me.tables()
    assert t["huff"].dtype == np.int16 and t["huff"].size % 128 == 0
    assert t["huff"].size >= k["kL2Base"]
    assert t["fl"].size == k["kSqrtHalf"] + 1
    assert t["it"].size == k["kSampleRate"] + 9
    it = t["it"]
    assert list(it[k["kSampleRate"] : k["kSampleRate"] + 9]) == [
        44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000]
    assert it[k["kRateL3"] + 13] == 256000 and it[k["kRateLsf"] + 8] == 64000
    assert it[k["kLinbits"] + 31] == 13 and it[k["kPretab"] + 17] == 3
    widths = []
    for r in range(9):
        row = it[k["kSfbShort"] + 40 * r : k["kSfbShort"] + 40 * r + 40]
        widths.append(int(np.diff(row).max()))
    assert max(widths) == k["kMaxShortWidth"]


def test_huffman_tables_decode_every_code():
    from symphonia_tpu_torch.codecs.mpa_common import tables

    huff = me.tables()["huff"].view(np.uint16)
    t = tables()
    for ti, name in [(n, n) for n in (1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                                       15)] + [(16, 16), (17, 24)]:
        codes, bits = t[f"codes_{name}"], t[f"bits_{name}"]
        wrap = {4: 2, 9: 3, 16: 4, 36: 6, 64: 8, 256: 16}[len(codes)]
        for i, (code, ln) in enumerate(zip(codes.tolist(), bits.tolist())):
            top = code << (19 - ln)  # the next 19 bits, zero-padded
            e = int(huff[(ti << 12) + (top >> 7)])
            if e & 0x8000:
                e = int(huff[(20 << 12) + ((e & 0x7FFF) << 7) + (top & 127)])
            assert (e >> 8, e & 0xFF) == (ln, ((i // wrap) << 4) | (i % wrap))
    for ti, sfx in ((18, "a"), (19, "b")):
        for i, (code, ln) in enumerate(zip(t[f"quads_codes_{sfx}"].tolist(),
                                           t[f"quads_bits_{sfx}"].tolist())):
            e = int(huff[(ti << 12) + (code << (12 - ln))])
            assert (e >> 8, e & 0xFF) == (ln, i)


def test_float_tables_are_libm_rounded_once():
    fl = me.tables()["fl"]
    k = _constants()
    for i in (0, 1, 2, 15, 16, 1000, 8206):
        assert fl[k["kPow43"] + i] == np.float32(math.pow(i, 4.0 / 3.0))
    for e in (-390, -100, -1, 0, 1, 45):
        assert fl[k["kGain"] + e + 390] == np.float32(math.pow(2.0, e / 4))
    assert fl[k["kSqrtHalf"]] == np.float32(1 / math.sqrt(2.0))
