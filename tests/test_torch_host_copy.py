"""The port's own host stage against the reference package it was copied
from: every copied module is the original apart from its import lines and
data paths, the tables (the decoder's constants) are equal, probing the
repository's container fixtures gives equal tracks and packets, and the
port's test encoders write the same bytes as the repository's."""

import ast
import dataclasses
import difflib
import enum
import importlib
import importlib.util
import inspect
import pathlib
import re

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "symphonia_tpu"
PORT = ROOT / "symphonia_tpu_torch"

# Whole modules copied under the same names.
_HOST = sorted(str(p.relative_to(REF)) for d in ("core", "formats", "metadata",
                                                  "common", "codecs")
               for p in (REF / d).rglob("*.py"))
COPIED = ([(f"symphonia_tpu/{r}", f"symphonia_tpu_torch/{r}") for r in _HOST]
          + [("symphonia_tpu/native.py", "symphonia_tpu_torch/native.py"),
             ("symphonia_tpu/ops/imdct_host.py",
              "symphonia_tpu_torch/ops/imdct_host.py")]
          + [(f"tests/{n}", f"symphonia_tpu_torch/testing/{n}")
             for n in ("flac_builder.py", "mp3_builder.py", "aac_builder.py",
                       "vorbis_builder.py", "alac_builder.py")])

# A line outside the import statements may differ only where it names a
# package (``__import__``'s argument) or the data directory.
_PATH_LINE = re.compile(r'symphonia_tpu|"data"')


def _outside_imports(src: str):
    skip = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            skip.update(range(node.lineno, node.end_lineno + 1))
    return [l for i, l in enumerate(src.splitlines(), 1) if i not in skip]


def _assert_verbatim(ref_src: str, port_src: str):
    a, b = _outside_imports(ref_src), _outside_imports(port_src)
    changed = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            changed += a[i1:i2] + b[j1:j2]
    assert all(_PATH_LINE.search(l) for l in changed), changed
    assert len(changed) <= 4, changed


@pytest.mark.parametrize("ref,port", COPIED, ids=[c[1] for c in COPIED])
def test_copied_module_is_verbatim(ref, port):
    _assert_verbatim((ROOT / ref).read_text(), (ROOT / port).read_text())


# Parts of modules copied: (reference module, port module, names).
PARTS = [
    ("symphonia_tpu.ops.mp3_dense", "symphonia_tpu_torch.ops.mp3_dense",
     ("imdct_windows", "hybrid_matrices", "antialias_coeffs",
      "polyphase_matrix", "synthesis_window", "freq_inversion_mask",
      "_polyphase_combined_matrix", "_synth_sel_idx", "antialias_np",
      "hybrid_synthesis_np", "polyphase_response_np", "GranuleDenseState",
      "granule_dense_np")),
    ("symphonia_tpu.ops.aac_dense", "symphonia_tpu_torch.ops.aac_dense",
     ("_ola_tables", "window_ola_chain")),
    ("symphonia_tpu.ops.vorbis_dense", "symphonia_tpu_torch.ops.vorbis_dense",
     ("lap_stitch",)),
    ("symphonia_tpu.ops.pcm", "symphonia_tpu_torch.ops.pcm",
     ("_build_mulaw_table", "_build_alaw_table", "decode_pcm_np")),
    ("test_layer12", "symphonia_tpu_torch.testing.mpa_l12_builder",
     ("build_l1_frame", "build_l2_frame", "_rand_l2_frame")),
    ("test_vorbis_ogg", "symphonia_tpu_torch.testing.ogg_builder",
     ("_ogg_page",)),
    ("symphonia_tpu.ops.rice_device", "symphonia_tpu_torch.ops.rice_device",
     ("pack_bits_u32", "rice_decode_oracle", "make_test_streams")),
    ("test_wav_pcm", "symphonia_tpu_torch.testing.wav_builder",
     ("make_wav",)),
    ("test_aiff_caf", "symphonia_tpu_torch.testing.aiff_caf_builder",
     ("pack_f80", "make_aiff", "make_caf")),
    ("test_adpcm", "symphonia_tpu_torch.testing.adpcm_builder",
     ("ima_encode", "ms_encode", "make_adpcm_wav")),
    ("test_mkv", "symphonia_tpu_torch.testing.mkv_builder",
     ("vint_size", "elem", "uint_elem", "float_elem", "simple_block",
      "build_mkv")),
    ("test_mp4", "symphonia_tpu_torch.testing.mp4_builder",
     ("atom", "full_atom", "build_pcm_m4a")),
]


@pytest.mark.parametrize("ref,port,names", PARTS, ids=[p[1] for p in PARTS])
def test_copied_functions_are_verbatim(ref, port, names):
    a, b = importlib.import_module(ref), importlib.import_module(port)
    for name in names:
        _assert_verbatim(inspect.getsource(getattr(a, name)),
                         inspect.getsource(getattr(b, name)))
    if port.endswith("mp3_dense"):
        for k in ("BLOCK_LONG", "BLOCK_START", "BLOCK_SHORT", "BLOCK_END"):
            assert getattr(a, k) == getattr(b, k)
    if port.endswith("pcm"):
        np.testing.assert_array_equal(a.MULAW_TABLE, b.MULAW_TABLE)
        np.testing.assert_array_equal(a.ALAW_TABLE, b.ALAW_TABLE)


@pytest.mark.parametrize("name", sorted(p.name for p in (REF / "data").glob(
    "*.npz")))
def test_data_files_are_equal(name):
    assert (PORT / "data" / name).read_bytes() == (REF / "data" /
                                                  name).read_bytes()


# ---------------------------------------------------------------------------
# The tables: the decoder's constants, carried across
# ---------------------------------------------------------------------------


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_mp3_and_l12_tables():
    from symphonia_tpu.ops import mp3_dense as ref
    from symphonia_tpu_torch.ops import mp3_dense as port

    got = port.reference_tables()
    cs, ca = ref.antialias_coeffs()
    for k, want in (("hybrid", ref.hybrid_matrices()), ("cs", cs),
                    ("ca", ca), ("finv", ref.freq_inversion_mask()),
                    ("matrixing", ref.polyphase_matrix()),
                    ("window", ref.synthesis_window())):
        _equal(got[k], want)
    l12 = port.l12_tables()
    assert l12.keys() == {"matrixing", "window"}
    _equal(l12["matrixing"], ref.polyphase_matrix())
    _equal(l12["window"], ref.synthesis_window())
    _equal(port.synthesis_window(), ref.synthesis_window())
    _equal(port.polyphase_matrix(), ref.polyphase_matrix())


def test_aac_tables():
    from symphonia_tpu import native as ref_native
    from symphonia_tpu.codecs import aac as ref_aac
    from symphonia_tpu.ops import aac_dense as ref
    from symphonia_tpu_torch.codecs import aac as port_aac
    from symphonia_tpu_torch.ops import aac_dense as port

    got = port.reference_tables()
    _equal(got["imdct_long"], ref.imdct_matrix_scaled(1024))
    _equal(got["imdct_short"], ref.imdct_matrix_scaled(128))
    _equal(got["pow43"], ref_native.aac_pow43())
    for k, want in zip(("ola_head", "ola_delay", "ola_s_first",
                        "ola_s_left", "ola_s_right"), ref._ola_tables()):
        _equal(got[k], want)
    a, b = ref_aac._tables(), port_aac._tables()
    assert a.keys() == b.keys()
    for k in a:
        _equal(b[k], a[k])


@pytest.mark.parametrize("rate", [96000, 88200, 64000, 48000, 44100, 32000,
                                  24000, 22050, 16000, 12000, 11025, 8000,
                                  7350])
def test_aac_sfb_map_for_every_rate(rate):
    from symphonia_tpu import native as ref_native
    from symphonia_tpu.codecs.aac import subband_info as ref_info
    from symphonia_tpu_torch import native as port_native
    from symphonia_tpu_torch.codecs.aac import subband_info as port_info

    assert port_info(rate) == ref_info(rate)
    _, bl, _ = port_info(rate)
    _equal(port_native.aac_sfb_map(bl), ref_native.aac_sfb_map(bl))


def test_imdct_matrices_and_vorbis_windows():
    from symphonia_tpu.codecs import vorbis as ref_vorbis
    from symphonia_tpu.codecs.aac import imdct_matrix_scaled as ref_scaled
    from symphonia_tpu_torch.codecs import vorbis as port_vorbis
    from symphonia_tpu_torch.codecs.aac import imdct_matrix_scaled

    for n in (64, 128, 256, 512, 1024, 2048):
        _equal(port_vorbis.imdct_matrix(n), ref_vorbis.imdct_matrix(n))
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
        _equal(port_vorbis.vorbis_window(n), ref_vorbis.vorbis_window(n))
    for n in (128, 1024):
        _equal(imdct_matrix_scaled(n), ref_scaled(n))


# ---------------------------------------------------------------------------
# Probing the repository's fixtures
# ---------------------------------------------------------------------------


def _plain(v):
    """A comparable value of a reader's result, with no class of either
    package left in it (only the class names)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, tuple((f.name, _plain(getattr(v, f.name)))
                                        for f in dataclasses.fields(v)))
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if v is None or isinstance(v, (int, float, str, bool, np.integer)):
        return v
    if hasattr(v, "__dict__"):
        return (type(v).__name__,
                tuple(sorted((k, _plain(x)) for k, x in vars(v).items())))
    return repr(v)


def _pygame_file(name):
    pg = importlib.util.find_spec("pygame").submodule_search_locations[0]
    return (pathlib.Path(pg) / "examples" / "data" / name).read_bytes()


def _pcm_frames():
    return np.random.default_rng(5).integers(-30000, 30000, size=(5000, 2))


def _wav():
    from test_wav_pcm import make_wav

    return make_wav(_pcm_frames(), rate=22050)


def _aiff():
    from test_aiff_caf import make_aiff

    return make_aiff(_pcm_frames())


def _caf():
    from test_aiff_caf import make_caf

    return make_caf(_pcm_frames())


def _mkv():
    from test_mkv import build_mkv, simple_block

    payload = _pcm_frames()[:, :1].astype("<i2").tobytes()
    blocks = [(0, [simple_block(1, 0, [payload[:600]])]),
              (100, [simple_block(1, 0, [payload[600:]])])]
    return build_mkv("A_PCM/INT/LIT", b"", blocks, rate=8000, ch=1,
                     bit_depth=16)


def _aac_frames(rate):
    from aac_builder import build_raw_block, random_quant_spectrum

    rng = np.random.default_rng(6)
    return [build_raw_block([random_quant_spectrum(rng, 40, rate)], [0], 40,
                            140, rate) for _ in range(5)]


def _mp4():
    from test_mp4 import build_m4a

    return build_m4a(_aac_frames(44100), 44100, 1)


def _adts():
    from aac_builder import build_adts

    return build_adts(_aac_frames(48000), 48000, 1)


def _flac():
    from flac_builder import build_flac_file, random_walk

    return build_flac_file(random_walk(1500, 16, seed=8, ch=2),
                           block_size=512, stereo_mode="mid_side",
                           kind="fixed", order=2)


FIXTURES = {"wav": _wav, "aiff": _aiff, "caf": _caf, "mkv": _mkv,
            "mp4": _mp4, "adts": _adts, "flac": _flac,
            "ogg": lambda: _pygame_file("house_lo.ogg"),
            "mp3": lambda: _pygame_file("house_lo.mp3")}


def _probe_all(pkg, data):
    sym = importlib.import_module(pkg)
    io = importlib.import_module(pkg + ".core.io")
    fmt = sym.get_probe().probe(io.MediaSourceStream(data)).format
    tracks = _plain(fmt.tracks() if callable(getattr(fmt, "tracks", None))
                    else fmt.tracks)
    packets = []
    while (p := fmt.next_packet()) is not None:
        packets.append(_plain(p))
    return type(fmt).__name__, _plain(fmt.default_track()), tracks, packets


@pytest.mark.parametrize("kind", list(FIXTURES))
def test_probe_gives_equal_tracks_and_packets(kind):
    data = FIXTURES[kind]()
    got = _probe_all("symphonia_tpu_torch", data)
    want = _probe_all("symphonia_tpu", data)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1][1]  # a track with codec params
    assert got[2] == want[2]
    assert len(got[3]) == len(want[3]) > 1
    assert got[3] == want[3]


# ---------------------------------------------------------------------------
# The port's test encoders: the same bytes as the repository's
# ---------------------------------------------------------------------------


def _encoders():
    """(name, callable(module) -> bytes): chip_smoke.py's encoder calls at
    small sizes, with its seeds."""
    seed = 20261016

    def flac(m):
        walk = m.random_walk(3000, 16, seed=seed, ch=2)
        return b"".join(
            m.build_flac_file(walk, sample_rate=44100, bps=16,
                              block_size=1024, stereo_mode=mode, **kw)
            for mode, kw in (
                ("independent", dict(kind="lpc", lpc_coefs=[4096, 7, -7],
                                     lpc_shift=12, lpc_precision=15)),
                ("right_side", dict(kind="fixed", order=2)),
                ("mid_side", dict(kind="verbatim"))))

    def mp3(m):
        return (m.build_mpeg1_l3_stream(4, n_ch=2, seed=seed)
                + m.build_mpeg1_l3_stream(3, n_ch=1, seed=seed + 100))

    def aac(m):
        rng = np.random.default_rng(seed + 200)
        frames = []
        for seq in (0, 1, 2, 3):
            max_sfb = 12 if seq == 2 else 40
            quants = [m.random_quant_spectrum(rng, max_sfb, 44100, seq)
                      for _ in range(2)]
            frames.append(m.build_raw_block(quants, [seq, seq], max_sfb, 140,
                                            44100, shape=1))
        quants = [m.random_quant_spectrum(rng, 40, 44100) for _ in range(2)]
        frames.append(m.build_raw_block(quants, [0, 0], 40, 140, 44100,
                                        special_books1={5: 14}))
        return m.build_adts(frames, 44100, 2)

    def vorbis(m):
        rng = np.random.default_rng(seed + 300)
        out = m.build_setup_header_stereo()
        for long_block in (True, False):
            parts = min(m.R2_END, (256, 2048)[long_block]) // m.PART_SIZE
            out += m.build_audio_packet_stereo(
                long_block, (2, 3), ((1, 2), (3, 4)),
                [int(rng.integers(0, 4)) for _ in range(parts // 2)],
                [[int(rng.integers(0, 16)) for _ in range(4)]
                 for _ in range(parts)])
        return out

    def ogg(m):
        return m._ogg_page(0x5EED, 2, 4096, [b"\x01" * 300, b"ab"],
                           header_type=4)

    def l12(m):
        rng = np.random.default_rng(seed + 400)
        allocs = [[int(rng.choice([0, 2, 4, 8, 15])) if sb < 12 else 0
                   for sb in range(32)] for _ in range(2)]
        raws = [[[int(rng.integers(0, 1 << a)) if a else 0
                  for _ in range(12)] for a in ch] for ch in allocs]
        sfi = [[int(rng.integers(0, 60)) for _ in range(32)]
               for _ in range(2)]
        return (m.build_l1_frame(raws, allocs, sfi, n_ch=2)[0]
                + m._rand_l2_frame(seed, n_ch=2)[0]
                + m._rand_l2_frame(seed + 1, n_ch=2, mpeg2=True)[0])

    return [("flac_builder", "flac_builder", flac),
            ("mp3_builder", "mp3_builder", mp3),
            ("aac_builder", "aac_builder", aac),
            ("vorbis_builder", "vorbis_builder", vorbis),
            ("test_vorbis_ogg", "ogg_builder", ogg),
            ("test_layer12", "mpa_l12_builder", l12)]


@pytest.mark.parametrize("ref,port,make", _encoders(),
                         ids=[e[1] for e in _encoders()])
def test_encoder_bytes_equal(ref, port, make):
    want = make(importlib.import_module(ref))
    got = make(importlib.import_module(f"symphonia_tpu_torch.testing.{port}"))
    assert len(got) > 100 and got == want
