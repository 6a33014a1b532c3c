"""The port's copy of the conformance tool (``symphonia_tpu_torch/tools/
check.py``), the mirror of ``tests/test_check_tool.py``: the --ref cross
mode (the port's native fast paths against its Python oracle decoders), a
divergence it must catch, the oracle path really engaged; then the SDL mode
on the MP3 and Vorbis files pygame ships (skipped where pygame is
missing), and the FLAC MD5 mode, each with the reference's verdict."""

import os
import struct
import pathlib
import sys

import numpy as np
import pytest

from symphonia_tpu_torch.tools.check import run_check


@pytest.fixture(scope="module")
def m4a_aac(tmp_path_factory):
    sys.path.insert(0, "tests")
    from aac_builder import build_raw_block, random_quant_spectrum
    from test_mp4 import build_m4a

    rng = np.random.default_rng(2)
    frames = [build_raw_block([random_quant_spectrum(rng, 30, 44100)], [0],
                              30, 140, 44100) for _ in range(6)]
    p = tmp_path_factory.mktemp("check") / "a.m4a"
    p.write_bytes(build_m4a(frames, 44100, 1))
    return str(p)


@pytest.fixture(scope="module")
def m4a_alac(tmp_path_factory):
    sys.path.insert(0, "tests")
    from alac_builder import build_cookie, encode_frame_compressed
    from test_alac import signal
    from test_mp4 import atom, build_m4a_custom_entry, full_atom

    frame_len = 512
    ch = signal(frame_len * 4, 13)
    cookie_dict = dict(frame_length=frame_len, bit_depth=16, pb=40, mb=10,
                       kb=14)
    frames = [encode_frame_compressed(
        [ch[0][i * frame_len:(i + 1) * frame_len]], cookie_dict, order=2)
        for i in range(4)]
    cookie = build_cookie(frame_len, 16, 1, 44100)
    entry = atom(b"alac",
                 b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 8
                 + struct.pack(">HH", 1, 16) + b"\x00" * 4
                 + struct.pack(">I", 44100 << 16)
                 + full_atom(b"alac", cookie))
    p = tmp_path_factory.mktemp("check") / "a_alac.m4a"
    p.write_bytes(build_m4a_custom_entry(frames, entry, rate=44100,
                                         samples_per_frame=frame_len))
    return str(p)


class TestCrossMode:
    def test_aac_auto_routes_to_cross_and_passes(self, m4a_aac, capsys):
        assert run_check(m4a_aac, quiet=True) == 0
        out = capsys.readouterr().out
        assert "PASS" in out

    def test_alac_cross_bit_exact(self, m4a_alac, capsys):
        assert run_check(m4a_alac, ref_name="cross") == 0
        out = capsys.readouterr().out
        assert "abs max delta:    0.000e+00" in out

    def test_cross_detects_divergence(self, m4a_alac, monkeypatch):
        # Corrupt the native path only: cross must FAIL when the two
        # implementations disagree.
        from symphonia_tpu_torch import native

        real = native.alac_decode

        def corrupt(*a, **k):
            out = real(*a, **k)
            if out is not None and out.size:
                out = out.copy()
                out[0, 0] += 1000
            return out

        monkeypatch.setattr(native, "alac_decode", corrupt)
        assert run_check(m4a_alac, ref_name="cross", quiet=True) == 2

    def test_oracle_path_actually_engaged(self, m4a_aac, monkeypatch):
        # native.disabled() must really force the Python decoders: a
        # native wrapper that records calls sees none inside the context.
        from symphonia_tpu_torch import native

        calls = []
        orig = native._load

        def spy():
            r = orig()
            if r is not None:
                calls.append(1)
            return r

        monkeypatch.setattr(native, "_load", spy)
        with native.disabled():
            assert native._load() is None
            data = pathlib.Path(m4a_aac).read_bytes()
            from symphonia_tpu_torch.tools.check import our_decode

            our_decode(data, gapless=False)
        assert not calls


def _pygame_data(name: str) -> str:
    """The path of a media file that pygame ships (its examples' data)."""
    import importlib.util

    spec = importlib.util.find_spec("pygame")
    if spec is None:
        pytest.skip("pygame (and its example media) is not installed")
    return os.path.join(spec.submodule_search_locations[0], "examples",
                        "data", name)


def _flac_file(tmp_path):
    from flac_builder import build_flac_file, random_walk

    p = tmp_path / "a.flac"
    p.write_bytes(build_flac_file(random_walk(4096, 16, seed=9, ch=2),
                                  block_size=1024, stereo_mode="mid_side",
                                  kind="fixed", order=2))
    return str(p)


class TestReferenceModes:
    @pytest.mark.parametrize("name,ref_name", [("house_lo.mp3", "sdl"),
                                               ("house_lo.ogg", "sdl"),
                                               ("house_lo.ogg", "cross")])
    def test_same_verdict_and_report_as_reference(self, name, ref_name,
                                                  capsys):
        if ref_name == "sdl":
            pytest.importorskip("pygame")
        from symphonia_tpu.tools.check import run_check as ref_check

        capsys.readouterr()  # pygame's greeting on its first import

        path = _pygame_data(name)
        got = run_check(path, ref_name=ref_name)
        got_out = capsys.readouterr().out
        want = ref_check(path, ref_name=ref_name)
        want_out = capsys.readouterr().out
        assert got == want
        assert got_out == want_out and "result:" in got_out

    def test_flac_md5_mode(self, tmp_path, capsys):
        assert run_check(_flac_file(tmp_path)) == 0
        assert "FLAC MD5 self-verification: PASS" in capsys.readouterr().out
