"""The port's copies of the repository's player, resampler and two examples
(``symphonia_tpu_torch/tools/play.py``, ``ui.py``, ``resample.py``,
``examples/getting_started.py``, ``examples/basic_interleaved.py``): the
mirrors of ``tests/test_batch_and_entry.py``'s ``TestPlayTui``, its two
``play`` subprocess tests and its example runs, and of
``tests/test_core_audio.py``'s ``TestResampler``. Every subprocess here is
an interpreter that refuses the reference package and JAX (a
``sitecustomize`` on its path installs the refusal, so it holds in every
process the command starts)."""

import os
import pathlib
import subprocess
import sys
import wave

import numpy as np
import pytest

from test_torch_guards import jax_free_env

ROOT = pathlib.Path(__file__).resolve().parent.parent
def _pygame_data(name: str) -> str:
    """The path of a media file that pygame ships (its examples' data)."""
    import importlib.util

    spec = importlib.util.find_spec("pygame")
    if spec is None:
        pytest.skip("pygame (and its example media) is not installed")
    return os.path.join(spec.submodule_search_locations[0], "examples",
                        "data", name)


def _run(args, tmp_path, timeout=300):
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=str(ROOT),
                          env=jax_free_env(tmp_path))


def test_refusal_holds_in_the_subprocess(tmp_path):
    r = _run(["-c", "import jax"], tmp_path)
    assert r.returncode != 0 and "refused: jax" in r.stderr
    r = _run(["-c", "import symphonia_tpu.core"], tmp_path)
    assert r.returncode != 0 and "refused: symphonia_tpu" in r.stderr


# ---------------------------------------------------------------------------
# play.py and its now-playing UI
# ---------------------------------------------------------------------------


class TestPlayTui:
    @pytest.mark.filterwarnings(
        "ignore:.*use of forkpty.*:DeprecationWarning")
    @pytest.mark.filterwarnings(
        "ignore:os.fork\\(\\) was called:RuntimeWarning")
    def test_tui_smoke_under_pty(self, tmp_path):
        """Drive the curses now-playing UI in a pty: render, pause, resume,
        quit (the mirror of tests/test_batch_and_entry.py's)."""
        import pty
        import select
        import time as _time

        wav = str(tmp_path / "tui.wav")
        sig = (np.sin(np.arange(240000) * 0.2) * 12000).astype("<i2")
        with wave.open(wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(sig.tobytes())
        env = jax_free_env(tmp_path, SDL_AUDIODRIVER="dummy",
                           TERM="xterm-256color")
        pid, fd = pty.fork()
        if pid == 0:
            os.chdir(str(ROOT))
            os.execvpe(sys.executable,
                       [sys.executable, "-m", "symphonia_tpu_torch.tools.play",
                        "--play", "--tui", wav], env)
        out = b""
        t0 = _time.time()
        sent = 0
        last_send = t0
        while _time.time() - t0 < 90:
            r, _, _ = select.select([fd], [], [], 0.3)
            if r:
                try:
                    chunk = os.read(fd, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                out += chunk
            now = _time.time()
            if sent == 0 and b"PLAYING" in out:
                os.write(fd, b" ")
                sent, last_send = 1, now
            elif sent == 1 and b"PAUSED" in out:
                os.write(fd, b" ")
                sent, last_send = 2, now
            elif sent == 2 and now - last_send > 1.0:
                os.write(fd, b"q")
                sent, last_send = 3, now
            elif sent == 3 and now - last_send > 10.0:
                os.write(fd, b"q")
                last_send = now
        if sent < 3:
            try:
                os.write(fd, b"q")
            except OSError:
                pass
        status = None
        t1 = _time.time()
        while _time.time() - t1 < 30:
            wpid, st = os.waitpid(pid, os.WNOHANG)
            if wpid == pid:
                status = st
                break
            _time.sleep(0.2)
        if status is None:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            pytest.fail("TUI child did not exit after quit")
        txt = out.decode("utf-8", "replace")
        assert status == 0, txt[-2000:]
        assert "symphonia_tpu" in txt and "PLAYING" in txt
        assert "PAUSED" in txt


class TestPlayExportScaling:
    def test_24bit_flac_wav_export_scaled(self, tmp_path):
        """Integer planes at 24 bits are scaled on export to s16 WAV."""
        from flac_builder import build_flac_file, random_walk

        ch = [(np.asarray(random_walk(8192, 16, seed=3, ch=1)[0],
                          np.int64) * 256)]
        src = tmp_path / "t24.flac"
        dst = tmp_path / "t24.wav"
        src.write_bytes(build_flac_file(ch, bps=24, kind="fixed", order=2))
        r = _run(["-m", "symphonia_tpu_torch.tools.play", "--output",
                  str(dst), str(src)], tmp_path)
        assert r.returncode == 0, r.stderr
        with wave.open(str(dst)) as w:
            s16 = np.frombuffer(w.readframes(w.getnframes()),
                                "<i2").astype(np.float64)
        ideal = ch[0].astype(np.float64) / (1 << 23) * 32768
        assert np.abs(s16 - ideal).max() <= 1.0

    def test_verify_skipped_after_seek(self, tmp_path):
        """--seek + --verify-only reports no MD5 failure for the suffix."""
        from flac_builder import build_flac_file, random_walk

        src = tmp_path / "t.flac"
        src.write_bytes(build_flac_file(
            random_walk(16384, 16, seed=4, ch=1), kind="fixed", order=2))
        r = _run(["-m", "symphonia_tpu_torch.tools.play", "--seek", "0.1",
                  "--verify-only", str(src)], tmp_path)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "FAILED" not in r.stdout

    def test_probe_only_matches_reference(self, tmp_path):
        # The port's --probe-only prints what the reference's prints.
        mp3 = _pygame_data("house_lo.mp3")
        got = _run(["-m", "symphonia_tpu_torch.tools.play", "--probe-only",
                    mp3], tmp_path)
        want = subprocess.run(
            [sys.executable, "-m", "symphonia_tpu.tools.play",
             "--probe-only", mp3], capture_output=True, text=True,
            timeout=300, cwd=str(ROOT))
        assert got.returncode == want.returncode == 0, got.stderr
        assert got.stdout == want.stdout and "codec:        mp3" in got.stdout


# ---------------------------------------------------------------------------
# resample.py
# ---------------------------------------------------------------------------


class TestResampler:
    def test_oneshot_rate_conversion(self):
        from symphonia_tpu_torch.tools.resample import resample

        t = np.arange(44100, dtype=np.float64) / 44100
        x = np.sin(2 * np.pi * 440 * t).astype(np.float32)[None, :]
        y = resample(x, 44100, 48000)
        assert abs(y.shape[1] - 48000) <= 2
        t2 = np.arange(y.shape[1], dtype=np.float64) / 48000
        ref = np.sin(2 * np.pi * 440 * t2).astype(np.float32)
        n = y.shape[1]
        err = np.abs(y[0, 500: n - 500] - ref[500: n - 500]).max()
        assert err < 1e-3

    def test_streaming_matches_oneshot(self):
        from symphonia_tpu_torch.tools.resample import Resampler, resample

        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 30000)).astype(np.float32) * 0.3
        whole = resample(x, 44100, 22050)
        rs = Resampler(44100, 22050, 2)
        outs = [rs.process(x[:, i: i + 4096]) for i in range(0, 30000, 4096)]
        outs.append(rs.flush())
        stream = np.concatenate(outs, axis=1)
        n = min(whole.shape[1], stream.shape[1])
        err = np.abs(stream[:, 300: n - 300] - whole[:, 300: n - 300]).max()
        assert err < 5e-3

    def test_identity(self):
        from symphonia_tpu_torch.tools.resample import Resampler

        rs = Resampler(48000, 48000, 1)
        x = np.ones((1, 100), np.float32)
        assert rs.process(x).shape == (1, 100)

    def test_equal_to_reference(self):
        from symphonia_tpu.tools import resample as ref
        from symphonia_tpu_torch.tools import resample as port

        x = np.random.default_rng(1).standard_normal((2, 9000)).astype(
            np.float32)
        np.testing.assert_array_equal(port.resample(x, 44100, 48000),
                                      ref.resample(x, 44100, 48000))
        a, b = port.Resampler(48000, 44100, 2), ref.Resampler(48000, 44100, 2)
        for i in range(0, 9000, 2048):
            np.testing.assert_array_equal(a.process(x[:, i:i + 2048]),
                                          b.process(x[:, i:i + 2048]))
        np.testing.assert_array_equal(a.flush(), b.flush())


# ---------------------------------------------------------------------------
# The two examples
# ---------------------------------------------------------------------------


class TestExamples:
    def test_getting_started_runs(self, tmp_path):
        mp3 = _pygame_data("house_lo.mp3")
        r = _run(["-m", "symphonia_tpu_torch.examples.getting_started", mp3],
                 tmp_path)
        assert r.returncode == 0, r.stderr
        assert "codec:     mp3" in r.stdout
        # As a script too: its path line reaches the repository root.
        r = _run([str(ROOT / "symphonia_tpu_torch/examples/"
                               "getting_started.py"), mp3], tmp_path)
        assert r.returncode == 0, r.stderr
        assert "container: MpaReader" in r.stdout

    def test_basic_interleaved_runs(self, tmp_path):
        from test_wav_pcm import make_wav

        wav = tmp_path / "t.wav"
        frames = (np.arange(400, dtype=np.int32) % 100 - 50).reshape(200, 2)
        wav.write_bytes(make_wav(frames.astype(np.int32), rate=8000))
        flac = tmp_path / "t.flac"
        from flac_builder import build_flac_file, random_walk

        flac.write_bytes(build_flac_file(random_walk(2048, 16, seed=6, ch=2),
                                         block_size=512, kind="fixed",
                                         order=2))
        code = ("import sys\n"
                "from symphonia_tpu_torch.examples import basic_interleaved"
                " as b\n"
                "for p in sys.argv[1:]:\n"
                "    assert b.main(p, device='cpu') == 0\n")
        r = _run(["-c", code, str(wav), str(flac)], tmp_path)
        assert r.returncode == 0, r.stderr
        assert "rate=8000" in r.stdout and "shape=(200, 2)" in r.stdout
        assert "rate=44100" in r.stdout and "shape=(2048, 2)" in r.stdout
        # The script's own entry names no device: the card, which this
        # machine may lack.
        r = _run([str(ROOT / "symphonia_tpu_torch/examples/"
                               "basic_interleaved.py"), str(wav)], tmp_path)
        import torch

        if torch.cuda.is_available():
            assert r.returncode == 0, r.stderr
        else:
            assert r.returncode != 0
            assert "CUDA is not available" in r.stderr
