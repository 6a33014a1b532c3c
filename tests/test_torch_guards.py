"""Guards of the PyTorch port: it never imports JAX, runs on the card unless
the caller asks for the CPU, never falls back to the CPU on its own, and
builds and counts every kernel."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from symphonia_tpu_torch import batch as port
from symphonia_tpu_torch import entry
from symphonia_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_REFUSE = """
import sys


class Refuse:
    \"\"\"Refuses the reference package and JAX, however they are asked for.\"\"\"

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("symphonia_tpu", "jax", "jaxlib"):
            raise ImportError("refused: " + name)


sys.meta_path.insert(0, Refuse())
"""


def jax_free_env(tmp_path, **extra):
    """An environment whose interpreters, and every process they start,
    refuse the reference package and JAX: ``tmp_path/refuse/
    sitecustomize.py`` (:data:`_REFUSE`) first on the path, the repository
    root after it."""
    site = tmp_path / "refuse"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(_REFUSE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{ROOT}", **extra)
    return env


def _five_codec_inputs(tmp_path):
    """FLAC, MP3, AAC, Ogg Vorbis and Layer II streams, built here (the
    repository's encoders import the reference package) and written to
    ``tmp_path`` for a fresh interpreter."""
    import importlib.util
    import pathlib

    from aac_builder import build_adts, build_raw_block
    from flac_builder import build_flac_file
    from mp3_builder import build_mpeg1_l3_stream
    from test_layer12 import _rand_l2_frame

    steps = np.random.default_rng(1).integers(-60, 61, size=(2, 1024))
    ch = np.clip(np.cumsum(steps, axis=1), -32767, 32767)
    q = np.zeros(1024, np.int64)
    q[:8] = [100, -500, 17, -16, 2000, -8000, 15, 1]
    pg = importlib.util.find_spec("pygame").submodule_search_locations[0]
    streams = {
        "flac": build_flac_file(list(ch), block_size=256,
                                stereo_mode="mid_side", kind="fixed",
                                order=2),
        "mp3": build_mpeg1_l3_stream(3, n_ch=2, seed=1),
        "aac": build_adts([build_raw_block([q, -q], [s, s], 12, 140, 44100)
                           for s in (0, 1, 2, 3)], 44100, 2),
        "ogg": (pathlib.Path(pg) / "examples/data/house_lo.ogg").read_bytes(),
        "mp2": b"".join(_rand_l2_frame(s, n_ch=2)[0] for s in range(3)),
    }
    for name, data in streams.items():
        (tmp_path / name).write_bytes(data)
    np.save(tmp_path / "flac.npy", ch)


def test_port_never_imports_jax(tmp_path):
    # A fresh interpreter that refuses the reference package and JAX (this
    # process has both): the five-codec decode_many and the combined decode
    # step run, and neither package is loaded afterwards.
    _five_codec_inputs(tmp_path)
    code = _REFUSE + textwrap.dedent("""
        import pathlib
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import torch
        from symphonia_tpu_torch import batch, entry
        d = pathlib.Path(sys.argv[2])
        names = ["flac", "mp3", "aac", "ogg", "mp2"]
        out = batch.decode_many([(d / n).read_bytes() for n in names],
                                device="cpu", verify=True)
        ch = np.load(d / "flac.npy")
        assert out[0].md5_ok is True and (out[0].samples == ch).all()
        assert out[1].samples.shape[0] == 2
        assert np.isfinite(out[1].samples).all()
        assert out[2].samples.shape == (2, 4096)
        assert np.isfinite(out[2].samples).all() and out[2].samples.any()
        assert out[3].samples.shape[0] == 1 and out[3].samples.any()
        assert out[4].samples.shape == (2, 3 * 1152)
        assert np.isfinite(out[4].samples).all() and out[4].samples.any()
        assert batch.host_routes == 0
        fn, args = entry.entry(device="cpu")
        flac, mp3, aac, vorb = fn(*args)
        assert flac.shape == (8, 2, 256) and mp3.shape == (8, 2, 576)
        assert aac.shape == (8, 1024) and vorb.shape == (8, 256)
        assert all(torch.isfinite(o).all() for o in (mp3, aac, vorb))
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("symphonia_tpu", "jax", "jaxlib")]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, ROOT, str(tmp_path)],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imported_modules(path):
    """Every module an AST import names, plus the string arguments of
    ``__import__`` and ``importlib.import_module`` calls."""
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            names.append(node.args[0].value)
    return names


def test_port_sources_import_no_jax():
    # Neither the package nor chip_smoke.py imports the reference package
    # or JAX, by any import statement or call.
    pkg = os.path.join(ROOT, "symphonia_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(pkg):
        if "_build" in dirs:
            dirs.remove("_build")  # build outputs, not package sources
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 60
    for tool in ("bench.py", "soak.py", "check.py", "play.py",
                 "resample.py", "ui.py"):
        assert os.path.join(pkg, "tools", tool) in paths
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/step.py", "examples/getting_started.py",
                "examples/basic_interleaved.py"):
        assert os.path.join(pkg, *mod.split("/")) in paths
    for path in paths:
        for name in _imported_modules(path):
            assert name.split(".")[0] not in ("symphonia_tpu", "jax",
                                              "jaxlib"), (path, name)


@pytest.mark.parametrize("make", [
    lambda: port.FlacBatchDecoder(device="cuda"),
    lambda: port.Mp3BatchDecoder(device="cuda"),
    lambda: port.AacBatchDecoder(device="cuda"),
    lambda: port.VorbisBatchDecoder(device="cuda"),
    lambda: port.decode_bytes(b"", device="cuda"),
    lambda: entry.entry(),
    lambda: entry.entry(device="cuda"),
    # No device argument: the card, by default.
    lambda: port.FlacBatchDecoder(),
    lambda: port.Mp3BatchDecoder(),
    lambda: port.AacBatchDecoder(),
    lambda: port.VorbisBatchDecoder(),
    lambda: port.decode_bytes(b""),
    lambda: port.decode_many([]),
    lambda: _bench_rice_device().main(),
    lambda: _batch_serving().main(["any.wav"]),
    lambda: _time_kernel_variants().measure("any"),
    lambda: _bench().main(),
    lambda: _bench().bench_flac_device(),
    lambda: _bench().bench_mp3_device(),
    lambda: _bench().bench_aac_device(),
    lambda: _bench().bench_vorbis_device(),
    lambda: _soak().main(),
    lambda: _soak().main(1.0, 7, device="cuda"),
    lambda: entry.dryrun_multichip(1),
    lambda: entry.dryrun_multichip(1, backend="nccl"),
    lambda: entry.dryrun_multichip(8, backend="gloo"),
    lambda: entry.dryrun_multichip(4, device="cuda", backend="gloo",
                                   size=dict(F=2, N=8, G=2, A=2, V=2, n1=8)),
    # (The example reads its file before it decodes: any file will do.)
    lambda: _basic_interleaved().main(__file__),
])
def test_cuda_without_cuda_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_decode_many_cuda_without_cuda_decodes_nothing(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from flac_builder import build_flac_file, random_walk

    data = build_flac_file(random_walk(512, 16, seed=2), block_size=256,
                           kind="fixed", order=1)
    calls = []
    monkeypatch.setattr(port.FlacBatchDecoder, "_decode_packed_chunked",
                        lambda *a: calls.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.decode_many([data], device="cuda")
    assert calls == []


def _bench_rice_device():
    from symphonia_tpu_torch.tools import bench_rice_device

    return bench_rice_device


def _time_kernel_variants():
    from symphonia_tpu_torch.tools import time_kernel_variants

    return time_kernel_variants


def _batch_serving():
    from symphonia_tpu_torch.examples import batch_serving

    return batch_serving


def _basic_interleaved():
    from symphonia_tpu_torch.examples import basic_interleaved

    return basic_interleaved


def _bench():
    from symphonia_tpu_torch.tools import bench

    return bench


def _soak():
    from symphonia_tpu_torch.tools import soak

    return soak


def test_device_is_required():
    # Every entry point takes a device, and without one it is the card.
    import inspect

    for fn in (port.FlacBatchDecoder, port.Mp3BatchDecoder,
               port.AacBatchDecoder, port.VorbisBatchDecoder,
               port.decode_bytes, port.decode_file, port.decode_many,
               entry.entry, _bench_rice_device().main,
               _batch_serving().main, _bench().main,
               _bench().bench_flac_device, _bench().bench_mp3_device,
               _bench().bench_aac_device, _bench().bench_vorbis_device,
               _soak().main, entry.dryrun_multichip,
               _basic_interleaved().main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(ValueError):
        port.FlacBatchDecoder(device="meta")


@pytest.mark.parametrize("n,cards", [(2, 1), (4, 1), (8, 4), (2, 0)])
def test_nccl_with_more_ranks_than_cards_raises(monkeypatch, n, cards):
    # NCCL wants one card a rank: with fewer cards it raises before any
    # build or process start; nothing falls back to gloo or to the CPU.
    from symphonia_tpu_torch.parallel import step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    calls = []
    monkeypatch.setattr(_build, "build", lambda: calls.append("build"))
    monkeypatch.setattr(step, "_rank_main", lambda *a: calls.append(a))
    with pytest.raises(RuntimeError, match="one card a rank"):
        entry.dryrun_multichip(n, backend="nccl")
    with pytest.raises(RuntimeError, match="one card a rank"):
        step.spawn(n, _no_body, backend="nccl", device="cuda")
    assert calls == []


def _no_body(rank):
    return rank.rank


def test_dryrun_ranks_never_import_jax(tmp_path):
    # The spawned ranks are fresh interpreters: a sitecustomize on their
    # path refuses the reference package and JAX in each of them too.
    code = textwrap.dedent("""
        import sys
        from symphonia_tpu_torch.entry import dryrun_multichip
        if __name__ == "__main__":
            res = dryrun_multichip(2, device="cpu", backend="gloo",
                                   size=dict(F=3, N=32, G=5, A=3, V=3,
                                             n1=64))
            assert res["mesh"] == [1, 2] and res["bits_equal"]["flac"]
            bad = [m for m in sys.modules
                   if m.split(".")[0] in ("symphonia_tpu", "jax", "jaxlib")]
            assert not bad, bad
            print("ok")
    """)
    script = tmp_path / "run.py"
    script.write_text(code)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, env=jax_free_env(tmp_path),
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("call", ["decode_bytes", "decode_many"])
@pytest.mark.parametrize("make", ["flac", "wav"])
def test_default_device_without_cuda_decodes_nothing(monkeypatch, call,
                                                     make):
    # With no card, a call that names no device raises before any decoder
    # runs: nothing falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _flac() if make == "flac" else _wav()
    calls = []
    monkeypatch.setattr(port.FlacBatchDecoder, "_decode_packed_chunked",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(port, "_packet_decode", lambda *a: calls.append(a))
    before = (port.packet_routes, port.host_routes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if call == "decode_bytes":
            port.decode_bytes(data)
        else:
            port.decode_many([data])
    assert calls == []
    assert (port.packet_routes, port.host_routes) == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert _build._LIB is None
    assert not (tmp_path / "_build").exists()


_FAKE_NVCC = """#!/bin/sh
prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "$@" >> "$(dirname "$0")/calls.log"
[ -n "{fail}" ] && case "$*" in *{fail}*) echo "error in {fail}"; exit 1;; esac
touch "$out"
"""


@pytest.mark.parametrize("fail", ["", "vorbis_dense.cu"])
def test_build_one_nvcc_per_source_then_link(monkeypatch, tmp_path, fail):
    # A stand-in nvcc that writes its -o file (or fails on one source):
    # every .cu compiles on its own, one link follows only if all
    # succeeded, and no object file is left behind either way.
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.replace("{fail}", fail))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    cus = [s for s in _build._sources() if s.suffix == ".cu"]
    if fail:
        with pytest.raises(RuntimeError, match=f"error in {fail}"):
            _build.build()
    else:
        so = _build.build()
        assert so.exists() and so.parent == tmp_path / "_build"
    calls = (tmp_path / "calls.log").read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split(" -c ")[1].split()[0] for c in compiles) == sorted(
        str(s) for s in cus)
    assert sum("-shared" in c for c in calls) == (0 if fail else 1)
    assert not list((tmp_path / "_build").glob("*.o"))


def test_build_hash_follows_sources():
    srcs = _build._sources()
    assert {s.name for s in srcs} >= {"flac_dense.cu", "mp3_dense.cu",
                                      "aac_dense.cu", "vorbis_dense.cu",
                                      "pcm.cu", "rice_device.cu",
                                      "simt_gemm.cuh"}
    assert _build._source_hash(srcs) == _build._source_hash(srcs)
    assert set(_build.LAUNCHES) == set(_build.KERNELS)


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_every_kernel_has_a_c_entry_point(kernel):
    # V2, P1, R1, F1's helper, F3, M0 and M3 among them: a counted launch
    # and a declared signature.
    assert len(_build.KERNELS) == 16
    assert {"vorbis_lap", "pcm_unpack", "rice_decode",
            "flac_lane_order", "flac_md5",
            "mp3_entropy", "mp3_place"} <= set(_build.KERNELS)
    assert f"{kernel}_launch" in _build._SIGNATURES
    assert any(f"{kernel}_launch(" in s.read_text()
               for s in _build._sources() if s.suffix == ".cu")


# The C exports that report a kernel's registers, local bytes and blocks
# per SM (chip_smoke.py fails a run on a spill), and the source of each.
_ATTRIBUTE_EXPORTS = {
    "flac_lpc_attributes": "flac_dense.cu",
    "flac_md5_attributes": "flac_dense.cu",
    "mp3_hybrid_attributes": "mp3_dense.cu",
    "mp3_synth_attributes": "mp3_dense.cu",
    "aac_imdct_attributes": "aac_dense.cu",
    "aac_ola_attributes": "aac_dense.cu",
    "vorbis_imdct_attributes": "vorbis_dense.cu",
    "pcm_unpack_attributes": "pcm.cu",
    "rice_decode_attributes": "rice_device.cu",
    "mp3_entropy_attributes": "mp3_entropy.cu",
    "mp3_place_attributes": "mp3_place.cu",
}


@pytest.mark.parametrize("export", sorted(_ATTRIBUTE_EXPORTS))
def test_attribute_exports_have_c_entry_points(export):
    # Each is an extern "C" function of its kernel's source, on
    # simt_gemm::attributes or the CUDA runtime's queries, and
    # chip_smoke.py reads it.
    assert len(_ATTRIBUTE_EXPORTS) == 11
    src = (_build.CSRC / _ATTRIBUTE_EXPORTS[export]).read_text()
    assert f'extern "C" int {export}(' in src
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert f".{export}" in smoke
    assert len(_build.KERNELS) == 16


def test_launch_errors_raise():
    with pytest.raises(RuntimeError, match="flac_lpc: CUDA error 98"):
        _build.check("flac_lpc", 98)
    _build.check("flac_lpc", 0)


def _wav():
    from test_wav_pcm import make_wav

    rng = np.random.default_rng(3)
    return make_wav(rng.integers(-30000, 30000, size=(600, 2)), rate=8000)


def _adpcm():
    from test_adpcm import ima_encode, make_adpcm_wav, smooth_signal

    sig = smooth_signal(1000, 31)
    payload, block_align = ima_encode(sig)
    return make_adpcm_wav(payload, 0x11, block_align, 505, len(sig))


def _vorbis():
    import importlib.util
    import pathlib

    pg = importlib.util.find_spec("pygame").submodule_search_locations[0]
    return (pathlib.Path(pg) / "examples/data/house_lo.ogg").read_bytes()


def _layer2():
    from test_layer12 import _rand_l2_frame

    return b"".join(_rand_l2_frame(s)[0] for s in range(3))


def _flac():
    from flac_builder import build_flac_file, random_walk

    return build_flac_file(random_walk(512, 16, seed=4), block_size=256,
                           kind="fixed", order=1)


@pytest.mark.parametrize("make,channels", [(_vorbis, 1), (_layer2, 1),
                                           (_wav, 2), (_adpcm, 1)])
def test_codec_in_slice_decodes(make, channels):
    # The inputs that raised before their slices were ported: WAV and IMA
    # ADPCM take the per-packet loop, counted in packet_routes.
    data = make()
    packet = make in (_wav, _adpcm)
    before = (port.host_routes, port.packet_routes)
    one = port.decode_bytes(data, device="cpu")
    assert port.packet_routes == before[1] + packet
    both = port.decode_many([_flac(), data], device="cpu")
    assert port.host_routes == before[0]
    assert port.packet_routes == before[1] + 2 * packet
    assert one.samples.shape[0] == channels and one.samples.shape[1] > 0
    assert np.isfinite(one.samples).all() and one.samples.any()
    np.testing.assert_array_equal(both[1].samples, one.samples)
    assert both[0].samples.shape == (1, 512)


def test_example_and_bench_tool_never_import_jax(tmp_path):
    # The per-packet path, the batch serving example, the Rice bench tool,
    # the bench and the soak run in a fresh interpreter that refuses the
    # reference package and JAX.
    (tmp_path / "a.wav").write_bytes(_wav())
    (tmp_path / "b.wav").write_bytes(_adpcm())
    code = _REFUSE + textwrap.dedent("""
        import pathlib
        sys.path.insert(0, sys.argv[1])
        d = pathlib.Path(sys.argv[2])
        from symphonia_tpu_torch import batch
        from symphonia_tpu_torch.examples import batch_serving
        from symphonia_tpu_torch.tools import bench_rice_device
        assert batch_serving.main([str(d / "a.wav"), str(d / "b.wav")],
                                  device="cpu") == 0
        assert batch.packet_routes == 2
        res = bench_rice_device.main(B=8, n=16, k=4, iters=1, device="cpu")
        assert res["correct_slice"] is True
        from symphonia_tpu_torch.tools import bench, soak
        res = bench.main(device="cpu", passes=1, min_passes=1, sizes={
            "flac_device": dict(n_frames=2, block=256, iters=1),
            "mp3_device": dict(n_granules=4, iters=1),
            "aac_device": dict(n_frames=4, iters=1),
            "vorbis_device": dict(n_lanes=4, iters=1)})
        assert len(res["stages"]) == 11 and res["value"] > 0
        assert soak.main(30, 3, device="cpu", max_inputs=6)["inputs"] == 6
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("symphonia_tpu", "jax", "jaxlib")]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, ROOT, str(tmp_path)],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert "a.wav: 2 ch" in proc.stdout and "b.wav: 1 ch" in proc.stdout
