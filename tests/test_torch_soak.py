"""The port's mutation soak (``symphonia_tpu_torch/tools/soak.py``) against
the repository's ``tools/soak.py`` on the CPU: the same builders give the
same bytes from the same seed, mutated streams decode to the same result
(or the same error) through the reference's and the port's
``decode_bytes``, and a bounded soak ends inside the error taxonomy."""

import ast
import pathlib

import numpy as np
import pytest

from symphonia_tpu import batch as ref_batch
from symphonia_tpu.core import errors as ref_errors
from symphonia_tpu_torch import batch as port_batch
from symphonia_tpu_torch.tools import soak

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference_soak() -> dict:
    """``builders`` and ``mutate`` of ``tools/soak.py``, without its module
    body (which configures JAX for a process of its own)."""
    src = (ROOT / "tools" / "soak.py").read_text()
    keep = [n for n in ast.parse(src).body
            if isinstance(n, ast.FunctionDef)
            and n.name in ("builders", "mutate")]
    ns = {"np": np, "Path": pathlib.Path}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "tools/soak.py",
                 "exec"), ns)
    return ns


REF = _reference_soak()
# Every builder but ``ogg``, which reads a file of an installed package in
# the reference and writes a Vorbis stream from the generator in the port.
NAMES = [f.__name__ for f in soak.builders(np.random.default_rng(0))
         if f.__name__ != "ogg"]


def _build(builders, mutate, name, seed):
    rng = np.random.default_rng(seed)
    data = {f.__name__: f for f in builders(rng)}[name]()
    return data, mutate(data, rng)


def test_builder_lists_match():
    ref_names = [f.__name__ for f in REF["builders"](
        np.random.default_rng(0))]
    port_names = [f.__name__ for f in soak.builders(np.random.default_rng(0))]
    assert ref_names == port_names and len(port_names) == 19


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("name", NAMES)
def test_builder_bytes_equal(name, seed):
    # Built and mutated from one generator: the same bytes as the
    # reference's soak, and the same mutation after them.
    want = _build(REF["builders"], REF["mutate"], name, seed)
    got = _build(soak.builders, soak.mutate, name, seed)
    assert len(got[0]) > 50
    assert got == want


def test_ogg_builder_writes_vorbis():
    rng = np.random.default_rng(5)
    fns = {f.__name__: f for f in soak.builders(rng)}
    data = fns["ogg"]()
    assert data[:4] == b"OggS" and b"vorbis" in data[:100]
    out = port_batch.decode_bytes(data, device="cpu")
    assert out.samples.shape[0] == 2 and out.samples.shape[1] > 0
    assert np.isfinite(out.samples).all() and out.samples.any()


# The lossy codecs' parity bars (ROADMAP's North star): MP3 2e-5 and AAC
# 1e-5 absolute, Vorbis builder streams 1e-6 of the peak.
LOSSY = {"mp3": ("abs", 2e-5), "aac": ("abs", 1e-5), "m4a": ("abs", 1e-5),
         "fmp4": ("abs", 1e-5), "ogg": ("peak", 1e-6)}
# Eight builders, each stream and two mutations of it (24 inputs): the
# four batch codecs, PCM in WAV and AIFF, AAC in MP4 and fragmented MP4.
COMPARED = ["flac", "mp3", "aac", "ogg", "wav", "m4a", "fmp4", "aiff"]


def _inputs():
    out = []
    for i, name in enumerate(COMPARED):
        rng = np.random.default_rng(1000 + i)
        fns = {f.__name__: f for f in soak.builders(rng)}
        base = fns[name]()
        out += [(name, k, v) for k, v in enumerate(
            (base, soak.mutate(base, rng), soak.mutate(base, rng)))]
    return out


# The reference's error taxonomy (tools/soak.py:408-409), its own classes.
REF_ERRORS = (ref_errors.DecodeError, ref_errors.IoError,
              ref_errors.LimitError, ref_errors.ResetRequired,
              ref_errors.SeekError, ref_errors.Unsupported, EOFError)


def _decode(decode_bytes, data, errors, **kw):
    """The decoded audio, or the name of the taxonomy error raised."""
    try:
        return decode_bytes(data, **kw)
    except errors as e:
        return type(e).__name__


@pytest.fixture(scope="module")
def mutated():
    return _inputs()


@pytest.mark.parametrize("i", range(24))
def test_mutated_input_decodes_as_reference(mutated, i):
    name, k, data = mutated[i]
    want = _decode(ref_batch.decode_bytes, data, REF_ERRORS)
    got = _decode(port_batch.decode_bytes, data, soak.OK_ERRORS,
                  device="cpu")
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    assert got.sample_rate == want.sample_rate
    assert got.samples.shape == want.samples.shape
    assert got.samples.dtype == want.samples.dtype
    if name in LOSSY:
        kind, tol = LOSSY[name]
        peak = float(np.abs(want.samples).max(initial=0.0))
        bar = tol * peak if kind == "peak" else tol
        assert np.abs(got.samples.astype(np.float64)
                      - want.samples).max(initial=0.0) <= bar
    else:
        np.testing.assert_array_equal(got.samples, want.samples)


def test_mutated_inputs_cover_the_batch_codecs(mutated):
    decoded = {name for name, _k, data in mutated
               if not isinstance(_decode(port_batch.decode_bytes, data,
                                         soak.OK_ERRORS, device="cpu"), str)}
    assert {"flac", "mp3", "aac", "ogg", "wav", "aiff"} <= decoded


def test_bounded_soak_stays_in_taxonomy():
    res = soak.main(seconds=30, seed=7, device="cpu", max_inputs=9, keep=2)
    assert res["inputs"] == 9 and res["rounds"] == 3
    assert 0 < res["decoded"] <= 9 and not res["slow"]
    assert len(res["kept"]) == 2
    builder, rnd, k, data, samples = res["kept"][0]
    np.testing.assert_array_equal(
        port_batch.decode_bytes(data, device="cpu").samples, samples)


@pytest.mark.parametrize("group", range(8), ids=COMPARED)
def test_mutated_group_merged_as_reference(mutated, group):
    # The soak's merged pass: a stream and its two mutations in one
    # decode_many, which fails fast on the first undecodable stream. The
    # same error, or the same outputs, as the reference's decode_many.
    name = COMPARED[group]
    datas = [d for _n, _k, d in mutated[3 * group:3 * group + 3]]
    want = _decode(ref_batch.decode_many, datas, REF_ERRORS)
    got = _decode(port_batch.decode_many, datas, soak.OK_ERRORS,
                  device="cpu")
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    for a, b in zip(got, want):
        assert a.samples.shape == b.samples.shape
        if name in LOSSY:
            kind, tol = LOSSY[name]
            peak = float(np.abs(b.samples).max(initial=0.0))
            bar = tol * peak if kind == "peak" else tol
            assert np.abs(a.samples.astype(np.float64)
                          - b.samples).max(initial=0.0) <= bar
        else:
            np.testing.assert_array_equal(a.samples, b.samples)
