"""End-to-end multi-card shell on real streams, the port's mirror of
``tests/test_multichip_integration.py``: each stream goes through the
port's own host stage and native extraction, then the port's dense stage
sharded over a 4 x 2 mesh of eight gloo ranks on the CPU (``parallel.
step``: lane blocks with their halos, tp column blocks, all-gather), and
is held to the JAX package's unsharded dense stage on the same bytes.

The eight ranks run once for the whole module (one spawn: FLAC, two MP3
streams, AAC, Vorbis). Bars: FLAC bit for bit (and equal to the encoded
source); MP3, AAC and Vorbis within 1e-5 absolute, as the reference's
test holds its sharded stage (``_assert_close``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from symphonia_tpu_torch.parallel import mesh as port_mesh
from symphonia_tpu_torch.parallel import step

from flac_builder import build_flac_file, random_walk

def _pygame_data(name: str) -> str:
    """The path of a media file that pygame ships (its examples' data)."""
    import importlib.util

    spec = importlib.util.find_spec("pygame")
    if spec is None:
        pytest.skip("pygame (and its example media) is not installed")
    return os.path.join(spec.submodule_search_locations[0], "examples",
                        "data", name)
BAR = 1e-5


def _assert_close(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=BAR, rtol=0)
    assert np.abs(ref).max() > 0  # the stream carried real audio


# ---------------------------------------------------------------------------
# The streams
# ---------------------------------------------------------------------------


def _flac_stream():
    ch = random_walk(512 * 32, 16, seed=77, ch=2)
    data = build_flac_file(ch, block_size=512, stereo_mode="mid_side",
                           kind="lpc", lpc_coefs=[1800, -900, 120],
                           lpc_shift=10)
    return ch, data


def _mp3_streams():
    from mp3_builder import build_mpeg1_l3_stream

    with open(_pygame_data("house_lo.mp3"), "rb") as f:
        house = f.read()
    return {"mpeg25_mono": house,
            "mpeg1_stereo": build_mpeg1_l3_stream(12, n_ch=2, seed=40)}


def _aac_stream(rate=48000):
    from aac_builder import build_adts, build_raw_block, random_quant_spectrum

    rng = np.random.default_rng(48)
    frames = []
    for _ in range(10):
        q0 = random_quant_spectrum(rng, 40, rate)
        q1 = random_quant_spectrum(rng, 40, rate)
        frames.append(build_raw_block([q0, q1], [0, 0], 40, 140, rate))
    return build_adts(frames, rate, 2)


def _vorbis_stream():
    with open(_pygame_data("house_lo.ogg"), "rb") as f:
        return f.read()


def _flac_lanes(pkg, data):
    """(packed lanes of ``pkg``'s native FLAC extraction, block size)."""
    import importlib

    native = importlib.import_module(pkg + ".native")
    FlacReader = importlib.import_module(pkg + ".formats.flac").FlacReader
    io = importlib.import_module(pkg + ".core.io")
    reader = FlacReader(io.MediaSourceStream(data))
    si = reader.stream_info
    reader._ensure_scan()
    starts = reader._frame_starts
    ends = np.empty(len(starts), np.int64)
    ends[:-1] = starts[1:]
    ends[-1] = len(reader._buf)
    packed = native.flac_extract(reader._buf, starts, ends - starts, si, 512)
    assert (packed["status"] == 0).all()
    return packed


# ---------------------------------------------------------------------------
# The eight ranks
# ---------------------------------------------------------------------------


def _shard_body(rank, mesh, flac, mp3s, aac, vorbis):
    """Every stage sharded on ``rank``; rank 0 returns the gathered outputs
    as numpy."""
    import torch

    from symphonia_tpu_torch import entry

    k, dev, r = entry._stages(False), rank.device, rank.rank
    arrays, n_max = flac
    chans, sfb = aac
    sfb = torch.as_tensor(sfb).to(dev)
    # Vorbis: one IMDCT group per block size, lanes sharded with no halo
    # (the reference stitches the laps on the host).
    vd = entry._constants(dev).vorbis
    stages = ([step.flac_stage(k, arrays, n_max)]
              + [step.mp3_stage(k, lanes) for lanes in mp3s.values()]
              + [step.aac_stage(k, lanes, sfb) for lanes in chans]
              + [step.Stage(lambda x, n=n: k.vorbis_imdct(x, vd.matrix(n)),
                            (lanes,), 0) for n, lanes in vorbis.items()])
    outs, _ = step.sharded_stages(stages, mesh, r, dev)
    outs = list(outs)
    out = {"flac": outs.pop(0)}
    for name in mp3s:
        out["mp3_" + name] = outs.pop(0)
    out["aac"] = [outs.pop(0) for _ in chans]
    out["vorbis"] = {n: outs.pop(0) for n in vorbis}
    if r:
        return None
    to_np = lambda t: t.numpy() if isinstance(t, torch.Tensor) else t  # noqa
    return {key: (to_np(v) if not isinstance(v, (list, dict)) else
                  [to_np(x) for x in v] if isinstance(v, list) else
                  {n: to_np(x) for n, x in v.items()})
            for key, v in out.items()}


@pytest.fixture(scope="module")
def sharded():
    """The port's host stage on every stream, then one run of eight gloo
    ranks on a 4 x 2 mesh."""
    from symphonia_tpu_torch import native
    from symphonia_tpu_torch.batch import (AacBatchDecoder, Mp3BatchDecoder,
                                           VorbisBatchDecoder, _probe)
    from symphonia_tpu_torch.ops.aac_dense import LANE_KEYS

    if not native.available():
        pytest.skip("native engine required for the extraction stage")
    mesh = port_mesh.make_mesh(8, dp=4, tp=2)
    ch, flac_data = _flac_stream()
    p = _flac_lanes("symphonia_tpu_torch", flac_data)
    F, C, n_max = p["F"], p["C"], p["n_max"]
    assert C == 2
    flac = ((p["res"].reshape(F, 2, n_max), p["coefs"].reshape(F, 2, 32),
             p["order"].reshape(F, 2), p["shift"].reshape(F, 2),
             p["wasted"].reshape(F, 2), p["assign"][:F]), n_max)
    mp3s = {}
    for name, data in _mp3_streams().items():
        lanes = Mp3BatchDecoder._extract(_probe(data)[1])
        assert lanes is not None
        mp3s[name] = lanes
    dec, chans = AacBatchDecoder._extract_host(_probe(_aac_stream())[1])
    sfb = native.aac_sfb_map(np.asarray(dec.bands_long))
    aac = ([tuple(c[k] for k in LANE_KEYS) for c in chans], sfb)
    _, vdec, spectra, flags, _ = VorbisBatchDecoder._extract_host(
        _probe(_vorbis_stream())[1])
    groups = {}
    for p_, f in enumerate(flags):
        n = vdec.bs1 if f else vdec.bs0
        for c in range(spectra[p_].shape[0]):
            groups.setdefault(n, []).append(spectra[p_][c][: n // 2])
    vorbis = {n: np.stack(v) for n, v in groups.items()}
    out = step.spawn(8, _shard_body, (mesh, flac, mp3s, aac, vorbis),
                     backend="gloo", device="cpu")[0]
    return out, dict(flac=(ch, F, n_max), vorbis=(vdec, flags))


# ---------------------------------------------------------------------------
# The JAX package's unsharded stages on the same bytes
# ---------------------------------------------------------------------------


def test_flac_sharded_bit_exact(sharded):
    from symphonia_tpu.ops import flac_dense

    out, info = sharded
    ch, F, n_max = info["flac"]
    p = _flac_lanes("symphonia_tpu", _flac_stream()[1])

    def _decode(res, coefs, order, shift, wasted, assign):
        x = flac_dense.lpc_reconstruct_batch(res, coefs, order, shift, n_max)
        x = flac_dense.apply_wasted_bits(x, wasted)
        return flac_dense.decorrelate_batch(x.reshape(-1, 2, n_max), assign)

    args = [p[k] for k in ("res", "coefs", "order", "shift", "wasted")]
    want = np.asarray(jax.jit(_decode)(
        *(jnp.asarray(a) for a in args + [p["assign"][:F]])))
    got = out["flac"]
    assert got.dtype == np.int32 and got.shape == (F, 2, n_max)
    np.testing.assert_array_equal(got, want)
    stream = got.transpose(1, 0, 2).reshape(2, -1)[:, : 512 * 32]
    np.testing.assert_array_equal(stream, np.stack(ch).astype(np.int32))


@pytest.mark.parametrize("name", ["mpeg25_mono", "mpeg1_stereo"])
def test_mp3_sharded_matches_unsharded(sharded, name):
    from symphonia_tpu import native
    from symphonia_tpu.core.io import MediaSourceStream
    from symphonia_tpu.formats.mpa import MpaReader
    from symphonia_tpu.ops.mp3_dense import mp3_dense_batch_jax

    out, _ = sharded
    reader = MpaReader(MediaSourceStream(_mp3_streams()[name]))
    ext = native.mp3_extract(reader._buf, reader._offsets, reader._sizes,
                             max_granules=2 * len(reader._offsets) + 2)
    G, C = ext["n_granules"], reader.header.n_channels
    args = (np.array(ext["spectra"][:G, :C]), np.array(ext["bt"][:G, :C]),
            np.array(ext["mixed"][:G, :C]).astype(bool))
    want = np.asarray(jax.jit(mp3_dense_batch_jax)(
        *(jnp.asarray(a) for a in args))[0])
    assert want.shape == (G, C, 576)
    _assert_close(out["mp3_" + name], want)


def test_aac_sharded_matches_batch_decoder(sharded):
    from symphonia_tpu.batch import AacBatchDecoder

    out, _ = sharded
    ref = AacBatchDecoder().decode_bytes(_aac_stream())
    assert ref.sample_rate == 48000
    got = np.stack([c.reshape(-1) for c in out["aac"]])
    _assert_close(got, ref.samples)


def test_vorbis_sharded_imdct_matches_dense_stage(sharded):
    from symphonia_tpu.batch import VorbisBatchDecoder
    from symphonia_tpu.ops.vorbis_dense import decode_packets_dense
    from symphonia_tpu_torch.ops.vorbis_dense import lap_stitch

    out, info = sharded
    vdec, flags = info["vorbis"]
    dec, _, spectra, rflags, _ = VorbisBatchDecoder()._extract_host(
        _vorbis_stream())
    assert list(rflags) == list(flags) and len(flags) > 8
    want = decode_packets_dense(spectra, rflags, dec.bs0, dec.bs1)
    C = spectra[0].shape[0]
    rows = {n: 0 for n in out["vorbis"]}
    imdcts = [[None] * len(flags) for _ in range(C)]
    for p, f in enumerate(flags):
        n = vdec.bs1 if f else vdec.bs0
        for c in range(C):
            imdcts[c][p] = out["vorbis"][n][rows[n]]
            rows[n] += 1
    assert all(rows[n] == len(out["vorbis"][n]) for n in rows)
    got = np.stack([lap_stitch(imdcts[c], flags, vdec.bs0, vdec.bs1)
                    for c in range(C)])
    _assert_close(got, want)
