"""P1 ``pcm_unpack`` (K12) on CPU: the port's ``decode_pcm_batch`` and its
plain twin against the JAX package's ``decode_pcm_batch_jax``, bit for bit
for every device codec (float32 compared as int32 bits: random bytes hold
NaNs), and demuxed packets of real containers, de-interleaved by the
caller, against ``decode_pcm_np``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu.ops import pcm as ref
from symphonia_tpu_torch import get_probe
from symphonia_tpu_torch.core.io import MediaSourceStream
from symphonia_tpu_torch.ops import _build
from symphonia_tpu_torch.ops import pcm as port

CODECS = sorted(port.DEVICE_CODECS)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == {np.int32: torch.int32,
                         np.float32: torch.float32}[want.dtype.type]
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_eighteen_device_codecs():
    assert len(CODECS) == 18
    assert not {"pcm_f64le", "pcm_f64be"} & set(CODECS)


@pytest.mark.parametrize("codec", CODECS)
def test_twin_matches_reference(codec):
    # N = 1031 is a multiple of no sample width above 1: every row drops
    # its trailing bytes. The first row holds the extreme byte patterns.
    rng = np.random.default_rng(CODECS.index(codec))
    x = rng.integers(0, 256, size=(9, 1031), dtype=np.uint8)
    x[0, :16] = [0x00, 0xFF, 0x80, 0x7F] * 4
    want = ref.decode_pcm_batch_jax(jnp.asarray(x), codec)
    _same(port.decode_pcm_batch_plain(torch.from_numpy(x), codec), want)
    before = dict(_build.LAUNCHES)
    _same(port.decode_pcm_batch(torch.from_numpy(x), codec), want)
    assert _build.LAUNCHES == before  # a CPU tensor takes the twin


@pytest.mark.parametrize("codec", ["pcm_s24be", "pcm_u8", "pcm_f32le"])
@pytest.mark.parametrize("shape", [(3, 2), (1, 4), (0, 12)])
def test_short_and_empty_batches(codec, shape):
    x = np.arange(int(np.prod(shape)), dtype=np.uint8).reshape(shape)
    want = ref.decode_pcm_batch_jax(jnp.asarray(x), codec)
    _same(port.decode_pcm_batch(torch.from_numpy(x), codec), want)


@pytest.mark.parametrize("codec", ["pcm_f64le", "pcm_f64be", "pcm_s20le",
                                   "flac"])
def test_codec_without_kernel_raises(codec):
    x = np.zeros((2, 16), np.uint8)
    with pytest.raises(ValueError):
        ref.decode_pcm_batch_jax(jnp.asarray(x), codec)
    with pytest.raises(ValueError):
        port.decode_pcm_batch(torch.from_numpy(x), codec)
    with pytest.raises(ValueError):
        port.decode_pcm_batch_plain(torch.from_numpy(x), codec)


def test_batch_must_be_uint8_rows():
    with pytest.raises(ValueError):
        port.decode_pcm_batch(torch.zeros((2, 8), dtype=torch.int8),
                              "pcm_s16le")
    with pytest.raises(ValueError):
        port.decode_pcm_batch(torch.zeros(8, dtype=torch.uint8), "pcm_s16le")


def _frames(bits, n=9000, ch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, ch))


def _container(kind):
    from symphonia_tpu_torch.testing import (aiff_caf_builder, mp4_builder,
                                             wav_builder)

    if kind == "wav_f32":
        f = (np.random.default_rng(1).standard_normal((9000, 2)) * 0.3)
        return wav_builder.make_wav(f.astype(np.float32), fmt_tag=3)
    if kind.startswith("wav_"):
        bits = int(kind[4:])
        return wav_builder.make_wav(_frames(bits, ch=1 + bits % 3),
                                    rate=8000, bits=bits)
    if kind == "aiff":
        return aiff_caf_builder.make_aiff(_frames(16, ch=1))
    if kind == "aiff_s24":
        return aiff_caf_builder.make_aiff(_frames(24), bits=24)
    if kind == "caf":
        return aiff_caf_builder.make_caf(_frames(16, n=90))
    return mp4_builder.build_pcm_m4a(_frames(16, ch=2).T.astype(np.int16),
                                     frames_per_chunk=128)


@pytest.mark.parametrize("kind", ["wav_8", "wav_16", "wav_24", "wav_32",
                                  "wav_f32", "aiff", "aiff_s24", "caf",
                                  "mp4"])
def test_demuxed_packets_deinterleave_to_decode_pcm_np(kind):
    # The reference's contract: the caller pads packets into one batch,
    # then de-interleaves and trims each row to its packet.
    fmt = get_probe().probe(MediaSourceStream(_container(kind))).format
    params = fmt.default_track().codec_params
    codec, ch = params.codec, params.channels.count
    pkts = []
    while (p := fmt.next_packet()) is not None:
        pkts.append(bytes(p.data))
    assert len(pkts) > 1
    x = np.zeros((len(pkts), max(len(p) for p in pkts) + 3), np.uint8)
    for r, p in enumerate(pkts):
        x[r, : len(p)] = np.frombuffer(p, np.uint8)
    got = port.decode_pcm_batch(torch.from_numpy(x), codec).numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(ref.decode_pcm_batch_jax(jnp.asarray(x), codec)))
    bps = port.DEVICE_CODECS[codec][0]
    for r, p in enumerate(pkts):
        planar = got[r, : len(p) // (bps * ch) * ch].reshape(-1, ch).T
        want = port.decode_pcm_np(p, codec, ch, params.bits_per_coded_sample)
        assert planar.dtype == want.dtype
        np.testing.assert_array_equal(_bits(planar), _bits(want))
