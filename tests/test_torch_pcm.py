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


# ---------------------------------------------------------------------------
# The shapes the kernel's vector path must not mishandle (the twin against
# the reference here; the kernel against the twin on the card)
# ---------------------------------------------------------------------------


def _misaligned(case):
    """A [B, N] uint8 tensor (one of them a view at storage offset 1)."""
    rng = np.random.default_rng(len(case))
    if case == "rows_misaligned":      # N % 4 != 0 and n % 4 != 0, any bps
        shape = (5, 16387)
    elif case == "storage_offset_1":
        flat = rng.integers(0, 256, size=6 * 1024 + 1, dtype=np.uint8)
        return torch.from_numpy(flat)[1:].view(6, 1024)
    elif case == "one_row":
        shape = (1, 4099)
    else:
        shape = (7, 16)                # short rows
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.parametrize("case", ["rows_misaligned", "storage_offset_1",
                                  "one_row", "short_rows"])
@pytest.mark.parametrize("codec", CODECS)
def test_twin_at_misaligned_shapes(codec, case):
    t = _misaligned(case)
    if case == "storage_offset_1":
        assert t.storage_offset() == 1 and t.is_contiguous()
    want = ref.decode_pcm_batch_jax(jnp.asarray(t.numpy()), codec)
    _same(port.decode_pcm_batch(t, codec), want)


def _mulaw_in_registers(u):
    """The kernel's mu-law expansion (csrc/pcm.cu ``finish``), in numpy
    uint32 / int32 arithmetic."""
    v = ~u.astype(np.uint32)
    t = ((((v & 0x0F) << 3) + 0x84) << ((v & 0x70) >> 4)) - 0x84
    t = t.astype(np.int32)
    return np.where(v & 0x80, -t, t)


def _alaw_in_registers(a):
    """The kernel's A-law expansion, branch-free as the kernel has it."""
    v = a.astype(np.uint32) ^ 0x55
    seg = (v & 0x70) >> 4
    t = (((v & 0x0F) << 4) + np.where(seg == 0, 8, 0x108).astype(np.uint32)) \
        << np.where(seg > 1, seg - 1, 0).astype(np.uint32)
    t = t.astype(np.int32)
    return np.where(v & 0x80, t, -t)


@pytest.mark.parametrize("codec,formula,table", [
    ("pcm_mulaw", _mulaw_in_registers, port.MULAW_TABLE),
    ("pcm_alaw", _alaw_in_registers, port.ALAW_TABLE),
])
@pytest.mark.parametrize("sign_extended", [False, True])
def test_g711_in_registers_equals_tables(codec, formula, table,
                                         sign_extended):
    # All 256 bytes. The kernel hands the formula the byte sign-extended
    # (only its low byte may matter), so both forms must give the table.
    u = np.arange(256, dtype=np.uint32)
    if sign_extended:
        u = u.astype(np.uint8).astype(np.int8).astype(np.int32).astype(
            np.uint32)
    got = formula(u)
    np.testing.assert_array_equal(got, table.astype(np.int32))
    x = np.arange(256, dtype=np.uint8).reshape(4, 64)
    _same(port.decode_pcm_batch(torch.from_numpy(x), codec),
          got.reshape(4, 64).astype(np.int32))
    _same(port.decode_pcm_batch(torch.from_numpy(x), codec),
          ref.decode_pcm_batch_jax(jnp.asarray(x), codec))


@pytest.mark.parametrize("bps,be", [(1, False), (2, False), (2, True),
                                    (3, False), (3, True), (4, False),
                                    (4, True)])
def test_byte_perm_selectors_extract_sign_extended_samples(bps, be):
    # The kernel's __byte_perm selectors (csrc/pcm.cu ``selector``),
    # modelled: result byte i of sample k is a byte of the pair of words
    # holding it, the bytes above the sample replicate its sign; a group of
    # four samples from 4 * bps random bytes equals the twin's signed codec.
    rng = np.random.default_rng(bps * 2 + be)
    raw = rng.integers(0, 256, size=(50, 4 * bps), dtype=np.uint8)
    raw[0] = 0x80
    raw[1] = 0x7F
    words = raw.view("<u4")
    words = np.concatenate([words, np.zeros((50, 1), np.uint32)], axis=1)
    got = np.zeros((50, 4), np.int64)
    for k in range(4):
        wi, f = k * bps // 4, k * bps % 4
        pair = (words[:, wi].astype(np.uint64)
                | (words[:, wi + 1].astype(np.uint64) << np.uint64(32)))
        out = np.zeros(50, np.uint32)
        for i in range(4):
            if i < bps:
                src, sign = (f + bps - 1 - i if be else f + i), False
            else:
                src, sign = (f if be else f + bps - 1), True
            byte = ((pair >> np.uint64(8 * src)) & np.uint64(0xFF)).astype(
                np.uint32)
            if sign:
                byte = np.where(byte & 0x80, 0xFF, 0).astype(np.uint32)
            out |= byte << np.uint32(8 * i)
        got[:, k] = out.astype(np.int32)
    name = {1: "pcm_s8", 2: "pcm_s16", 3: "pcm_s24", 4: "pcm_s32"}[bps]
    codec = name if bps == 1 else name + ("be" if be else "le")
    want = port.decode_pcm_batch_plain(torch.from_numpy(raw), codec).numpy()
    np.testing.assert_array_equal(got, want)
    # ... and the unsigned finish is the sign-extended word with its sign
    # bit and everything above flipped.
    flip = (0xFFFFFFFF << (8 * bps - 1)) & 0xFFFFFFFF
    ucodec = codec.replace("pcm_s", "pcm_u")
    uwant = port.decode_pcm_batch_plain(torch.from_numpy(raw), ucodec).numpy()
    np.testing.assert_array_equal(
        (got.astype(np.int64) & 0xFFFFFFFF ^ flip).astype(np.uint32).astype(
            np.int32), uwant)
