"""The mirror identity that A1 aac_imdct and V1 vorbis_imdct rest on.

Both kernels compute half of the IMDCT product, Z = x . M[h : h+K]^T with
h = K/2, and write the other half in their epilogue (csrc/simt_gemm.cuh):
y[h + j] = Z[j], y[h - 1 - j] = 0 - Z[j] (j < h), y[2K + h - 1 - j] = Z[j]
(h <= j < K). This holds bit for bit when row h-1-j of the float32 matrix
is the exact negation of row h+j and row 2K+h-1-j an exact copy of it:
checked here on the port's own matrices. The Vorbis n = 8192 matrix is the
one exception (1618 entries one ulp off), where V1 is held to its bars.
The map itself, written in numpy, rebuilds the dense twins' outputs from
their middle K columns within the phase 2 bars (AAC 1e-5, Vorbis 1e-6 of
the larger of 1 and the peak), and all-zero input rows give +0.0."""

import numpy as np
import pytest
import torch

from symphonia_tpu_torch.ops import aac_dense as ad
from symphonia_tpu_torch.ops import vorbis_dense as vd

VORBIS_EXACT = (64, 128, 256, 512, 1024, 2048, 4096)


@pytest.fixture(scope="module")
def aac():
    return ad.AacDense.from_numpy(ad.reference_tables(), "cpu")


@pytest.fixture(scope="module")
def vorbis():
    return vd.VorbisDense({}, "cpu")


def _matrix(name, aac, vorbis) -> np.ndarray:
    if name.startswith("aac"):
        return getattr(aac, name[4:]).numpy()
    return vorbis.matrix(int(name.split("_")[1])).numpy()


def _mirror_parts(m):
    """(rows 0..h-1, their mirror -M[h:2h] reversed, rows h+K.., their
    mirror M[2h:h+K] reversed) of a [2K, K] matrix."""
    K = m.shape[1]
    h = K // 2
    z = m[h:h + K]
    return m[:h], -z[:h][::-1], m[h + K:], z[h:][::-1]


def mirror(z: np.ndarray) -> np.ndarray:
    """The kernels' epilogue: Z [L, K] -> y [L, 2K]."""
    L, K = z.shape
    h = K // 2
    y = np.empty((L, 2 * K), np.float32)
    y[:, h:h + K] = z
    y[:, :h] = np.float32(0.0) - z[:, :h][:, ::-1]
    y[:, h + K:] = z[:, h:][:, ::-1]
    return y


@pytest.mark.parametrize(
    "name", ["aac_imdct_long", "aac_imdct_short"]
    + [f"vorbis_{n}" for n in VORBIS_EXACT])
def test_mirror_identity_is_exact(name, aac, vorbis):
    m = _matrix(name, aac, vorbis)
    assert m.dtype == np.float32 and m.shape[0] == 2 * m.shape[1]
    lo, lo_mirror, hi, hi_mirror = _mirror_parts(m)
    assert np.array_equal(lo, lo_mirror)
    assert np.array_equal(hi, hi_mirror)


def test_mirror_identity_at_8192_is_one_ulp_off(vorbis):
    lo, lo_mirror, hi, hi_mirror = _mirror_parts(vorbis.matrix(8192).numpy())
    diffs = []
    for a, b in ((lo, lo_mirror), (hi, hi_mirror)):
        off = a != b
        assert (np.sign(a[off]) == np.sign(b[off])).all()
        diffs.append(np.abs(a[off].view(np.int32).astype(np.int64)
                            - b[off].view(np.int32).astype(np.int64)))
    assert [d.size for d in diffs] == [466, 1152]
    assert max(int(d.max()) for d in diffs) == 1


def _inputs(seed, L, K, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((L, K)) * scale).astype(np.float32)
    x[1] = 0.0
    x[4] = 0.0
    return x


@pytest.mark.parametrize("case", ["aac_long", "aac_short", "vorbis_64",
                                  "vorbis_2048", "vorbis_8192"])
def test_mirror_map_rebuilds_the_dense_twin(case, aac, vorbis):
    if case.startswith("aac"):
        m = aac.imdct_long if case == "aac_long" else aac.imdct_short
        x = _inputs(7, 6, m.shape[1], 0.1)
        y = ad.aac_imdct_plain(torch.from_numpy(x), m).numpy()
        bar = 1e-5
    else:
        m = vorbis.matrix(int(case.split("_")[1]))
        x = _inputs(8, 6, m.shape[1], 100.0)
        y = vd.vorbis_imdct_plain(torch.from_numpy(x), m).numpy()
        bar = 1e-6
    K = m.shape[1]
    got = mirror(y[:, K // 2: K // 2 + K])
    np.testing.assert_allclose(got, y, rtol=0,
                               atol=bar * max(1.0, float(np.abs(y).max())))
    zero_rows = got[[1, 4]]
    assert (zero_rows == 0).all() and not np.signbit(zero_rows).any()


@pytest.mark.parametrize(
    "name", ["aac_imdct_long", "aac_imdct_short"]
    + [f"vorbis_{n}" for n in VORBIS_EXACT + (8192,)])
def test_no_two_terms_of_an_output_cancel(name, aac, vorbis):
    # With power-of-two inputs (exact products in the normal range), two
    # terms x_a m_a + x_b m_b of one output cancel exactly only where the
    # two entries share a mantissa. No row of the half matrices has such a
    # pair, so chip_smoke.py's exact zeros come from zero inputs (+0.0 and
    # -0.0 rows), not from a cancelling row.
    m = _matrix(name, aac, vorbis)
    K = m.shape[1]
    mant = np.sort(m[K // 2: K // 2 + K].view(np.uint32) & 0x7FFFFF, axis=1)
    assert not (np.diff(mant.astype(np.int64), axis=1) == 0).any()
