"""``decode_many``'s fail-fast order, the port against the reference: a
batch with two undecodable streams, one of them Layer II, raises the same
error first through both packages' ``decode_many``.

The reference decodes mp1/mp2 streams one by one in its first loop over
the batch, as it probes (``symphonia_tpu/batch.py:645-666``), before the
merged FLAC, MP3, AAC and Vorbis groups. A Layer II stream that probes
but cannot be decoded therefore raises before a later stream that cannot
be probed, and before an earlier undecodable FLAC stream."""

import logging

import numpy as np
import pytest

from symphonia_tpu import batch as ref
from symphonia_tpu_torch import batch as port


def _bad_layer2() -> bytes:
    """Four stereo Layer II frames with one byte of the fourth changed: it
    probes as mp2 and its decode runs out of bits (EndOfStream) in both
    packages."""
    from test_layer12 import _rand_l2_frame

    b = bytearray(b"".join(_rand_l2_frame(s, n_ch=2)[0] for s in range(4)))
    b[3761] = 96
    return bytes(b)


def _bad_flac() -> bytes:
    """A FLAC stream cut 60 bytes in: it probes (its STREAMINFO is whole),
    and its decode runs out of bits (EndOfStream), in the group pass."""
    from flac_builder import build_flac_file, random_walk

    data = build_flac_file(random_walk(4096, 16, seed=2, ch=2),
                           block_size=1024, kind="fixed", order=2)
    return data[:60]


def _layer2() -> bytes:
    from test_layer12 import _rand_l2_frame

    return b"".join(_rand_l2_frame(s, n_ch=2)[0] for s in range(3))


def _error(fn):
    try:
        fn()
    except Exception as e:  # the error each package raises is the point
        return type(e).__name__, str(e)
    return None


STREAMS = {"bad_l2": _bad_layer2, "garbage": lambda: b"\x00" * 64,
           "bad_flac": _bad_flac, "l2": _layer2}


@pytest.mark.parametrize("order", [
    ("bad_l2", "garbage"),
    ("garbage", "bad_l2"),
    ("bad_flac", "bad_l2"),
    ("l2", "bad_flac", "bad_l2", "garbage"),
    ("l2", "garbage", "bad_l2"),
    ("bad_l2",),
], ids="-".join)
def test_first_error_is_the_references(order):
    logging.disable(logging.CRITICAL)
    try:
        datas = [STREAMS[name]() for name in order]
        want = _error(lambda: ref.decode_many(datas))
        got = _error(lambda: port.decode_many(datas, device="cpu"))
    finally:
        logging.disable(logging.NOTSET)
    assert want is not None
    assert got == want


def test_bad_layer2_probes_and_fails_alike():
    data = _bad_layer2()
    assert port._probe(data)[0] == "mp2"
    want = _error(lambda: ref.decode_bytes(data))
    assert want is not None and want[0] == "EndOfStream"
    assert _error(lambda: port.decode_bytes(data, device="cpu")) == want


def test_layer2_in_a_batch_decodes_as_alone():
    # Decoded in the first loop now: the same samples as decode_bytes and
    # as the reference's decode_many.
    datas = [_layer2(), _layer2()[:-100]]
    got = port.decode_many(datas, device="cpu")
    want = ref.decode_many(datas)
    for g, w, d in zip(got, want, datas):
        np.testing.assert_array_equal(
            g.samples, port.decode_bytes(d, device="cpu").samples)
        assert g.samples.shape == w.samples.shape
        np.testing.assert_allclose(g.samples, w.samples, atol=2e-5, rtol=0)
