"""The soak's edge inputs (``symphonia_tpu_torch.testing.edge_streams``:
one FLAC frame, one MP3 frame or none, one AAC lane, a few Vorbis packets,
each also cut short) through the reference's and the port's batch decoders
on the CPU: the same result or the same error, alone and merged."""

import numpy as np
import pytest

from symphonia_tpu import batch as ref_batch
from symphonia_tpu_torch import batch as port_batch
from symphonia_tpu_torch.testing.edge_streams import edge_inputs
from symphonia_tpu_torch.tools import soak
from test_torch_soak import REF_ERRORS, _decode

EDGE = edge_inputs(20261016)


def _assert_as_reference(name, got, want):
    # FLAC bit for bit; MP3 2e-5 and AAC 1e-5 absolute; Vorbis builder
    # streams 1e-6 of the peak.
    assert got.samples.shape == want.samples.shape
    assert got.samples.dtype == want.samples.dtype
    codec = name.split("_")[0]
    if codec == "flac":
        np.testing.assert_array_equal(got.samples, want.samples)
        return
    bar = {"mp3": 2e-5, "aac": 1e-5}.get(codec, 0.0)
    if codec == "vorbis":
        bar = 1e-6 * float(np.abs(want.samples).max(initial=0.0))
    assert np.abs(got.samples.astype(np.float64)
                  - want.samples).max(initial=0.0) <= bar


@pytest.mark.parametrize("i", range(len(EDGE)), ids=[n for n, _ in EDGE])
def test_edge_input_decodes_as_reference(i):
    # One FLAC frame, one MP3 frame or none, one AAC lane, a few Vorbis
    # packets, each also cut short: the shapes the batch decoders pack
    # from malformed streams.
    name, data = EDGE[i]
    want = _decode(ref_batch.decode_bytes, data, REF_ERRORS)
    got = _decode(port_batch.decode_bytes, data, soak.OK_ERRORS,
                  device="cpu")
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    _assert_as_reference(name, got, want)


def test_edge_inputs_merged():
    # The decodable edge inputs in one decode_many (merged dispatch across
    # one-lane streams): each as the reference's merged decode_many gives
    # it, and equal to the port's own decode_bytes of it.
    ok = [(n, d) for n, d in EDGE
          if not isinstance(_decode(port_batch.decode_bytes, d,
                                    soak.OK_ERRORS, device="cpu"), str)]
    assert len(ok) >= 15
    datas = [d for _, d in ok]
    merged = port_batch.decode_many(datas, device="cpu")
    want = ref_batch.decode_many(datas)
    assert len(merged) == len(want) == len(ok)
    for (name, d), out, ref in zip(ok, merged, want):
        _assert_as_reference(name, out, ref)
        one = port_batch.decode_bytes(d, device="cpu")
        assert out.samples.shape == one.samples.shape
        np.testing.assert_allclose(out.samples, one.samples, rtol=0,
                                   atol=1e-6)
