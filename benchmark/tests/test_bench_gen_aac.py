"""The AAC generator: deterministic by seed, byte-equal to the test
encoder and muxer it rewrites, and its float64 reference within the
configuration's tolerance of the port's CPU path."""

import json

import numpy as np
import pytest
import torch

from benchmark.gen import aac as gen
from benchmark.reference import aac as ref
from conftest import ROOT

CFG = json.loads((ROOT / "benchmark/configs/audioset_aac.json").read_text())
SMALL = dict(CFG, seconds=0.5, transient_every=4)


def test_deterministic_by_seed():
    a = gen.make_pool(SMALL, 2, 2**31 + 5)
    b = gen.make_pool(SMALL, 2, 2**31 + 5)
    c = gen.make_pool(SMALL, 2, 2**31 + 6)
    assert [s.data for s in a] == [s.data for s in b]
    assert [s.data for s in a] != [s.data for s in c]
    assert all((x.seqs == 2).sum() == (y.seqs == 2).sum()
               for x, y in zip(a, c))


@pytest.mark.parametrize("scale", [0.76, 4.0, 40.0])
def test_frames_and_m4a_equal_the_test_encoder(scale):
    from symphonia_tpu_torch.testing import aac_builder as ab
    from symphonia_tpu_torch.testing import mp4_builder as mb

    rng = np.random.default_rng(int(scale * 10))
    seqs = np.array([0, 1, 2, 3, 0, 1, 2, 2, 3, 0])
    quants = []
    for s in seqs:
        qs = [ab.random_quant_spectrum(rng, 12 if s == 2 else 40, 44100, s)
              for _ in range(2)]
        quants.append([np.clip(np.rint(q * scale / 4), -8191, 8191)
                       .astype(np.int64) for q in qs])
    q = torch.from_numpy(np.array(quants))
    out, flen = gen.encode_frames(gen._Books("cpu"), q, torch.from_numpy(seqs),
                                  dict(CFG, global_gain=140))
    want = [ab.build_raw_block(qs, [s, s], 12 if s == 2 else 40, 140, 44100)
            for qs, s in zip(quants, seqs)]
    assert out.tobytes() == b"".join(want)
    assert gen.m4a(flen, out.tobytes(), 44100, 2) == mb.build_m4a(
        want, 44100, 2)


def test_reference_matches_the_port_on_the_cpu():
    from symphonia_tpu_torch import batch

    pool = gen.make_pool(SMALL, 2, 19)
    assert any((s.seqs == 2).any() for s in pool)
    outs = batch.decode_many([s.data for s in pool], device="cpu")
    got = ref.judge(pool, [([0, 1], outs)], "cpu")
    assert got["streams_wrong_shape"] == 0
    assert got["max_rel_err"] < CFG["checks"]["max_rel_err"]


def test_reference_equals_the_test_encoders_synthesis():
    from symphonia_tpu_torch.testing import aac_builder as ab

    rng = np.random.default_rng(2)
    seqs = [0, 1, 2, 2, 3, 0, 1, 2, 3]
    quants = [ab.random_quant_spectrum(rng, 12, 44100, s) for s in seqs]
    want = ab.reference_synthesis(quants, seqs, 2.0 ** -4, 44100, 12)
    got = ref.synthesise(torch.from_numpy(np.array(quants))[None, :, None],
                         torch.tensor([seqs]), 140)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_bit_rate_near_128_kbps():
    pool = gen.make_pool(dict(CFG, seconds=3.0), 2, 5)
    kbps = 8 * sum(len(s.data) for s in pool) / sum(
        s.seconds for s in pool) / 1000
    assert 115 < kbps < 140
