"""The FLAC generator: deterministic by seed, byte-equal to the test
encoder it rewrites, and its reference equal to what the port decodes."""

import json

import numpy as np
import pytest
import torch

from benchmark.gen import flac as gen
from benchmark.reference import flac as ref
from conftest import ROOT

CFG = json.loads((ROOT / "benchmark/configs/librispeech_flac.json").read_text())
SMALL = dict(CFG, duration_s=dict(CFG["duration_s"], min=0.5, max=2.0))


def test_deterministic_by_seed():
    a = gen.make_pool(SMALL, 3, 2**31 + 11)
    b = gen.make_pool(SMALL, 3, 2**31 + 11)
    c = gen.make_pool(SMALL, 3, 2**31 + 12)
    assert [s.data for s in a] == [s.data for s in b]
    assert [s.data for s in a] != [s.data for s in c]
    # The same set of durations for every seed, in another order.
    assert sorted(s.pcm.shape[1] for s in a) == sorted(
        s.pcm.shape[1] for s in c)


@pytest.mark.parametrize("po", range(6))
def test_frames_equal_the_test_encoder(po):
    from symphonia_tpu_torch.testing import flac_builder as fb

    rng = np.random.default_rng(po)
    x, c = gen.ar_source(rng, 3 * 4096 + 1000, CFG)
    q, sh = gen.quantise(c, 15)
    B = 4096
    rows = [(f, st, min(B, len(x) - st))
            for f, st in enumerate(range(0, len(x), B))]
    X = np.zeros((len(rows), B), np.int64)
    for j, (_, st, b) in enumerate(rows):
        X[j, :b] = x[st : st + b]
    t = torch.from_numpy
    out, flen, _ = gen.encode_frames(
        t(X), t(np.array([r[2] for r in rows])), t(np.tile(q, (len(rows), 1))),
        t(np.full(len(rows), sh)), 15, 16, [r[0] for r in rows],
        force_po=np.full(len(rows), po))
    want = b"".join(fb.encode_frame([x[st : st + b]], f, 16, "independent",
                                    kind="lpc", lpc_coefs=list(q),
                                    lpc_shift=sh, lpc_precision=15,
                                    partition_order=po)
                    for f, st, b in rows)
    assert out.tobytes() == want


def test_stream_header_equals_the_test_encoder():
    from symphonia_tpu_torch.testing import flac_builder as fb

    s = gen.make_pool(SMALL, 1, 3)[0]
    chans = [s.pcm[0]]
    head = (b"fLaC" + bytes([0x80, 0, 0, 34])
            + fb.build_streaminfo(4096, 16000, 1, 16, s.pcm.shape[1],
                                  fb.md5_of(chans, 16)))
    assert s.data.startswith(head)


def test_reference_equals_the_port_on_the_cpu():
    from symphonia_tpu_torch import batch

    pool = gen.make_pool(SMALL, 3, 77)
    outs = batch.decode_many([s.data for s in pool], device="cpu",
                             verify=True)
    got = ref.judge(pool, [([0, 1, 2], outs)], "cpu")
    assert got == {"streams_wrong_shape": 0, "mismatched_samples": 0,
                   "md5_not_verified": 0, "streams_compared": 3}


def test_bit_rate_near_the_corpus():
    pool = gen.make_pool(dict(CFG, duration_s=dict(CFG["duration_s"],
                                                    max=6.0)), 4, 5)
    bits = 8 * sum(len(s.data) for s in pool)
    samples = sum(s.pcm.shape[1] for s in pool)
    assert 8.2 < bits / samples < 9.2
