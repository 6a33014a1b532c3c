"""The controls: the reference put in the program's place, one precision
below the configuration's or (FLAC, which states none) with a stated
guarantee broken, must come out as not correct by the cell's own
limits (here at a size a test run holds; ``benchmark/control.py`` reads
them on the card at the cells' size)."""

import json

from benchmark.gen import aac, flac
from benchmark.reference import aac as ref_aac
from benchmark.reference import flac as ref_flac
from conftest import ROOT


def cfg(name):
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


def failed(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


def test_flac_control_fails():
    """The FLAC control (MD5 left unchecked) fails on that guarantee
    alone: its samples are exact."""
    c = cfg("librispeech_flac")
    pool = flac.make_pool(c, 16, 2**31 + 17)
    outs = ref_flac.control(pool)
    got = ref_flac.judge(pool, [(list(range(16)), outs)], "cpu")
    assert got["streams_compared"] == 16
    assert failed(got, c["checks"])
    assert got["mismatched_samples"] == 0
    assert got["md5_not_verified"] == 16


def test_aac_tf32_fails():
    c = cfg("audioset_aac")
    pool = aac.make_pool(dict(c, seconds=1.0), 4, 2**31 + 17)
    outs = ref_aac.control(pool)
    got = ref_aac.judge(pool, [(list(range(4)), outs)], "cpu")
    assert failed(got, c["checks"])
    assert got["max_rel_err"] > 3 * c["checks"]["max_rel_err"]


def test_the_exact_references_pass_their_own_check():
    c = cfg("audioset_aac")
    pool = aac.make_pool(dict(c, seconds=0.5), 2, 3)
    outs = [ref_aac.Decoded(p.numpy().astype("float32"), s.sample_rate)
            for s, p in zip(pool, ref_aac.expected(pool, "cpu"))]
    got = ref_aac.judge(pool, [([0, 1], outs)], "cpu")
    assert not failed(got, c["checks"])
