"""The port against the reference's golden PCM anchor (``tests/golden_pcm.npz``).

``symphonia_tpu_torch.testing.golden_corpus`` builds the anchor's corpus
from the port's own encoders; here it is held byte for byte to
``tests/test_golden_pcm.py``'s ``corpus()``, and the port's
``decode_bytes`` and ``decode_many`` on the CPU (the kernels' plain twins)
are held to the anchor under its protocol: integer outputs bit-exact,
float outputs within 1e-5 absolute. ``chip_smoke.py`` runs the same
comparison through ``decode_many`` on the card."""

import numpy as np
import pytest

from symphonia_tpu_torch import batch
from symphonia_tpu_torch.testing import golden_corpus

import test_golden_pcm as anchor


@pytest.fixture(scope="module")
def built():
    entries, absent = golden_corpus.corpus()
    return entries, absent


@pytest.fixture(scope="module")
def golden():
    with np.load(anchor.GOLDEN) as g:
        yield {k: g[k] for k in g.files}


NAMES = ("flac", "mp3_mpeg1_stereo", "mp3_real", "vorbis_real",
         "aac_44k_mono", "aac_48k_stereo", "alac_caf", "adpcm_ima",
         "adpcm_ms", "mp2", "wav_s16")


def test_corpus_names_are_the_anchors(built, golden):
    entries, absent = built
    names = {k[:-len("__pcm")] for k in golden if k.endswith("__pcm")}
    assert names == set(NAMES) == set(entries) | set(absent)
    assert list(anchor.corpus()) == [n for n in NAMES if n in entries]


@pytest.mark.parametrize("name", NAMES)
def test_corpus_entry_is_byte_equal_to_the_anchors(built, name):
    entries, absent = built
    ref = anchor.corpus()
    if name in absent:
        # Only the real-media files may be absent, and then the anchor's
        # corpus cannot be built either.
        assert name in dict(golden_corpus.PYGAME_ENTRIES)
        return
    assert entries[name] == ref[name]


@pytest.fixture(scope="module")
def decoded_many(built):
    entries, _ = built
    names = list(entries)
    outs = batch.decode_many([entries[n] for n in names], device="cpu")
    return {n: (o.samples, o.sample_rate) for n, o in zip(names, outs)}


@pytest.mark.parametrize("name", NAMES)
def test_decode_bytes_meets_the_anchor(built, golden, name):
    entries, absent = built
    if name in absent:
        return
    out = batch.decode_bytes(entries[name], device="cpu")
    row = golden_corpus.compare(name, out.samples, out.sample_rate, golden)
    assert row["ok"], row


@pytest.mark.parametrize("name", NAMES)
def test_decode_many_meets_the_anchor(built, golden, decoded_many, name):
    _, absent = built
    if name in absent:
        return
    row = golden_corpus.compare(name, *decoded_many[name], golden)
    assert row["ok"], row


def test_compare_fails_outside_the_protocol(golden):
    pcm = golden["mp3_mpeg1_stereo__pcm"].copy()
    rate = int(golden["mp3_mpeg1_stereo__rate"])
    assert golden_corpus.compare("mp3_mpeg1_stereo", pcm, rate, golden)["ok"]
    pcm[0, 0] += 2e-5
    assert not golden_corpus.compare("mp3_mpeg1_stereo", pcm, rate,
                                     golden)["ok"]
    ints = golden["flac__pcm"].copy()
    ints[1, -1] += 1
    assert not golden_corpus.compare("flac", ints,
                                     int(golden["flac__rate"]), golden)["ok"]
    assert not golden_corpus.compare("flac", ints[:, :-1],
                                     int(golden["flac__rate"]), golden)["ok"]
