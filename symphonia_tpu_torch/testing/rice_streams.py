"""Rice-coded lane streams for R1 ``rice_decode``: a per-lane-k encoder, the
FLAC-partition-shaped builder (many short lanes, mixed k) and the edge
cases that the kernel's register reader must get right.

``ops.rice_device.make_test_streams`` stays the reference's copy (one k for
every lane); what is here is new. The edge cases are shared by the CPU
tests (against a model of the kernel, the twin and the JAX package) and by
``chip_smoke.py`` (the kernel against the twin on the card).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_MASK32 = 0xFFFFFFFF


def encode_lanes(vals, ks, lead: int = 0, pad_bits: int = 64):
    """Rice-code ``vals [B, n]`` lane after lane, lane b with parameter
    ``ks[b]`` (0..31, each symbol's q + 1 + k <= 32 is the caller's), after
    ``lead`` zero bits -> (bytes, first-symbol cursors [B] int64). The
    stream ends ``pad_bits`` zero bits after the last symbol, rounded up
    to a byte."""
    vals = np.asarray(vals, np.int64)
    B, n = vals.shape
    ks = np.broadcast_to(np.asarray(ks, np.int64), (B,))
    flat = vals.reshape(-1)
    ksym = np.repeat(ks, n)
    u = (flat << 1) ^ (flat >> 63)  # zig-zag
    q = u >> ksym
    r = u & ((np.int64(1) << ksym) - 1)
    lens = q + 1 + ksym
    starts = np.empty(flat.size, np.int64)
    if flat.size:
        starts[0] = lead
        np.cumsum(lens[:-1], out=starts[1:])
        starts[1:] += lead
    total = int(starts[-1] + lens[-1]) if flat.size else lead
    bits = np.zeros(total + pad_bits, np.uint8)
    bits[starts + q] = 1  # unary terminator
    for b in range(int(ks.max(initial=0))):
        sel = ksym > b
        bits[(starts + q + 1 + b)[sel]] = (
            (r[sel] >> (ksym[sel] - 1 - b)) & 1).astype(np.uint8)
    cursors = starts.reshape(B, n)[:, 0].copy() if n else np.full(B, lead)
    return np.packbits(bits).tobytes(), cursors


def words_of(data: bytes) -> np.ndarray:
    """Bytes -> big-endian u32 words, the last one zero-filled (no extra
    padding, unlike ``pack_bits_u32``)."""
    pad = (-len(data)) % 4
    return np.frombuffer(data + b"\x00" * pad, dtype=">u4").astype(np.uint32)


def fitting_values(rng, ks, n: int) -> np.ndarray:
    """Laplace values [B, n] of scale 2**k for lanes of parameter ``ks``,
    clipped so every symbol fits a 32-bit window (q <= 31 - k)."""
    ks = np.asarray(ks, np.int64)
    vals = rng.laplace(0.0, 1.0, size=(ks.size, n)) * (2.0 ** ks)[:, None]
    umax = ((32 - ks) << ks) - 1
    return np.clip(vals.astype(np.int64), (-((umax + 1) // 2))[:, None],
                   (umax // 2)[:, None])


def make_mixed_streams(B: int, n: int, seed: int):
    """``B`` lanes of ``n`` symbols shaped like FLAC's Rice partitions: k
    per lane drawn from 0..14, Laplace values of scale 2**k clipped so
    that q + 1 + k <= 32. Returns (bytes, cursors [B], ks [B], vals [B,
    n])."""
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, 15, size=B)
    vals = fitting_values(rng, ks, n)
    data, cursors = encode_lanes(vals, ks)
    return data, cursors, ks, vals


def _case(name, words, cur, param, n, vals=None) -> Dict:
    return {"name": name, "words": np.asarray(words, np.uint32),
            "cur": np.asarray(cur, np.int64) & _MASK32,
            "param": np.asarray(param, np.int64), "n": int(n),
            "vals": None if vals is None else np.asarray(vals, np.int64)}


def _encoded(name, rng, ks, n, lead=0, pad_bits=64) -> Dict:
    vals = fitting_values(rng, ks, n)
    data, cur = encode_lanes(vals, ks, lead, pad_bits)
    return _case(name, words_of(data), cur, ks, n, vals)


def _random_words(rng, W: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=W, dtype=np.uint64).astype(np.uint32)


def edge_cases(seed: int = 0) -> List[Dict]:
    """The cases a register bit reader can get wrong, each a dict of
    ``name``, ``words [W]`` uint32, ``cur [B]`` (uint32 values as int64),
    ``param [B]``, ``n`` and ``vals`` (the encoded values, or None where
    the words are random)."""
    rng = np.random.default_rng(seed)
    cases = []
    # Lanes that start anywhere in a word (a 13-bit lead, then whatever
    # lengths the values give).
    cases.append(_encoded("start_anywhere", rng, np.full(7, 4), 40, lead=13))
    # A stream that ends in its last word: the last lanes leave the
    # register reader for the clamped reads mid-lane.
    cases.append(_encoded("into_last_word", rng, np.full(6, 3), 48, lead=5,
                          pad_bits=0))
    # Cursors at, just below and far past 32 * W. At 32 * W - 63 the window
    # is zero (q = 32) and, with k = 31, r's last bit lies past the words:
    # the clamped read gives word W - 1's first bit (0 here).
    W = 12
    words = _random_words(rng, W)
    words[-2] = 0x80000000
    words[-1] &= 0x7FFFFFFF
    cur = np.array([32 * W - 64, 32 * W - 63, 32 * W - 1, 32 * W,
                    32 * W + 5, 32 * W + 1000, 2**31 - 1, 2**31 + 7,
                    32 * W - 63, 32 * W - 64])
    cases.append(_case("past_end", words, cur,
                       [0, 4, 31, 9, 1, 30, 3, 12, 31, 31], 20))
    # Cursors within 64 bits of 2**32 on a small W: they wrap.
    cur = np.array([2**32 - 64, 2**32 - 65, 2**32 - 33, 2**32 - 1,
                    2**32 - 100, 2**32 - 2])
    cases.append(_case("near_wrap", _random_words(rng, 10), cur,
                       [0, 4, 31, 9, 2, 1], 20))
    # Runs of 32 and more zero bits (q = 32), inside the reader's range.
    words = _random_words(rng, 64)
    words[10:13] = 0
    words[30] = 0
    words[31] = 1
    words[40:42] = [0, 0x80000000]
    cur = np.array([320, 321, 330, 352, 959, 960, 990, 1280, 1281, 1311,
                    1312, 0, 31])
    cases.append(_case("zero_runs", words, cur,
                       [0, 1, 5, 31, 0, 4, 30, 2, 31, 0, 3, 7, 9], 12))
    # k = 0, 1, 30 and 31 on every lane, encoded.
    for k in (0, 1, 30, 31):
        cases.append(_encoded(f"k{k}", rng, np.full(5, k), 37, lead=k))
    # Mixed k across lanes, 0..31 and outside it (the clamped path
    # throughout), on random words.
    param = np.concatenate([np.arange(32), [32, 33, 40, -1, -7]])
    W = 200
    cases.append(_case("mixed_k_outside", _random_words(rng, W),
                       rng.integers(0, 32 * W, size=param.size), param, 24))
    # Mixed k 0..14, encoded as the FLAC-partition builder does.
    ks = rng.integers(0, 15, size=33)
    cases.append(_encoded("mixed_k_encoded", rng, ks, 70))
    # n = 0 and 1, and n that is not a multiple of the staging width.
    for n in (0, 1, 33, 95):
        cases.append(_encoded(f"n{n}", rng, rng.integers(0, 10, size=9), n,
                              lead=3))
    # B = 1, 31 and 33 (a part of a warp, a warp and one lane more).
    for B in (1, 31, 33):
        cases.append(_encoded(f"B{B}", rng, rng.integers(0, 12, size=B), 41,
                              lead=B))
    # Everything at once: random words, cursors over the words and past
    # them, k 0..31.
    W = 300
    cases.append(_case("random_words", _random_words(rng, W),
                       rng.integers(0, 32 * W + 200, size=65),
                       rng.integers(0, 32, size=65), 70))
    # Lanes long enough for whole tiles far from the end of the stream: at
    # k = 2 the ring holds all a tile can read; at k = 14 it may not.
    cases.append(_encoded("long_lanes", rng, np.full(3, 2), 500))
    cases.append(_encoded("long_lanes_k14", rng, np.full(2, 14), 300))
    # Long symbols (k = 31, q + 1 + k > 32 often) on random words: a lane
    # consumes ~33 words in 32 symbols and outruns a 64-word ring.
    W = 2000
    cases.append(_case("ring_outrun", _random_words(rng, W),
                       rng.integers(0, 32 * W // 4, size=5), np.full(5, 31),
                       200))
    return cases
