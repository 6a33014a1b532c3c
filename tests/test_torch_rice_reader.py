"""R1 ``rice_decode``'s register bit reader, modelled exactly on the CPU.

``csrc/rice_device.cu`` decodes a lane from four words held in registers
(w0..w3 and a bit offset) and the two words after them. Those come from a
ring of 64 words a lane in shared memory, which whole 16-byte chunks
(counted from the 16-byte boundary below the words) fill at every
write-back and which the lane reads once the next write-back has waited
for them, or from device memory where the lane outran its ring. It takes r
from the same 64 bits (from the first window alone where q + 1 + k <= 32).
A lane whose cursor gets past ``min(32 W, 2**32 - 1) - 64``, or whose k is
outside 0..31, decodes by the reference's clamped windows from there on. A
warp stages 32 symbols of each of its lanes and writes them back row by
row, a column a thread. :func:`reader_model` is that
arithmetic in Python integers, lane for lane and warp for warp; it is held
bit for bit against the port's twin ``rice_decode_lanes_plain`` and the
JAX package's ``rice_decode_lanes`` (residuals and end cursors) on the
edge cases of ``symphonia_tpu_torch.testing.rice_streams``, for every
16-byte misalignment of the words."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from symphonia_tpu.ops import rice_device as ref
from symphonia_tpu_torch.ops import rice_device as port
from symphonia_tpu_torch.testing import rice_streams as rs

M32 = 0xFFFFFFFF
TILE = 32   # symbols a lane stages (kTile)
RING = 64   # words of a lane's ring (kRing)
WARP = 32


def _shl(hi, lo, s):
    """__funnelshift_l(lo, hi, s) for s < 32: the top 32 bits of hi:lo << s."""
    return ((((hi << 32) | lo) << s) >> 32) & M32


class _Lane:
    """One lane of the kernel: four words w0..w3, a bit offset and the two
    words after them (r4, r5) in registers; the window moves on by 0, 1 or
    2 words a symbol. The words after it come from a ring of RING words
    that ``fill`` requests: whole 16-byte chunks counted from the 16-byte
    boundary ``delta`` words before the first word, the words outside the
    stream not copied, the chunk at slot 0 also at slots RING..RING + 3 (so
    the two words at a slot are adjacent). They are visible after the next
    ``refill``'s wait."""

    def __init__(self, words, delta, limit, c, k, stats):
        self.words, self.delta, self.limit = words, delta, limit
        self.W = len(words)
        self.lo, self.hi = delta, delta + self.W - 1
        self.c, self.k, self.stats = c, k, stats
        self.fast = k < 32 and c <= limit
        if not self.fast:
            return
        last = self.W - 1
        wi = c >> 5
        assert wi <= self.W - 2
        self.off = c & 31
        self.w = [words[wi], words[wi + 1], words[min(wi + 2, last)],
                  words[min(wi + 3, last)]]
        # Slots never copied hold garbage: a result that used one would
        # differ from the twin's.
        self.ring = [0xA5A5A5A5 ^ (s * 0x9E3779B1 & M32)
                     for s in range(RING + 4)]
        self.pending = []
        self.next = wi + 4 + delta
        self.issued = self.landed = self.next
        self.fill()
        self.refill()
        self._peek()

    def fill(self):
        end = (self.next + RING) & ~3
        x = max(self.issued, self.next) & ~3
        for x in range(x, end, 4):
            if x >= self.lo and x + 3 <= self.hi:
                self.stats["copies16"] += 1
            for t in range(4):
                if self.lo <= x + t <= self.hi:
                    self.stats["copies4"] += not (x >= self.lo
                                                  and x + 3 <= self.hi)
                    v = self.words[x + t - self.delta]
                    self.pending.append(((x + t) % RING, v))
                    if x % RING == 0:  # slots RING..RING + 3 repeat 0..3
                        self.pending.append((RING + t, v))
        self.issued = max(self.issued, end)

    def refill(self):
        for slot, v in self.pending:  # cp.async.wait_all
            self.ring[slot] = v
        self.pending = []
        self.landed = self.issued
        self.fill()

    def tile_tests(self, cnt):
        """The kernel's tests before a tile (a symbol moves the cursor by
        33 + k bits at most): every cursor of it within the register
        reader's range; and every word it can read in the ring."""
        most = cnt * (33 + self.k)
        in_range = self.fast and self.limit - self.c >= most
        return in_range, in_range and (
            self.landed >= self.next + (self.off + most) // 32 + 2)

    def _peek(self):
        """r4, r5: the two words after the window, from the ring where it
        holds both, else from device memory."""
        if getattr(self, "ring_only", False):
            assert self.next + 2 <= self.landed
        if getattr(self, "in_range", False):
            assert self.c <= self.limit
        if self.next + 2 <= self.landed:
            self.stats["ring_reads"] += 1
            slot = self.next % RING
            self.r = self.ring[slot:slot + 2]
        else:  # outran the ring
            self.stats["direct_reads"] += 1
            self.r = [self.words[min(self.next + t, self.hi) - self.delta]
                      for t in range(2)]

    def _window(self, cur):
        """The reference's 32-bit window, word indices clamped."""
        last = self.W - 1
        wi, off = cur >> 5, cur & 31
        hi = self.words[min(wi, last)]
        if off == 0:
            return hi
        lo = self.words[min(wi + 1, last)]
        return ((hi << off) | (lo >> (32 - off))) & M32

    def symbol(self):
        k, st = self.k, self.stats
        if self.fast:
            w0, w1, w2, _ = self.w
            h = _shl(w0, w1, self.off)
            lo = _shl(w1, w2, self.off)
            q = 32 - h.bit_length()
            w2nd = ((((h << 32) | lo) << (q + 1)) >> 32) & M32
            r = (w2nd >> 1) >> (31 - k)
            if q + 1 + k <= 32:  # one window: r is in h
                st["one_window"] += 1
                assert r == (0 if k == 0 else ((h << (q + 1)) & M32) >> (32 - k))
            else:  # the second window at c1, from the same registers
                st["second_window"] += 1
                assert r == w2nd >> (32 - k) and q + 1 + k <= 64
            st["q32"] += q == 32
            bits = q + 1 + k
            self.c += bits
            assert self.c <= M32  # no wrap inside the register reader
            o = self.off + bits
            sh, self.off = o >> 5, o & 31
            assert sh <= 2
            self.w = (self.w + self.r)[sh:sh + 4]
            self.next += sh
            self._peek()
            u = ((q << k) | r) & M32
            st["fast"] += 1
            was_fast, self.fast = True, self.c <= self.limit
            st["switched"] += was_fast and not self.fast
        else:
            q = 32 - self._window(self.c).bit_length()
            c1 = (self.c + q + 1) & M32
            r = 0 if k == 0 else self._window(c1) >> ((32 - k) & 31)
            self.c = (c1 + k) & M32
            u = ((0 if k >= 32 else (q << k) & M32)) | r
            st["slow"] += 1
        v = (u >> 1) ^ ((-(u & 1)) & M32)
        return v - (1 << 32) if v >> 31 else v


def reader_model(words, cur, param, n, delta=0):
    """R1's arithmetic in Python integers: (residuals [B, n] int64, end
    cursors [B] int64, counts of what each path did)."""
    words = [int(w) for w in np.asarray(words, np.uint32)]
    W = len(words)
    limit = min(32 * W, M32) - 64
    stats = dict.fromkeys(("fast", "slow", "switched", "one_window",
                           "second_window", "q32", "copies16", "copies4",
                           "ring_reads", "direct_reads", "unchecked_tiles",
                           "range_tiles"), 0)
    B = len(cur)
    out = np.zeros((B, n), np.int64)
    written = np.zeros((B, n), np.int64)
    end = np.zeros(B, np.int64)
    for row0 in range(0, B, WARP):
        rows = min(WARP, B - row0)
        warp = [_Lane(words, delta, limit, int(cur[row0 + j]) & M32,
                      int(param[row0 + j]) & M32, stats)
                for j in range(rows)]
        for i0 in range(0, n, TILE):
            cnt = min(TILE, n - i0)
            # The warp takes the loop all its lanes allow.
            tests = [lane.tile_tests(cnt) for lane in warp]
            ring_only = all(r for _, r in tests)
            in_range = all(i for i, _ in tests)
            stats["unchecked_tiles"] += ring_only
            stats["range_tiles"] += in_range and not ring_only
            for lane in warp:
                lane.ring_only, lane.in_range = ring_only, in_range
            stage = [[lane.symbol() for _ in range(cnt)] for lane in warp]
            # Row j goes back as columns 0..cnt-1, thread t column t (all
            # 32 threads of the warp, those past B too).
            for j in range(rows):
                for t in range(WARP):
                    if t < cnt:
                        out[row0 + j, i0 + t] = stage[j][t]
                        written[row0 + j, i0 + t] += 1
            for lane in warp:
                if lane.fast:
                    lane.refill()
        end[row0:row0 + rows] = [lane.c for lane in warp]
    assert (written == 1).all()
    return out, end, stats


def _twin_and_reference(case):
    words, cur, param, n = (case[k] for k in ("words", "cur", "param", "n"))
    got, got_end = port.rice_decode_lanes_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(cur),
        torch.from_numpy(param.astype(np.int32)), n)
    want, want_end = ref.rice_decode_lanes(
        words, jnp.asarray(cur.astype(np.int32)),
        jnp.asarray(param.astype(np.int32)), n)
    return ((got.numpy().astype(np.int64), got_end.numpy()),
            (np.asarray(want).astype(np.int64).reshape(len(cur), n),
             np.asarray(want_end).astype(np.int64) & M32))


# What each case must make the reader do, beyond agreeing.
_EXPECT = {
    "start_anywhere": ("fast", "copies16", "ring_reads"),
    "into_last_word": ("fast", "switched", "slow", "copies4"),
    "past_end": ("slow", "switched"),
    "near_wrap": ("slow",),
    "zero_runs": ("fast", "q32", "second_window"),
    "k30": ("fast",), "k31": ("fast",),
    "mixed_k_outside": ("fast", "slow", "second_window"),
    "random_words": ("fast", "slow", "switched", "second_window"),
    "ring_outrun": ("fast", "direct_reads", "second_window"),
    "long_lanes": ("fast", "unchecked_tiles"),
    "long_lanes_k14": ("fast", "range_tiles"),
}

CASES = rs.edge_cases(seed=10)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_reader_model_matches_twin_and_reference(case):
    (twin, twin_end), (want, want_end) = _twin_and_reference(case)
    np.testing.assert_array_equal(twin, want)
    np.testing.assert_array_equal(twin_end, want_end)
    if case["vals"] is not None:
        np.testing.assert_array_equal(twin, case["vals"])
    total = {}
    for delta in range(4):  # every 16-byte misalignment of the words
        got, got_end, stats = reader_model(case["words"], case["cur"],
                                           case["param"], case["n"], delta)
        np.testing.assert_array_equal(got, twin)
        np.testing.assert_array_equal(got_end, twin_end)
        total = {k: total.get(k, 0) + v for k, v in stats.items()}
    for key in _EXPECT.get(case["name"], ()):
        assert total[key] > 0, (case["name"], key, total)
    if case["vals"] is not None and case["n"]:
        # Encoded symbols fit a 32-bit window: r always comes from the first.
        assert total["fast"] == total["one_window"] > 0, total
    if case["name"] == "near_wrap":
        assert stats["fast"] == 0 and (want_end < case["cur"]).any()


def test_edge_cases_cover_the_list():
    names = {c["name"] for c in CASES}
    assert {"n0", "n1", "n33", "B1", "B31", "B33", "k0", "k1", "k30",
            "k31", "mixed_k_outside", "mixed_k_encoded"} <= names
    by = {c["name"]: c for c in CASES}
    assert (by["start_anywhere"]["cur"] % 32 != 0).all()
    W = len(by["past_end"]["words"])
    assert {32 * W, 32 * W - 64} <= set(by["past_end"]["cur"].tolist())
    assert (by["past_end"]["cur"] > 100 * 32 * W).any()
    assert (by["near_wrap"]["cur"] >= 2**32 - 100).all()
    outside = by["mixed_k_outside"]["param"]
    assert set(range(32)) <= set(outside.tolist()) and (
        (outside < 0) | (outside > 31)).any()


@pytest.mark.parametrize("B,n,seed", [(40, 64, 1), (7, 300, 2)])
def test_mixed_streams_decode_to_their_values(B, n, seed):
    # The FLAC-partition builder: k 0..14 per lane, every symbol within a
    # 32-bit window; the model, the twin and the reference all give the
    # encoded values back.
    data, cur, ks, vals = rs.make_mixed_streams(B, n, seed)
    assert ks.min() >= 0 and ks.max() <= 14
    u = (vals << 1) ^ (vals >> 63)
    assert ((u >> ks[:, None]) + 1 + ks[:, None] <= 32).all()
    case = {"words": port.pack_bits_u32(data), "cur": cur, "param": ks,
            "n": n}
    (twin, twin_end), (want, want_end) = _twin_and_reference(case)
    got, got_end, stats = reader_model(case["words"], cur, ks, n)
    np.testing.assert_array_equal(twin, vals)
    np.testing.assert_array_equal(want, vals)
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(got_end, twin_end)
    np.testing.assert_array_equal(want_end, twin_end)
    assert stats["slow"] == 0 and stats["second_window"] == 0


def test_encode_lanes_with_one_k_is_make_test_streams():
    # The per-lane encoder, given one k, writes the reference builder's
    # stream (same bits, same cursors).
    data, cur, vals = port.make_test_streams(6, 50, 4, seed=3)
    data2, cur2 = rs.encode_lanes(vals, np.full(6, 4))
    assert data2 == data
    np.testing.assert_array_equal(cur2, cur)
