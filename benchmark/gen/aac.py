"""AAC-LC stream generator: a seeded pool of stereo AAC-LC clips in MP4.

A vectorised rewrite of the AAC test encoder
(``symphonia_tpu_torch/testing/aac_builder.py``: ``build_raw_block`` for a
CPE of two independent ICSs with sine windows, its minimum-bits codebook
choice, section data, scalefactors at the global gain) and of the M4A
muxer (``symphonia_tpu_torch/testing/mp4_builder.py``: ``build_m4a``),
frozen here with the code tables they read (``aac_tables.npz``, copied
from ``symphonia_tpu_torch/data/``). For the same quantised spectra, window
sequences and gain it writes the same bytes as the originals
(``benchmark/tests/test_bench_gen_aac.py``). The spectra are the test
encoder's kind (a random share of the bins below the last band, Laplacian values
rounded and clipped), drawn on the device in a few large calls.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .bits import BitBuffer

_T = dict(np.load(Path(__file__).resolve().parent / "aac_tables.npz"))

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
_SR_IDX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
           24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}


@dataclass
class Stream:
    data: bytes
    quant: np.ndarray    # int64 [frames, channels, 1024] quantised spectra
    seqs: np.ndarray     # window sequence of each frame
    gain: int            # global gain of every ICS
    sample_rate: int
    seconds: float


def swb_tables(rate: int):
    """Scalefactor band offsets (long, short); the 44.1/48 kHz tables."""
    if not 37566 <= rate < 55426:
        raise ValueError("the AAC generator writes 44.1 or 48 kHz streams")
    return _T["swb_48k_long"].tolist(), _T["swb_48k_short"].tolist()


# ---------------------------------------------------------------------------
# Window sequences and spectra
# ---------------------------------------------------------------------------

def window_sequences(rng, n_frames: int, every: int) -> np.ndarray:
    """ONLY_LONG frames with one LONG_START, EIGHT_SHORT, LONG_STOP triple
    in each run of ``every`` frames (after the first frame), at a seeded
    offset: the same number of triples for every seed."""
    seqs = np.zeros(n_frames, np.int64)
    for a in range(1, n_frames - 2, every):
        room = min(every, n_frames - a) - 3
        if room < 0:
            break
        o = a + int(rng.integers(0, room + 1))
        seqs[o : o + 3] = (LONG_START, EIGHT_SHORT, LONG_STOP)
    return seqs


def _laplace(gen, shape, scale: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    u = u - 0.5
    return -scale * torch.sign(u) * torch.log1p(-2 * u.abs())


def _sparse_rows(gen, rows: int, limit: int, lo, hi, scale: float,
                 clip: int, device) -> torch.Tensor:
    """[rows, limit] int64: n ~ U[lo, hi) bins of each row, without
    replacement, hold rounded Laplacian values clipped to +-clip."""
    n = lo + (torch.rand(rows, generator=gen, device=device,
                         dtype=torch.float64) * (hi - lo)).long()
    keys = torch.rand((rows, limit), generator=gen, device=device)
    rank = keys.argsort(1).argsort(1)
    v = torch.round(_laplace(gen, (rows, limit), scale, device))
    v = v.clamp(-clip, clip).long()
    return torch.where(rank < n[:, None], v, 0)


def spectra(gen, seqs: torch.Tensor, cfg: dict, device) -> torch.Tensor:
    """Quantised spectra [len(seqs), 1024] int64 of the test encoder's
    kind: long windows hold values in U[limit / 3, limit) of the bins
    below band ``max_sfb``; each of a short frame's eight windows in
    U[2, limit)."""
    sp = cfg["spectrum"]
    long_b, short_b = swb_tables(cfg["sample_rate"])
    q = torch.zeros((len(seqs), 1024), dtype=torch.int64, device=device)
    is_short = seqs == EIGHT_SHORT
    ll = long_b[cfg["max_sfb_long"]]
    rows = torch.nonzero(~is_short).reshape(-1)
    q[rows, :ll] = _sparse_rows(gen, len(rows), ll, ll // 3, ll,
                                sp["laplace_scale"], sp["clip"], device)
    sl = short_b[cfg["max_sfb_short"]]
    rows = torch.nonzero(is_short).reshape(-1)
    s = _sparse_rows(gen, 8 * len(rows), sl, 2, sl, sp["laplace_scale"],
                     sp["clip"], device)
    q.view(-1, 8, 128)[rows, :, :sl] = s.view(-1, 8, sl)
    return q


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

_QUAD = (1, 2, 3, 4)
_UNSIGNED = (3, 4, 7, 8, 9, 10, 11)
_PAIR_DIM = {5: 9, 6: 9, 7: 8, 8: 8, 9: 13, 10: 13, 11: 17}


class _Books:
    """The code tables on one device, padded into [12, 289] arrays."""

    def __init__(self, device):
        codes = torch.zeros((12, 289), dtype=torch.int64)
        lens = torch.zeros((12, 289), dtype=torch.int64)
        for cb in range(1, 12):
            c, n = _T[f"spec_codes_{cb}"], _T[f"spec_lens_{cb}"]
            codes[cb, : len(c)] = torch.from_numpy(c.astype(np.int64))
            lens[cb, : len(n)] = torch.from_numpy(n.astype(np.int64))
        self.codes, self.lens = codes.to(device), lens.to(device)
        self.sizes = {cb: len(_T[f"spec_lens_{cb}"]) for cb in range(1, 12)}


def _index(cb: int, v: torch.Tensor) -> torch.Tensor:
    """Codeword index of each quad [..., 4] (books 1-4) or pair [..., 2]."""
    if cb in (1, 2):
        s = v + 1
        return s[..., 0] * 27 + s[..., 1] * 9 + s[..., 2] * 3 + s[..., 3]
    if cb in (3, 4):
        a = v.abs()
        return a[..., 0] * 27 + a[..., 1] * 9 + a[..., 2] * 3 + a[..., 3]
    if cb in (5, 6):
        return (v[..., 0] + 4) * 9 + (v[..., 1] + 4)
    a = v.abs()
    if cb == 11:
        a = a.clamp(max=16)
    return a[..., 0] * _PAIR_DIM[cb] + a[..., 1]


def _escape(a: torch.Tensor):
    """(bits, length) of the escape sequence of |v| >= 16, else (0, 0)."""
    n = torch.frexp(a.clamp(min=1).double()).exponent.long() - 1
    esc = a >= 16
    pre = (n - 4).clamp(min=0)
    bits = (((1 << pre) - 1) << (n + 1)) | (a - (1 << n))
    return torch.where(esc, bits, 0), torch.where(esc, 2 * n - 3, 0)


def _tuple_fields(books: _Books, cb: int, v: torch.Tensor):
    """(value, length) of each codeword of book ``cb`` with its sign bits
    (and escapes, book 11) appended: v [..., 4] or [..., 2]."""
    idx = _index(cb, v).clamp(0, books.sizes[cb] - 1)
    val, n = books.codes[cb][idx], books.lens[cb][idx]
    if cb in _UNSIGNED:
        for j in range(v.shape[-1]):
            nz = v[..., j] != 0
            val = torch.where(nz, (val << 1) | (v[..., j] < 0), val)
            n = n + nz
    if cb == 11:
        for j in range(2):
            e, en = _escape(v[..., j].abs())
            val = (val << en) | e
            n = n + en
    return val, n


def _band_class(m: torch.Tensor) -> torch.Tensor:
    """The test encoder's codebook class by band maximum: the first book of
    the pair it chooses from, 0 for a silent band, 11 above 12."""
    out = torch.full_like(m, 11)
    for top, cb in ((12, 9), (7, 7), (4, 5), (2, 3), (1, 1), (0, 0)):
        out = torch.where(m <= top, cb, out)
    return out


def encode_ics(books: _Books, q: torch.Tensor, seqs: torch.Tensor,
               cfg: dict):
    """Plan the ICSs of q [N, 1024] (window sequences ``seqs`` [N]).

    Returns the header field (value, length) [N], the section fields
    (value, length) [N, 128], the spectral fields (value, length)
    [N, 512], the section bits, the coded bands and the ICS length in bits
    [N]; the fields of each ICS in stream order, zero-length where none."""
    dev = q.device
    N = q.shape[0]
    long_b, short_b = swb_tables(cfg["sample_rate"])
    ml, ms = cfg["max_sfb_long"], cfg["max_sfb_short"]
    short = seqs == EIGHT_SHORT
    # Band slot of each 4-bin slot: long -> sfb; short -> window * 16 + sfb.
    k = torch.arange(0, 1024, 4, device=dev)
    band_l = torch.bucketize(k, torch.tensor(long_b, device=dev), right=True) - 1
    band_l = torch.where(k < long_b[ml], band_l, -1)
    ks = k % 128
    band_s = torch.bucketize(ks, torch.tensor(short_b, device=dev),
                             right=True) - 1
    band_s = torch.where(ks < short_b[ms], (k // 128) * 16 + band_s, -1)
    band = torch.where(short[:, None], band_s[None, :], band_l[None, :])
    live = band >= 0                                          # [N, 256]
    key = (torch.arange(N, device=dev)[:, None] * 128 + band.clamp(min=0))
    slots = q.view(N, 256, 4)
    m = torch.zeros(N * 128, dtype=torch.int64, device=dev)
    m.scatter_reduce_(0, key[live], slots.abs().amax(-1)[live], "amax")
    cls = _band_class(m)
    # Bits of each candidate book of the band's class, then the cheaper.
    bits = {}
    for cb in range(1, 11):
        v = slots if cb in _QUAD else slots.view(N, 256, 2, 2)
        _, n = _tuple_fields(books, cb, v)
        n = n if cb in _QUAD else n.sum(-1)
        b = torch.zeros(N * 128, dtype=torch.int64, device=dev)
        b.index_add_(0, key[live], n[live])
        bits[cb] = b
    book = cls.clone()
    for cb in (1, 3, 5, 7, 9):
        pick = (cls == cb) & (bits[cb + 1] < bits[cb])
        book = torch.where(pick, cb + 1, book)
    book = book.view(N, 128)

    # Section data: one field (book, run length with escapes) per run.
    g = torch.arange(128, device=dev)
    sfb = torch.where(short[:, None], (g % 16)[None, :], g[None, :])
    n_sfb = torch.where(short, ms, ml)
    in_band = (sfb < n_sfb[:, None]) & (
        torch.where(short[:, None], g[None, :] < 128, g[None, :] < 64))
    prev = torch.cat([torch.full((N, 1), -1, device=dev), book[:, :-1]], 1)
    start = in_band & ((sfb == 0) | (book != prev))
    # Run length: to the next start or the group's end.
    nxt = torch.where(start | ~in_band, g[None, :], 1 << 20)
    nxt = torch.cat([nxt[:, 1:], torch.full((N, 1), 1 << 20, device=dev)], 1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), 1).values, [1])
    group_end = torch.where(short[:, None], (g // 16) * 16 + ms, ml)
    run = torch.minimum(nxt, group_end) - g[None, :]
    sb = torch.where(short, 3, 5)[:, None]
    esc = (1 << sb) - 1
    e = run // esc
    rem = run - e * esc
    len_bits = (e + 1) * sb
    sec_val = (book << len_bits) | ((((1 << (e * sb)) - 1) << sb) | rem)
    sec_len = torch.where(start, 4 + len_bits, 0)
    sec_val = torch.where(start, sec_val, 0)
    coded = (in_band & (book > 0)).sum(1)

    # Spectral data: per slot, one quad codeword or two pair codewords.
    sbook = torch.gather(book, 1, band.clamp(min=0))
    sbook = torch.where(live, sbook, 0)
    spec_val = torch.zeros((N, 256, 2), dtype=torch.int64, device=dev)
    spec_len = torch.zeros((N, 256, 2), dtype=torch.int64, device=dev)
    for cb in range(1, 12):
        sel = sbook == cb
        if not bool(sel.any()):
            continue
        v = slots[sel]
        if cb in _QUAD:
            val, n = _tuple_fields(books, cb, v)
            spec_val[..., 0][sel], spec_len[..., 0][sel] = val, n
        else:
            val, n = _tuple_fields(books, cb, v.view(-1, 2, 2))
            spec_val[sel], spec_len[sel] = val, n
    gain = cfg["global_gain"]
    info_long = (seqs << 8) | (cfg["window_shape"] << 7) | (ml << 1)
    info_short = (seqs << 12) | (cfg["window_shape"] << 11) | (ms << 7)
    hdr_val = torch.where(short, (gain << 15) | info_short,
                          (gain << 11) | info_long)
    hdr_len = torch.where(short, 8 + 15, 8 + 11)
    sec_bits = sec_len.sum(1)
    ics_bits = hdr_len + sec_bits + coded + 3 + spec_len.sum((1, 2))
    return ((hdr_val, hdr_len), (sec_val, sec_len),
            (spec_val.view(N, 512), spec_len.view(N, 512)),
            sec_bits, coded, ics_bits)


def encode_frames(books: _Books, q: torch.Tensor, seqs: torch.Tensor,
                  cfg: dict):
    """Raw data blocks of stereo frames: q [F, 2, 1024], seqs [F] (both
    channels alike). Returns (numpy bytes back to back, byte lengths)."""
    F = q.shape[0]
    dev = q.device
    (hv, hl), (sv, sl), (pv, pl), sec_bits, coded, ics = encode_ics(
        books, q.reshape(2 * F, 1024), seqs.repeat_interleave(2), cfg)
    ics = ics.view(F, 2)
    frame_bits = 8 + ics.sum(1) + 3
    flen = (frame_bits + 7) // 8
    fstart = (torch.cumsum(flen, 0) - flen) * 8
    buf = BitBuffer(int(flen.sum()) * 8, dev)
    buf.put(fstart, torch.full_like(fstart, 0b00100000),
            torch.full_like(fstart, 8))                     # CPE, tag 0
    ics0 = torch.stack([fstart + 8, fstart + 8 + ics[:, 0]], 1).reshape(-1)
    buf.put(ics0, hv, hl)
    sec0 = ics0 + hl
    buf.put(sec0[:, None] + torch.cumsum(sl, 1) - sl, sv, sl)
    spec0 = sec0 + sec_bits + coded + 3
    buf.put(spec0[:, None] + torch.cumsum(pl, 1) - pl, pv, pl)
    end = fstart + 8 + ics.sum(1)
    buf.put(end, torch.full_like(end, 7), torch.full_like(end, 3))  # END
    return buf.to_bytes(), flen.cpu().numpy()


def _atom(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full_atom(kind: bytes, payload: bytes) -> bytes:
    return _atom(kind, b"\x00\x00\x00\x00" + payload)


def m4a(sizes: np.ndarray, payload: bytes, rate: int, n_ch: int) -> bytes:
    """The test muxer's plain M4A: one AAC-LC track, one chunk."""
    word = (2 << 11) | (_SR_IDX[rate] << 7) | (n_ch << 3)
    asc = word.to_bytes(2, "big")
    dsi = bytes([0x05, len(asc)]) + asc
    dcd = bytes([0x04, 13 + len(dsi), 0x40, 0x15]) + b"\x00" * 11 + dsi
    slc = bytes([0x06, 0x01, 0x02])
    es = bytes([0x03, 3 + len(dcd) + len(slc)]) + b"\x00\x00\x00" + dcd + slc
    mp4a = _atom(b"mp4a", b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 8
                 + struct.pack(">HH", n_ch, 16) + b"\x00" * 4
                 + struct.pack(">I", rate << 16) + _full_atom(b"esds", es))
    stsd = _full_atom(b"stsd", struct.pack(">I", 1) + mp4a)
    n = len(sizes)
    stts = _full_atom(b"stts", struct.pack(">III", 1, n, 1024))
    stsc = _full_atom(b"stsc", struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_atom(b"stsz", struct.pack(">II", 0, n)
                      + np.asarray(sizes, ">u4").tobytes())

    def moov(mdat_offset):
        stco = _full_atom(b"stco", struct.pack(">II", 1, mdat_offset))
        stbl = _atom(b"stbl", stsd + stts + stsc + stsz + stco)
        mdhd = _full_atom(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate,
                                               n * 1024, 0x55C4, 0))
        mdia = _atom(b"mdia", mdhd + _atom(b"minf", stbl))
        tkhd = _full_atom(b"tkhd", struct.pack(">IIII", 0, 0, 1, 0)
                          + b"\x00" * 72)
        mvhd = _full_atom(b"mvhd", struct.pack(">III", 0, 0, rate)
                          + b"\x00" * 88)
        return _atom(b"moov", mvhd + _atom(b"trak", tkhd + mdia))

    ftyp = _atom(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42isom")
    head = ftyp + moov(len(ftyp) + len(moov(0)) + 8)
    return head + _atom(b"mdat", payload)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

FRAMES_PER_CHUNK = 8192


def make_pool(cfg: dict, n_streams: int, seed: int, device="cpu") -> list:
    """``n_streams`` clips of ``seconds`` from ``seed``: window sequences
    from a numpy generator, spectra from a torch generator on ``device``,
    the frames encoded there."""
    if cfg["channels"] != 2:
        raise ValueError("the AAC generator writes stereo CPE streams")
    device = torch.device(device)
    rng = np.random.default_rng(seed % (1 << 64))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    rate = cfg["sample_rate"]
    n_frames = int(round(cfg["seconds"] * rate / 1024))
    seqs = np.stack([window_sequences(rng, n_frames, cfg["transient_every"])
                     for _ in range(n_streams)])                  # [S, F]
    seq_all = torch.from_numpy(seqs.reshape(-1)).to(device)
    books = _Books(device)
    quant, parts, lens = [], [], []
    for a in range(0, len(seq_all), FRAMES_PER_CHUNK):
        s = seq_all[a : a + FRAMES_PER_CHUNK]
        q = spectra(gen, s.repeat_interleave(2), cfg, device)
        q = q.view(len(s), 2, 1024)
        out, flen = encode_frames(books, q, s, cfg)
        quant.append(q.cpu().numpy())
        parts.append(out)
        lens.append(flen)
    quant = np.concatenate(quant).reshape(n_streams, n_frames, 2, 1024)
    allb = np.concatenate(parts)
    flen = np.concatenate(lens).reshape(n_streams, n_frames)
    ends = np.cumsum(flen.reshape(-1)).reshape(n_streams, n_frames)
    pool = []
    for i in range(n_streams):
        body = allb[ends[i, 0] - flen[i, 0] : ends[i, -1]].tobytes()
        pool.append(Stream(
            data=m4a(flen[i], body, rate, 2), quant=quant[i], seqs=seqs[i],
            gain=cfg["global_gain"],
            sample_rate=rate, seconds=n_frames * 1024 / rate))
    return pool
