"""Vorbis decoder.

Analog of symphonia-codec-vorbis (``VorbisDecoder``, lib.rs:52): per packet
(lib.rs:146-332) mode/window select -> floor 0/1 decode + synthesis
(floor.rs:141,432) -> residue 0/1/2 partitioned VQ decode (residue.rs) ->
inverse channel coupling (lib.rs:250-278) -> floor x residue dot product ->
IMDCT with lapped overlap-add (dsp.rs, window.rs).

An end-of-packet condition during floor/residue decode is NOT an error
(Vorbis I spec §1.1.4): decode stops and remaining values stay zero.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..core.audio import AudioBuffer, AudioSpec, Channels
from ..core.codecs import (
    CODEC_ID_VORBIS,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
)
from ..core.errors import DecodeError, EndOfStream
from ..core.io.bits import BitReaderRtl
from ..core.packet import Packet
from ..ops.imdct_host import have_fast_imdct, imdct_dct4
from .. import native as _native_mod
from .vorbis_setup import (
    Floor0Config,
    Floor1Config,
    IdentHeader,
    Setup,
    VorbisCodebook,
    ilog,
    read_ident_header,
    read_setup_header,
)


@lru_cache(maxsize=None)
def floor1_inverse_db_table() -> np.ndarray:
    path = Path(__file__).resolve().parent.parent / "data" / "vorbis_tables.npz"
    return np.load(path)["floor1_inverse_db"]


# Floor1 Y value range per multiplier (spec §7.2.3).
_FLOOR1_RANGE = {1: 256, 2: 128, 3: 86, 4: 64}


# ---------------------------------------------------------------------------
# Floor 1
# ---------------------------------------------------------------------------


def floor1_read_channel(
    br: BitReaderRtl, cfg: Floor1Config, codebooks: List[VorbisCodebook]
) -> Optional[np.ndarray]:
    """Decode floor1 posts for one channel; None = floor unused."""
    try:
        if not br.read_bits(1):
            return None
        rng = _FLOOR1_RANGE[cfg.multiplier]
        bits = ilog(rng - 1)
        n = len(cfg.x_list)
        y = np.zeros(n, dtype=np.int64)
        y[0] = br.read_bits(bits)
        y[1] = br.read_bits(bits)
        offset = 2
        for cls in cfg.partition_class_list:
            cdim = cfg.class_dims[cls]
            cbits = cfg.class_subclass_bits[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                mb = cfg.class_masterbooks[cls]
                cval = codebooks[mb].codebook.decode_rtl(br)
            for j in range(cdim):
                book = cfg.subclass_books[cls][cval & csub]
                cval >>= cbits
                if book >= 0:
                    y[offset + j] = codebooks[book].codebook.decode_rtl(br)
            offset += cdim
        return y
    except (EndOfStream, ValueError):
        return None


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    """Integer line interpolation (spec §9.2.6)."""
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def floor1_synthesis(
    y: np.ndarray, cfg: Floor1Config, n2: int
) -> np.ndarray:
    """Posts -> linear floor curve of length n2 (spec §7.2.4; floor.rs)."""
    rng = _FLOOR1_RANGE[cfg.multiplier]
    n = len(cfg.x_list)
    final_y = np.zeros(n, dtype=np.int64)
    step2 = np.zeros(n, dtype=bool)
    final_y[0] = y[0]
    final_y[1] = y[1]
    step2[0] = step2[1] = True
    for i in range(2, n):
        low = cfg.low_neighbors[i]
        high = cfg.high_neighbors[i]
        pred = _render_point(
            cfg.x_list[low], int(final_y[low]), cfg.x_list[high],
            int(final_y[high]), cfg.x_list[i],
        )
        val = int(y[i])
        highroom = rng - pred
        lowroom = pred
        room = 2 * min(highroom, lowroom)
        if val:
            step2[low] = True
            step2[high] = True
            step2[i] = True
            if val >= room:
                final_y[i] = (val - lowroom + pred) if highroom > lowroom else (
                    pred - (val - highroom) - 1
                )
            elif val & 1:
                final_y[i] = pred - ((val + 1) >> 1)
            else:
                final_y[i] = pred + (val >> 1)
        else:
            step2[i] = False
            final_y[i] = pred
    final_y = np.clip(final_y, 0, rng - 1)

    # Curve rendering (spec §7.2.4 step 2).
    db = floor1_inverse_db_table()
    mult = cfg.multiplier
    out = np.zeros(n2, dtype=np.float32)
    order = cfg.sort_order
    # First flagged point.
    hx = 0
    hy = 0
    lx = 0
    ly = int(final_y[order[0]]) * mult
    for idx in order[1:]:
        if not step2[idx]:
            continue
        hx = cfg.x_list[idx]
        hy = int(final_y[idx]) * mult
        _render_line(lx, ly, min(hx, n2), hy, out, db)
        lx, ly = hx, hy
    if hx < n2:
        out[hx:n2] = db[min(ly, 255)]
    return out


def _render_line(x0: int, y0: int, x1: int, y1: int, v: np.ndarray, db: np.ndarray) -> None:
    """Bresenham-style line render through the inverse-dB table
    (spec §9.2.7 render_line)."""
    if x1 <= x0:
        return
    dy = y1 - y0
    adx = x1 - x0
    base = abs(dy) // adx * (1 if dy >= 0 else -1)
    ady = abs(dy) - abs(base) * adx
    sy = base - 1 if dy < 0 else base + 1
    if x0 < len(v):
        v[x0] = db[min(max(y0, 0), 255)]
    y = y0
    err = 0
    for x in range(x0 + 1, min(x1, len(v))):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = db[min(max(y, 0), 255)]


# ---------------------------------------------------------------------------
# Floor 0
# ---------------------------------------------------------------------------


def _bark(x: float) -> float:
    return 13.1 * np.arctan(0.00074 * x) + 2.24 * np.arctan(1.85e-8 * x * x) + 1e-4 * x


@lru_cache(maxsize=None)
def _bark_map(n: int, rate: int, size: int):
    c = size / _bark(0.5 * rate)
    i = np.arange(n, dtype=np.float64)
    m = np.floor(_bark(rate / (2.0 * n) * i) * c).astype(np.int64)
    return np.minimum(m, size - 1)


def floor0_read_channel(
    br: BitReaderRtl, cfg: Floor0Config, codebooks: List[VorbisCodebook]
):
    """Returns (amplitude, coeffs 2cos-form) or None if unused."""
    try:
        amplitude = br.read_bits(cfg.amplitude_bits)
        if amplitude == 0:
            return None
        book_idx = br.read_bits(ilog(len(cfg.books)))
        if book_idx >= len(cfg.books):
            raise DecodeError("floor0 invalid book index")
        cb = codebooks[cfg.books[book_idx]]
        if cb.vq is None:
            raise DecodeError("floor0 book has no VQ table")
        coeffs = []
        last = 0.0
        while len(coeffs) < cfg.order:
            entry = cb.codebook.decode_rtl(br)
            vec = cb.vq[entry]
            take = min(cfg.order - len(coeffs), len(vec))
            vals = vec[:take] + last
            coeffs.extend(vals.tolist())
            last = float(vals[-1] if take else last)
        return amplitude, 2.0 * np.cos(np.asarray(coeffs[: cfg.order], dtype=np.float64))
    except (EndOfStream, ValueError):
        return None


def floor0_synthesis(
    amplitude: int, two_cos_coeffs: np.ndarray, cfg: Floor0Config, n2: int
) -> np.ndarray:
    """LSP curve synthesis (spec §6.2.3; floor.rs:270-350)."""
    m = _bark_map(n2, cfg.rate, cfg.bark_map_size)
    out = np.empty(n2, dtype=np.float32)
    order = cfg.order
    i = 0
    while i < n2:
        cond = m[i]
        omega = np.pi * cond / cfg.bark_map_size
        cos_omega = np.cos(omega)
        tco = 2.0 * cos_omega
        pairs = order // 2
        p = np.prod(two_cos_coeffs[1 : 2 * pairs : 2] - tco) if pairs else 1.0
        q = np.prod(two_cos_coeffs[0 : 2 * pairs : 2] - tco) if pairs else 1.0
        if order & 1:
            q *= two_cos_coeffs[order - 1] - tco
            p = p * p * (1.0 - cos_omega * cos_omega)
            q = q * q * 0.25
        else:
            p = p * p * ((1.0 - cos_omega) / 2.0)
            q = q * q * ((1.0 + cos_omega) / 2.0)
        if p + q == 0.0:
            raise DecodeError("invalid floor0 coefficients")
        a = float(amplitude) * cfg.amplitude_offset
        b = np.sqrt(p + q) * ((1 << cfg.amplitude_bits) - 1)
        # Crafted floor-0 setups drive this exp to inf; that is the
        # accepted behavior (the reference's f32 powf overflows the same
        # way), so scope the expected overflow warning here rather than
        # letting it mask unexpected ones elsewhere in the suite.
        with np.errstate(over="ignore"):
            val = np.exp(
                0.11512925 * (a / b - cfg.amplitude_offset)
            ).astype(np.float32)
        while i < n2 and m[i] == cond:
            out[i] = val
            i += 1
    return out


# ---------------------------------------------------------------------------
# Residue
# ---------------------------------------------------------------------------


def residue_decode(
    br: BitReaderRtl,
    cfg,
    codebooks: List[VorbisCodebook],
    do_not_decode: List[bool],
    n2: int,
) -> np.ndarray:
    """Decode residues for the channels of a submap. Returns
    [n_channels, n2] float32 (spec §8.6; residue.rs)."""
    n_ch = len(do_not_decode)
    out = np.zeros((n_ch, n2), dtype=np.float32)
    if cfg.kind == 2:
        if all(do_not_decode):
            return out
        flat = np.zeros(n_ch * n2, dtype=np.float32)
        _residue_core(br, cfg, codebooks, [flat], [False], n_ch * n2)
        out[:] = flat.reshape(n2, n_ch).T
    else:
        vectors = [out[i] for i in range(n_ch)]
        _residue_core(br, cfg, codebooks, vectors, do_not_decode, n2)
    return out


def _residue_core(br, cfg, codebooks, vectors, do_not_decode, n: int) -> None:
    begin = min(cfg.begin, n)
    end = min(cfg.end, n)
    n_to_read = end - begin
    if n_to_read == 0:
        return
    classbook = codebooks[cfg.classbook]
    cw = classbook.dims  # classwords per codeword
    parts = n_to_read // cfg.partition_size
    n_ch = len(vectors)
    classes = np.zeros((n_ch, parts + cw), dtype=np.int64)
    try:
        for pass_ in range(8):
            pc = 0
            while pc < parts:
                if pass_ == 0:
                    for j in range(n_ch):
                        if do_not_decode[j]:
                            continue
                        temp = classbook.codebook.decode_rtl(br)
                        for i in range(cw - 1, -1, -1):
                            classes[j, pc + i] = temp % cfg.classifications
                            temp //= cfg.classifications
                for _ in range(cw):
                    if pc >= parts:
                        break
                    for j in range(n_ch):
                        if do_not_decode[j]:
                            continue
                        vqclass = int(classes[j, pc])
                        book = cfg.books[vqclass][pass_]
                        if book < 0:
                            continue
                        cb = codebooks[book]
                        if cb.vq is None:
                            raise DecodeError("residue book has no VQ table")
                        off = begin + pc * cfg.partition_size
                        _decode_partition(br, cfg, cb, vectors[j], off)
                    pc += 1
    except (EndOfStream, ValueError):
        return


def _decode_partition(br, cfg, cb: VorbisCodebook, v: np.ndarray, offset: int) -> None:
    dims = cb.dims
    psize = cfg.partition_size
    if cfg.kind == 0:
        step = psize // dims
        for i in range(step):
            entry = cb.codebook.decode_rtl(br)
            v[offset + i : offset + i + dims * step : step] += cb.vq[entry]
    else:  # types 1 and 2 share the format
        i = 0
        while i < psize:
            entry = cb.codebook.decode_rtl(br)
            take = min(dims, psize - i)
            v[offset + i : offset + i + take] += cb.vq[entry][:take]
            i += dims


# ---------------------------------------------------------------------------
# DSP: IMDCT + lapped windows
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def imdct_matrix(n_out: int) -> np.ndarray:
    """[n_out, n_out/2] IMDCT matrix:
    y[i] = sum_j x[j] cos(pi/(2 n_out) (2i + 1 + n_out/2)(2j + 1))
    (core dsp/mdct.rs analytical definition). f32, MXU-friendly."""
    n_in = n_out // 2
    i = np.arange(n_out)[:, None]
    j = np.arange(n_in)[None, :]
    return np.cos(np.pi / (2 * n_out) * (2 * i + 1 + n_in) * (2 * j + 1)).astype(
        np.float32
    )


@lru_cache(maxsize=None)
def vorbis_window(bs: int) -> np.ndarray:
    """Left-half window slope: sin(pi/2 sin^2(pi (i+0.5) / bs))
    (spec §4.3.1; window.rs)."""
    i = np.arange(bs // 2, dtype=np.float64)
    s = np.sin(np.pi / 2 * (i + 0.5) / (bs // 2))
    return np.sin(np.pi / 2 * s * s).astype(np.float32)


@lru_cache(maxsize=None)
def vorbis_window_rev(bs: int) -> np.ndarray:
    """Contiguous reversed window slope (same values as
    ``vorbis_window(bs)[::-1]``; a materialized copy avoids the
    reversed-stride multiply in the per-packet lapping hot path)."""
    return np.ascontiguousarray(vorbis_window(bs)[::-1])


class VorbisDsp:
    """Per-channel lapping state (dsp.rs DspChannel)."""

    def __init__(self, n_channels: int, bs0: int, bs1: int):
        self.bs0 = bs0
        self.bs1 = bs1
        self.overlap = np.zeros((n_channels, bs1 // 2), dtype=np.float32)
        self.prev_block_flag: Optional[bool] = None

    def reset(self):
        self.overlap[:] = 0
        self.prev_block_flag = None

    def synth(self, ch: int, spectrum: np.ndarray, block_flag: bool,
              prev_block_flag: bool) -> np.ndarray:
        """IMDCT + windowed overlap-add; returns (prev_bs + bs)/4 samples."""
        bs = self.bs1 if block_flag else self.bs0
        # DCT-IV route for big blocks (a [8192, 4096] matvec is 128 MB of
        # matrix traffic per call); tiny blocks keep the cached matmul.
        if bs >= 512 and have_fast_imdct():
            y = imdct_dct4(np.ascontiguousarray(spectrum[: bs // 2]))
        else:
            y = imdct_matrix(bs) @ spectrum[: bs // 2]
        wbs = self.bs1 if (block_flag and prev_block_flag) else self.bs0
        win = vorbis_window(wbs)
        win_rev = vorbis_window_rev(wbs)
        prev_bs = self.bs1 if prev_block_flag else self.bs0
        out = np.empty((prev_bs + bs) // 4, dtype=np.float32)
        ov = self.overlap[ch]
        if prev_block_flag == block_flag:
            out[:] = ov[: bs // 2] * win_rev + y[: bs // 2] * win
        elif prev_block_flag and not block_flag:
            start = (self.bs1 - self.bs0) // 4
            end = start + self.bs0 // 2
            out[:start] = ov[:start]
            out[start:] = ov[start:end] * win_rev + y[: self.bs0 // 2] * win
        else:
            start = (self.bs1 - self.bs0) // 4
            end = start + self.bs0 // 2
            out[: self.bs0 // 2] = (
                ov[: self.bs0 // 2] * win_rev + y[start:end] * win
            )
            out[self.bs0 // 2 :] = y[end : self.bs1 // 2]
        self.overlap[ch, : bs // 2] = y[bs // 2 :]
        return out

    def synth_all(self, spectra: np.ndarray, block_flag: bool,
                  prev_block_flag: bool) -> np.ndarray:
        """Vectorized ``synth`` over all channels at once: one DCT-IV call
        instead of one per channel (the per-packet surface's hot loop).
        Elementwise/lapping math is per-row identical to ``synth``; the
        DCT batches rows through the same pocketfft kernel."""
        bs = self.bs1 if block_flag else self.bs0
        n_ch = spectra.shape[0]
        if bs >= 512 and have_fast_imdct():
            y = imdct_dct4(np.ascontiguousarray(spectra[:, : bs // 2]))
        else:
            m = imdct_matrix(bs)
            y = np.stack([m @ spectra[c, : bs // 2] for c in range(n_ch)])
        wbs = self.bs1 if (block_flag and prev_block_flag) else self.bs0
        win = vorbis_window(wbs)
        win_rev = vorbis_window_rev(wbs)
        prev_bs = self.bs1 if prev_block_flag else self.bs0
        out = np.empty((n_ch, (prev_bs + bs) // 4), dtype=np.float32)
        ov = self.overlap[:n_ch]
        if prev_block_flag == block_flag:
            np.multiply(ov[:, : bs // 2], win_rev, out=out)
            out += y[:, : bs // 2] * win
        elif prev_block_flag and not block_flag:
            start = (self.bs1 - self.bs0) // 4
            end = start + self.bs0 // 2
            out[:, :start] = ov[:, :start]
            out[:, start:] = ov[:, start:end] * win_rev + y[:, : self.bs0 // 2] * win
        else:
            start = (self.bs1 - self.bs0) // 4
            end = start + self.bs0 // 2
            out[:, : self.bs0 // 2] = (
                ov[:, : self.bs0 // 2] * win_rev + y[:, start:end] * win
            )
            out[:, self.bs0 // 2 :] = y[:, end : self.bs1 // 2]
        self.overlap[:n_ch, : bs // 2] = y[:, bs // 2 :]
        return out


# Vorbis channel order -> output order (spec §4.3.9). Our output keeps the
# positioned order (L, R, C, LFE, RL, RR, ...) like the reference's
# map_vorbis_channel.
_CHANNEL_MAP = {
    1: [0],
    2: [0, 1],
    3: [0, 2, 1],  # vorbis: L, C, R -> out L, R, C
    4: [0, 1, 2, 3],
    5: [0, 2, 1, 3, 4],
    6: [0, 2, 1, 4, 5, 3],
    7: [0, 2, 1, 5, 6, 4, 3],
    8: [0, 2, 1, 6, 7, 4, 5, 3],
}


class VorbisDecoder(AudioDecoder):
    """Vorbis audio decoder (codec-vorbis lib.rs:52).

    ``params.extra_data`` carries the three Vorbis headers, either Xiph
    lacing (as in OGG/Matroska: 0x02, lacing sizes, packets) or plain
    concatenation of id+setup.
    """

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if not params.extra_data:
            raise DecodeError("vorbis requires extra data headers")
        ident_data, setup_data = self._split_headers(params.extra_data)
        self.ident = read_ident_header(ident_data)
        self._raw_headers = (ident_data, setup_data)
        self._setup: Optional[Setup] = None  # lazily parsed (see .setup)
        self.bs0 = 1 << self.ident.bs0_exp
        self.bs1 = 1 << self.ident.bs1_exp
        self.dsp = VorbisDsp(self.ident.n_channels, self.bs0, self.bs1)
        self._native = None  # native context (False = unavailable)
        # Open the native context at construction (the reference builds
        # its codebooks in Decoder::try_new): module import, dlopen, and
        # codebook synthesis land here instead of inside the first (timed)
        # decode call. On any failure it stays None and decode() retries
        # lazily with identical semantics. The native open parses the raw
        # setup header itself; the Python parse then only runs on the
        # oracle/fallback paths — but when no native context engaged, run
        # it NOW so malformed setups raise at construction exactly as
        # before (the native parser rejects every stream the Python one
        # does, so a successful native open implies a parseable setup).
        self._open_native()
        if not self._native:
            _ = self.setup
        self.spec = AudioSpec(
            self.ident.sample_rate, Channels.from_count(self.ident.n_channels)
        )

    @property
    def setup(self) -> Setup:
        """Parsed setup header (lazy: the native per-packet path parses
        the raw header in C++; only the Python oracle/fallback paths and
        the serialize blob need these structures)."""
        if self._setup is None:
            self._setup = read_setup_header(self._raw_headers[1], self.ident)
        return self._setup

    def _open_native(self) -> None:
        """Set ``_native`` to a context, or False (disabled/unavailable);
        leaves it None on unexpected errors so decode() retries lazily."""
        try:
            import os as _os

            from .. import native as _native

            if _os.environ.get("SYMPHONIA_TPU_VORBIS_STREAM") == "off":
                self._native = False
            else:
                self._native = _native.vorbis_stream_open(self) or False
        except Exception:
            self._native = None

    @staticmethod
    def _split_headers(extra: bytes):
        """Extract (ident, setup) packets from extra data."""
        if extra and extra[0] == 2:
            # Xiph lacing: count=2 means 3 packets (id, comment, setup).
            pos = 1
            sizes = []
            for _ in range(extra[0]):
                v = 0
                while True:
                    b = extra[pos]
                    pos += 1
                    v += b
                    if b != 255:
                        break
                sizes.append(v)
            p0 = extra[pos : pos + sizes[0]]
            pos += sizes[0]
            pos += sizes[1]  # skip comment
            p2 = extra[pos:]
            return p0, p2
        if extra and extra[0] == 1:
            # Concatenated headers: find the setup header start.
            idx = extra.find(b"\x05vorbis", 1)
            if idx < 0:
                raise DecodeError("setup header not found in extra data")
            return extra[:30], extra[idx:]
        raise DecodeError("unrecognized vorbis extra data layout")

    @staticmethod
    def supported_codecs() -> List[str]:
        return [CODEC_ID_VORBIS]

    def reset(self) -> None:
        self.dsp.reset()
        if self._native:
            from .. import native as _native

            _native.vorbis_stream_reset(self._native)

    def decode_spectra(self, data: bytes):
        """Entropy + floor/residue/coupling stage: packet -> per-channel
        spectra ready for the IMDCT (the device-batchable boundary).

        Returns (spectra [n_ch, n2] float32, block_flag).
        """
        if not data:
            raise DecodeError("empty packet")
        # Native fast path (native/vorbis_entropy.cpp via a persistent
        # context; SYMPHONIA_TPU_VORBIS_STREAM=off forces the oracle). Any
        # error status falls back to this Python path so malformed-input
        # behavior is identical.
        if self._native is None:
            self._open_native()
        if self._native:
            from .. import native as _native

            got = _native.vorbis_stream_decode(self._native, bytes(data))
            if got is not None:
                spectra, block_flag = got
                n2 = (self.bs1 if block_flag else self.bs0) // 2
                # Copy out of the pooled native buffer: callers may
                # accumulate spectra across packets (batch fallback).
                return spectra[:, :n2].copy(), block_flag
        br = BitReaderRtl(data)
        if br.read_bits(1):
            raise DecodeError("not an audio packet")
        n_modes = len(self.setup.modes)
        mode_idx = br.read_bits(ilog(n_modes - 1)) if n_modes > 1 else 0
        if mode_idx >= n_modes:
            raise DecodeError("invalid mode number")
        mode = self.setup.modes[mode_idx]
        mapping = self.setup.mappings[mode.mapping]
        block_flag = mode.block_flag
        bs = self.bs1 if block_flag else self.bs0
        n2 = bs // 2
        n_ch = self.ident.n_channels
        cbs = self.setup.codebooks

        if block_flag:
            br.read_bits(1)  # prev window flag
            br.read_bits(1)  # next window flag

        # Floor decode per channel.
        floors = [None] * n_ch
        for ch in range(n_ch):
            fcfg = self.setup.floors[mapping.submap_floor[mapping.mux[ch]]]
            if fcfg.kind == 1:
                floors[ch] = floor1_read_channel(br, fcfg.f1, cbs)
            else:
                floors[ch] = floor0_read_channel(br, fcfg.f0, cbs)
        no_residue = [f is None for f in floors]

        # Nonzero vector propagation through coupling (spec §4.3.3).
        for mag, ang in mapping.coupling_steps:
            if not (no_residue[mag] and no_residue[ang]):
                no_residue[mag] = False
                no_residue[ang] = False

        # Residue decode per submap.
        residues = np.zeros((n_ch, n2), dtype=np.float32)
        n_submaps = len(mapping.submap_residue)
        for sm in range(n_submaps):
            chans = [ch for ch in range(n_ch) if mapping.mux[ch] == sm]
            dnd = [no_residue[ch] for ch in chans]
            rcfg = self.setup.residues[mapping.submap_residue[sm]]
            dec = residue_decode(br, rcfg, cbs, dnd, n2)
            for i, ch in enumerate(chans):
                residues[ch] = dec[i]

        # Inverse coupling (spec §4.3.4), in reverse step order.
        for mag, ang in reversed(mapping.coupling_steps):
            m = residues[mag].copy()
            a = residues[ang].copy()
            # Per spec §4.3.4:
            #  m>0, a>0: M=m,       A=m-a
            #  m>0, a<=0: A=m,      M=m+a
            #  m<=0, a>0: M=m,      A=m+a
            #  m<=0, a<=0: A=m,     M=m-a
            new_m = np.where(
                m > 0, np.where(a > 0, m, m + a), np.where(a > 0, m, m - a)
            )
            new_a = np.where(
                m > 0, np.where(a > 0, m - a, m), np.where(a > 0, m + a, m)
            )
            residues[mag] = new_m
            residues[ang] = new_a

        # Floor synthesis + dot product.
        spectra = np.zeros((n_ch, n2), dtype=np.float32)
        for ch in range(n_ch):
            if floors[ch] is None:
                continue
            fcfg = self.setup.floors[mapping.submap_floor[mapping.mux[ch]]]
            if fcfg.kind == 1:
                curve = floor1_synthesis(floors[ch], fcfg.f1, n2)
            else:
                amplitude, coeffs = floors[ch]
                curve = floor0_synthesis(amplitude, coeffs, fcfg.f0, n2)
            spectra[ch] = curve * residues[ch]
        return spectra, block_flag

    def decode(self, packet: Packet) -> AudioBuffer:
        # Full-native per-packet path (entropy + IMDCT + lapped OLA +
        # channel reorder in C++, sh_vorbis_decode_pcm). The lapping state
        # lives in the native context; the Python dsp state stays idle
        # while this path is engaged (reset() clears both). On any native
        # error status the Python path below runs and raises the identical
        # DecodeError (the native lapping state is untouched on failure).
        # Output parity vs the oracle is ~1 ulp of the packet's peak (the
        # C++ DCT-IV runs in double; pocketfft's runs in float32) — see
        # TestNativePcmPath.
        # The dsp.prev_block_flag guard keeps the two lapping states from
        # desyncing: once any packet has gone through the Python dsp
        # (native open failed at first, or a native-skip/Python-decode
        # divergence), the native path must not (re-)engage mid-stream —
        # its fresh context would mislabel the next packet as first and
        # overlap-add against a zeroed buffer. reset() clears both states
        # and re-arms the native path.
        if self._native is None:
            self._open_native()
        if (
            self._native
            and self._native.has_pcm
            and packet.data
            and self.dsp.prev_block_flag is None
        ):
            got = _native_mod.vorbis_stream_decode_pcm(
                self._native, bytes(packet.data)
            )
            if got is not None:
                pcm, first_packet = got
                buf = AudioBuffer.from_array(pcm, self.spec)
                if first_packet:
                    # No overlap partner; not valid audio (lib.rs:318-326).
                    buf.truncate(0)
                else:
                    buf.trim(packet.trim_start, packet.trim_end)
                self._last = buf
                return buf

        spectra, block_flag = self.decode_spectra(packet.data)
        n_ch = self.ident.n_channels

        # IMDCT + lapping.
        prev_flag = (
            self.dsp.prev_block_flag
            if self.dsp.prev_block_flag is not None
            else block_flag
        )
        first_packet = self.dsp.prev_block_flag is None
        outs = self.dsp.synth_all(spectra[:n_ch], block_flag, prev_flag)
        self.dsp.prev_block_flag = block_flag

        chmap = _CHANNEL_MAP.get(n_ch, list(range(n_ch)))
        if chmap == list(range(n_ch)):
            pcm = outs  # identity map: synth_all's buffer is fresh each call
        else:
            pcm = np.zeros((n_ch, outs.shape[1]), dtype=np.float32)
            for src, dst in enumerate(chmap):
                pcm[dst] = outs[src]

        buf = AudioBuffer.from_array(pcm, self.spec)
        if first_packet:
            # The first block after reset has no overlap partner; its output
            # is not valid audio (lib.rs:318-326).
            buf.truncate(0)
        else:
            buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf
