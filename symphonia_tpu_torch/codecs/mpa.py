"""MPEG audio decoder (MP3; MP1/MP2 via layer12 module).

Analog of symphonia-bundle-mp3/src/decoder.rs (``MpaDecoder``, decoder.rs:59)
and layer3/mod.rs:373 (``Layer3::decode``): header re-parse, bit-reservoir
fill (layer3/mod.rs:31-107), side info + scalefactors + Huffman spectrum,
then requantize -> stereo -> reorder -> dense stage (antialias, hybrid
IMDCT, frequency inversion, polyphase synthesis via
``symphonia_tpu.ops.mp3_dense``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.audio import AudioBuffer, AudioSpec, Channels
from ..core.codecs import (
    CODEC_ID_MP1,
    CODEC_ID_MP2,
    CODEC_ID_MP3,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
)
from ..core.errors import DecodeError
from ..core.io.bits import BitReaderLtr
from ..core.packet import Packet
from ..ops.mp3_dense import GranuleDenseState, granule_dense_np
from . import mpa_layer3 as l3
from . import mpa_layer12 as l12
from .mpa_common import LAYER1, LAYER2, LAYER3, MpaHeader, parse_header
from .. import native as _native_mod

# Maximum bit-reservoir capacity in bytes (9-bit main_data_begin).
RESERVOIR_MAX = 511


class Layer3State:
    def __init__(self):
        self.reservoir = bytearray()
        # Dense tails live in shared [C, ...] blocks so the native fused
        # pipeline and the Python oracle mutate the SAME state (both
        # update in place) — either path can pick up mid-stream.
        self.hybrid_tails = np.zeros((2, 32, 18), dtype=np.float32)
        self.synth_tails = np.zeros((2, 480), dtype=np.float32)
        self.dense: List[GranuleDenseState] = [
            GranuleDenseState(self.hybrid_tails[c], self.synth_tails[c])
            for c in range(2)
        ]
        self.stream = None  # lazy native Mp3Stream context (False = absent)
        self.pcm_buf = np.empty((2, 2 * 576), dtype=np.float32)

    def reset(self):
        self.reservoir.clear()
        if self.stream:
            self.stream.reset()
        for d in self.dense:
            d.reset()


def decode_layer3_frame(
    header: MpaHeader, frame: bytes, state: Layer3State
) -> np.ndarray:
    """Decode one Layer III frame -> [n_ch, 1152|576] f32 PCM."""
    pos = 4 + (2 if header.has_crc else 0)
    side_len = header.side_info_len()
    br = BitReaderLtr(frame[pos : pos + side_len])
    fd = l3.read_side_info(br, header)

    main_data = frame[pos + side_len : header.frame_size]

    # Bit reservoir (layer3/mod.rs:31-107): this frame's main data begins
    # main_data_begin bytes before the end of the previous reservoir.
    if fd.main_data_begin > len(state.reservoir):
        # Not enough prior data (start of stream or after seek); stash and
        # signal the caller to skip this frame.
        state.reservoir.extend(main_data)
        del state.reservoir[:-RESERVOIR_MAX]
        raise DecodeError("bit reservoir underflow")
    buf = (
        bytes(state.reservoir[len(state.reservoir) - fd.main_data_begin :])
        + main_data
    )
    state.reservoir.extend(main_data)
    del state.reservoir[:-RESERVOIR_MAX]

    n_ch = header.n_channels
    n_granules = l3.NGRANULES[header.is_mpeg1]
    mbr = BitReaderLtr(buf)

    out = np.zeros((n_ch, 576 * n_granules), dtype=np.float32)
    for gr in range(n_granules):
        spectra = []
        for ch in range(n_ch):
            c = fd.granules[gr][ch]
            start_bits = mbr.bits_read()
            if header.is_mpeg1:
                part2 = l3.read_scale_factors_mpeg1(mbr, gr, ch, fd)
            else:
                is_int = (ch == 1) and header.is_intensity_stereo
                part2 = l3.read_scale_factors_mpeg2(mbr, is_int, c)
            part3 = c.part2_3_length - part2
            if part3 < 0:
                raise DecodeError("part2 exceeds part2_3_length")
            spec = l3.read_huffman_samples(mbr, c, part3)
            l3.requantize(header, c, spec)
            spectra.append(spec)
        if n_ch == 2:
            l3.stereo(header, fd.granules[gr], spectra[0], spectra[1])
        for ch in range(n_ch):
            c = fd.granules[gr][ch]
            l3.reorder(header, c, spectra[ch])
            out[ch, gr * 576 : (gr + 1) * 576] = granule_dense_np(
                spectra[ch], c.block_type, c.mixed, state.dense[ch]
            )
    return out


class MpaDecoder(AudioDecoder):
    """MPEG-1/2/2.5 Layer I/II/III audio decoder (decoder.rs:59)."""

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if params.sample_rate is None or params.channels is None:
            raise DecodeError("MPA decoder requires sample rate and channels")
        self.spec = AudioSpec(params.sample_rate, params.channels)
        self._l3 = Layer3State()
        self._l12_state = None
        # Warm the native engine at construction: the module import,
        # dlopen, and table setup land here instead of inside the first
        # (timed) decode call.
        try:
            from .. import native as _native
            _native.available()
        except Exception:
            pass

    @staticmethod
    def supported_codecs() -> List[str]:
        return [CODEC_ID_MP1, CODEC_ID_MP2, CODEC_ID_MP3]

    def decode(self, packet: Packet) -> AudioBuffer:
        frame = packet.data
        if len(frame) < 4:
            raise DecodeError("frame too small")
        header = parse_header(int.from_bytes(frame[:4], "big"))
        if header.sample_rate != self.spec.rate or header.n_channels != self.spec.num_channels:
            raise DecodeError("frame parameters changed mid-stream")
        if header.layer == LAYER3:
            pcm = self._decode_l3_native(header, frame)
            if pcm is None:
                pcm = decode_layer3_frame(header, frame, self._l3)
        else:
            if self._l12_state is None:
                self._l12_state = l12.Layer12State()
            pcm = l12.decode_frame(header, frame, self._l12_state)
        buf = AudioBuffer.from_array(pcm, self.spec)
        buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf

    def _decode_l3_native(self, header: MpaHeader, frame: bytes):
        """Native per-packet fast path (sh_mp3_stream_decode): a stateful
        C++ context carries the bit reservoir and the fused dense stage
        decodes frame -> PCM in one call. Returns the frame PCM, or None
        to fall back to the Python oracle path. Both paths maintain the
        Python-side reservoir identically (the C++ bookkeeping adds main
        data for decoded and underflowed frames, skips unparseable ones —
        decode_layer3_frame's exact semantics), so either can pick up
        mid-stream.
        """
        st = self._l3
        if st.stream is None:
            import os

            # SYMPHONIA_TPU_MP3_STREAM=off forces the Python oracle path
            # (parity testing / A-B measurement).
            if os.environ.get("SYMPHONIA_TPU_MP3_STREAM") == "off":
                st.stream = False
            else:
                st.stream = _native_mod.mp3_stream_open() or False
        if not st.stream:
            return None
        md_off = 4 + (2 if header.has_crc else 0) + header.side_info_len()
        if header.frame_size < md_off or header.frame_size > len(frame):
            # Truncated/short frame: the Python path may stash partial
            # main data the native walk would skip — reset the context so
            # it conservatively re-anchors (self-heals within ~511 bytes
            # of main data via reservoir-underflow fallbacks).
            st.stream.reset()
            return None
        fb = bytes(frame[: header.frame_size])
        n = _native_mod.mp3_stream_decode(
            st.stream, fb, st.hybrid_tails, st.synth_tails, st.pcm_buf)
        if n <= 0:
            return None
        # Keep the Python-oracle reservoir in sync for later fallbacks.
        st.reservoir.extend(fb[md_off:])
        del st.reservoir[:-RESERVOIR_MAX]
        n_ch = header.n_channels
        return st.pcm_buf[:n_ch, : n * 576].copy()

    def reset(self) -> None:
        self._l3.reset()
        if self._l12_state is not None:
            self._l12_state.reset()
