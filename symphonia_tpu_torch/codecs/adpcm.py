"""ADPCM decoder: Microsoft ADPCM and IMA ADPCM (WAV + QuickTime).

Analog of symphonia-codec-adpcm (lib.rs:70, codec_ms.rs, codec_ima_wav.rs,
codec_ima_qt.rs, common_ima.rs): block-based decode with per-block state
reset, making blocks the natural parallel lanes for the batched device path
(``ops.adpcm`` runs the in-block recurrence as a lax.scan over nibbles with
blocks as lanes).

Tables are specification data: the 89-entry IMA step table + index
adjustment table (IMA ADPCM / DVI spec), and the MS ADPCM coefficient +
adaptation tables (Microsoft WAVE format spec).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.audio import AudioBuffer, AudioSpec
from ..core.codecs import (
    CODEC_ID_ADPCM_IMA_QT,
    CODEC_ID_ADPCM_IMA_WAV,
    CODEC_ID_ADPCM_MS,
    AudioCodecParameters,
    AudioDecoder,
    AudioDecoderOptions,
)
from ..core.errors import DecodeError
from ..core.packet import Packet
from .. import native as _native_mod

IMA_STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484,
    7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818,
    18500, 20350, 22385, 24623, 27086, 29794, 32767,
], dtype=np.int32)

IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)

MS_ADAPT_TABLE = np.array(
    [230, 230, 230, 230, 307, 409, 512, 614, 768, 614, 512, 409, 307, 230,
     230, 230],
    dtype=np.int32,
)
MS_COEFFS = np.array(
    [[256, 0], [512, -256], [0, 0], [192, 64], [240, 0], [460, -208],
     [392, -232]],
    dtype=np.int32,
)


def ima_decode_nibbles(nibbles: np.ndarray, predictor: int, step_index: int) -> np.ndarray:
    """Decode a nibble sequence with the IMA recurrence (common_ima.rs).

    The recurrence is state-serial (step-index adaptation), so the hot
    loop runs natively when available (native/adpcm_loops.cpp, bit-exact;
    headers are validated by the callers before this point)."""
    fast = _native_mod.ima_decode_nibbles(nibbles, predictor,
                                      int(np.clip(step_index, 0, 88)))
    if fast is not None:
        return fast
    out = np.empty(len(nibbles), dtype=np.int32)
    pred = int(predictor)
    idx = int(np.clip(step_index, 0, 88))
    for i, nib in enumerate(nibbles):
        nib = int(nib)
        step = int(IMA_STEP_TABLE[idx])
        # diff = (2*mag + 1) * step / 8 computed with shifts.
        diff = step >> 3
        if nib & 1:
            diff += step >> 2
        if nib & 2:
            diff += step >> 1
        if nib & 4:
            diff += step
        if nib & 8:
            pred -= diff
        else:
            pred += diff
        pred = max(-32768, min(32767, pred))
        idx = max(0, min(88, idx + int(IMA_INDEX_TABLE[nib & 7])))
        out[i] = pred
    return out


def decode_ima_wav_block(block: bytes, n_ch: int) -> np.ndarray:
    """One IMA WAV block -> [ch, frames] (codec_ima_wav.rs)."""
    if len(block) < 4 * n_ch:
        raise DecodeError("IMA block too small")
    # Frames come from WHOLE interleaved 4-byte-per-channel groups; a
    # block whose data area is not group-aligned (malformed block_align)
    # yields only the complete groups' samples.
    n_groups = (len(block) - 4 * n_ch) // (4 * n_ch)
    frames_per_block = n_groups * 8 + 1
    out = np.empty((n_ch, frames_per_block), dtype=np.int32)
    preds = []
    idxs = []
    for c in range(n_ch):
        hdr = block[4 * c : 4 * c + 4]
        pred = int.from_bytes(hdr[0:2], "little", signed=True)
        idx = hdr[2]
        if idx > 88:
            raise DecodeError("invalid IMA step index")
        preds.append(pred)
        idxs.append(idx)
        out[c, 0] = pred
    data = np.frombuffer(block, dtype=np.uint8)[4 * n_ch :]
    # Data is interleaved in 4-byte (8-nibble) groups per channel.
    grouped = data[: n_groups * 4 * n_ch].reshape(n_groups, n_ch, 4)
    for c in range(n_ch):
        chan_bytes = grouped[:, c, :].reshape(-1)
        nibbles = np.empty(len(chan_bytes) * 2, dtype=np.uint8)
        nibbles[0::2] = chan_bytes & 0xF
        nibbles[1::2] = chan_bytes >> 4
        out[c, 1:] = ima_decode_nibbles(nibbles, preds[c], idxs[c])[: frames_per_block - 1]
    return out


def decode_ima_qt_packet(data: bytes, n_ch: int, frames: int = 64) -> np.ndarray:
    """IMA QT: per-channel 2-byte header + 32 data bytes per 64 frames
    (codec_ima_qt.rs)."""
    out = np.empty((n_ch, frames), dtype=np.int32)
    pos = 0
    for c in range(n_ch):
        hdr = int.from_bytes(data[pos : pos + 2], "big")
        pos += 2
        # Upper 9 bits: predictor (left-justified, SIGNED); lower 7: step
        # index. Reinterpret as int16 explicitly — numpy (NEP 50) raises
        # OverflowError on np.int16(x) for x >= 0x8000, so a negative
        # predictor (sign bit set, half of real content) must wrap by hand.
        pred = hdr & 0xFF80
        if pred >= 0x8000:
            pred -= 0x10000
        idx = hdr & 0x7F
        if idx > 88:
            raise DecodeError("invalid IMA step index")
        chunk = np.frombuffer(data[pos : pos + frames // 2], dtype=np.uint8)
        pos += frames // 2
        nibbles = np.empty(frames, dtype=np.uint8)
        nibbles[0::2] = chunk & 0xF
        nibbles[1::2] = chunk >> 4
        out[c] = ima_decode_nibbles(nibbles, int(pred), idx)
    return out


def decode_ms_block(block: bytes, n_ch: int) -> np.ndarray:
    """One MS ADPCM block -> [ch, frames] (codec_ms.rs)."""
    hdr_len = 7 * n_ch
    if len(block) < hdr_len:
        raise DecodeError("MS ADPCM block too small")
    frames = (len(block) - hdr_len) * 2 // n_ch + 2
    out = np.empty((n_ch, frames), dtype=np.int32)
    c1 = np.empty(n_ch, np.int64)
    c2 = np.empty(n_ch, np.int64)
    delta = np.empty(n_ch, np.int64)
    s1 = np.empty(n_ch, np.int64)
    s2 = np.empty(n_ch, np.int64)
    pos = 0
    for c in range(n_ch):
        pidx = block[pos]
        pos += 1
        if pidx >= len(MS_COEFFS):
            raise DecodeError("invalid MS ADPCM predictor")
        c1[c], c2[c] = MS_COEFFS[pidx]
    for c in range(n_ch):
        delta[c] = int.from_bytes(block[pos : pos + 2], "little", signed=True)
        pos += 2
    for c in range(n_ch):
        s1[c] = int.from_bytes(block[pos : pos + 2], "little", signed=True)
        pos += 2
    for c in range(n_ch):
        s2[c] = int.from_bytes(block[pos : pos + 2], "little", signed=True)
        pos += 2
    out[:, 0] = s2
    out[:, 1] = s1
    data = np.frombuffer(block, dtype=np.uint8)[pos:]
    nibbles = np.empty(len(data) * 2, dtype=np.uint8)
    nibbles[0::2] = data >> 4
    nibbles[1::2] = data & 0xF
    # Nibbles alternate across channels sample-by-sample.
    n_samples = (frames - 2) * n_ch
    nibbles = nibbles[:n_samples]
    if _native_mod.ms_decode_nibbles(nibbles, c1, c2, delta, s1, s2, out):
        return out
    for i, nib in enumerate(nibbles):
        c = i % n_ch
        n = int(nib)
        signed = n - 16 if n & 8 else n
        pred = (int(s1[c]) * int(c1[c]) + int(s2[c]) * int(c2[c])) // 256 + signed * int(delta[c])
        pred = max(-32768, min(32767, pred))
        out[c, 2 + i // n_ch] = pred
        s2[c] = s1[c]
        s1[c] = pred
        # Adaptation wraps at 32 bits like the reference's i32 arithmetic
        # (codec_ms.rs:96 in a release build); crafted blocks can otherwise
        # grow delta geometrically without bound.
        m = (int(MS_ADAPT_TABLE[n]) * int(delta[c])) & 0xFFFFFFFF
        if m >= 1 << 31:
            m -= 1 << 32
        delta[c] = max(16, m >> 8)
    return out


class AdpcmDecoder(AudioDecoder):
    """ADPCM audio decoder (codec-adpcm lib.rs:70)."""

    def __init__(self, params: AudioCodecParameters, options: Optional[AudioDecoderOptions] = None):
        super().__init__(params, options)
        if params.sample_rate is None or params.channels is None:
            raise DecodeError("ADPCM requires sample rate and channels")
        if params.codec != CODEC_ID_ADPCM_IMA_QT and not (
                params.block_align and params.block_align > 0):
            raise DecodeError("ADPCM requires block alignment")
        if params.channels.count < 1:
            raise DecodeError("ADPCM requires at least one channel")
        self.spec = AudioSpec(params.sample_rate, params.channels)

    @staticmethod
    def supported_codecs() -> List[str]:
        return [CODEC_ID_ADPCM_MS, CODEC_ID_ADPCM_IMA_WAV, CODEC_ID_ADPCM_IMA_QT]

    def decode(self, packet: Packet) -> AudioBuffer:
        n_ch = self.spec.num_channels
        codec = self.params.codec
        outs = []
        if codec == CODEC_ID_ADPCM_IMA_QT:
            # One packet = 64 frames per channel group of 34 bytes each.
            per = 34 * n_ch
            for off in range(0, len(packet.data) - per + 1, per):
                outs.append(decode_ima_qt_packet(packet.data[off : off + per], n_ch))
        else:
            ba = self.params.block_align
            decode_block = (
                decode_ms_block if codec == CODEC_ID_ADPCM_MS else decode_ima_wav_block
            )
            for off in range(0, len(packet.data) - ba + 1, ba):
                outs.append(decode_block(packet.data[off : off + ba], n_ch))
        if not outs:
            raise DecodeError("packet smaller than one ADPCM block")
        pcm = np.concatenate(outs, axis=1)
        buf = AudioBuffer.from_array(pcm, self.spec, bits_per_sample=16)
        buf.trim(packet.trim_start, packet.trim_end)
        self._last = buf
        return buf
