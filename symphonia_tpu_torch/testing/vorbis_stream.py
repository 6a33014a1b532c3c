"""Whole Ogg Vorbis streams for the port's tools and tests, from the
stereo setup header and audio packets of :mod:`.vorbis_builder` and the Ogg
pages of :mod:`.ogg_builder`: the Vorbis content that ``chip_smoke.py``, the
bench and the soak decode."""

import numpy as np

from ..codecs.vorbis import VorbisDecoder
from ..core.codecs import AudioCodecParameters
from . import vorbis_builder as vb
from .ogg_builder import _ogg_page


def build_vorbis(rate: int, bs0_exp: int, bs1_exp: int, seconds: float,
                 seed: int) -> bytes:
    """A stereo Ogg Vorbis stream of about ``seconds`` at ``rate``, blocks
    of 2**bs0_exp and 2**bs1_exp samples.

    The setup header and the audio packets are :mod:`.vorbis_builder`'s
    stereo variant (floor 0, residue 2, square-polar coupling); the
    identification header is written here for the rate and block sizes.
    Packets are rejection-sampled as ``test_vorbis_ogg``'s
    ``_tame_stereo_stream`` does (floor amplitudes 1-4, kept only if the
    spectra are finite and below 1e3): the raw builder's floor curves
    overflow to inf. A quarter of the packets are short blocks, at random.
    """
    bw = vb.BitWriterLsb()
    bw.write(0, 32)  # version
    bw.write(2, 8)   # channels
    bw.write(rate, 32)
    bw.write(0, 96)  # bitrates
    bw.write(bs0_exp, 4)
    bw.write(bs1_exp, 4)
    bw.write(1, 1)   # framing
    ident = b"\x01vorbis" + bw.to_bytes()
    vendor = b"chip_smoke"
    comment = (b"\x03vorbis" + len(vendor).to_bytes(4, "little") + vendor
               + (0).to_bytes(4, "little") + b"\x01")
    setup = vb.build_setup_header_stereo()
    params = AudioCodecParameters()
    params.codec = "vorbis"
    params.extra_data = ident + setup
    dec = VorbisDecoder(params)
    rng = np.random.default_rng(seed)
    sizes = (1 << bs0_exp, 1 << bs1_exp)
    pkts = []  # (packet, granule position after it)
    total, prev = 0, None
    while total < seconds * rate:
        long_block = bool(rng.random() < 0.75)
        # Residue 2 codes min(end, 2 * n2) values in partitions of 8.
        parts = min(vb.R2_END, sizes[long_block]) // vb.PART_SIZE
        for _ in range(200):
            amps = (int(rng.integers(1, 5)), int(rng.integers(1, 5)))
            fe = tuple((int(rng.integers(0, 16)), int(rng.integers(0, 16)))
                       for _ in range(2))
            ce = [int(rng.integers(0, 4)) for _ in range(parts // 2)]
            pe = [[int(rng.integers(0, 16)) for _ in range(4)]
                  for _ in range(parts)]
            pkt = vb.build_audio_packet_stereo(long_block, amps, fe, ce, pe)
            spectra, _ = dec.decode_spectra(pkt)
            if np.isfinite(spectra).all() and np.abs(spectra).max() < 1e3:
                break
        else:
            raise RuntimeError("no tame Vorbis packet in 200 tries")
        if prev is not None:
            total += (prev + sizes[long_block]) // 4
        prev = sizes[long_block]
        pkts.append((pkt, total))
    serial = 0x5EED + seed
    pages = [_ogg_page(serial, 0, 0, [ident], header_type=2),
             _ogg_page(serial, 1, 0, [comment, setup])]
    for i in range(0, len(pkts), 16):
        chunk = pkts[i : i + 16]
        pages.append(_ogg_page(serial, 2 + i // 16, chunk[-1][1],
                               [p for p, _ in chunk],
                               header_type=4 if i + 16 >= len(pkts) else 0))
    return b"".join(pages)
