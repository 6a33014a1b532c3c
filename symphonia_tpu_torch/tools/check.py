"""symphonia-check equivalent: differential decode verification.

Analog of symphonia-check/src/main.rs: decodes a file with this framework
AND with an external reference decoder, then compares the interleaved f32
streams sample-by-sample against the conformance tolerance
``ABS_MAX_ALLOWABLE_SAMPLE_DELTA = 1e-5`` (main.rs:32), accounting packet/
sample failure counts and the absolute maximum delta (main.rs:228-340).

Reference decoders available in this environment:
  * SDL (pygame / SDL_mixer): MP3, OGG Vorbis, WAV incl. ADPCM — the
    analog of the reference spawning ffmpeg/mpg123/oggdec subprocesses.
    SDL outputs s16, so the effective tolerance is 1 LSB + 1e-5.
  * scipy.io.wavfile: WAV PCM.
  * FLAC: STREAMINFO MD5 self-verification (bit-exact whole-stream check,
    the strongest oracle of the three).

Usage: python -m symphonia_tpu_torch.tools.check <file>
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np

S16_LSB = 1.0 / 32768.0


@dataclass
class TestResult:
    n_samples: int = 0
    n_failed_samples: int = 0
    n_packets: int = 0
    n_failed_packets: int = 0
    abs_max_delta: float = 0.0

    def print_report(self, quiet: bool = False) -> None:
        # A packet-level divergence (length mismatch, packet-span skew)
        # fails the run even when every overlapping sample agreed — keep
        # the printed verdict consistent with run_check's exit code.
        ok = self.n_failed_samples == 0 and self.n_failed_packets == 0
        if not quiet:
            print(f"  packets compared: {self.n_packets}")
            print(f"  failed packets:   {self.n_failed_packets}")
            print(f"  samples compared: {self.n_samples}")
            print(f"  failed samples:   {self.n_failed_samples}")
            print(f"  abs max delta:    {self.abs_max_delta:.3e}")
        print(f"  result:           {'PASS' if ok else 'FAIL'}")


def our_decode(data: bytes, gapless: bool, keep_going: bool = False):
    import symphonia_tpu_torch as sym
    from symphonia_tpu_torch.core.codecs import AudioDecoderOptions
    from symphonia_tpu_torch.core.errors import DecodeError
    from symphonia_tpu_torch.core.formats import FormatOptions
    from symphonia_tpu_torch.core.io import MediaSourceStream

    probed = sym.get_probe().probe(
        MediaSourceStream(data), fmt_opts=FormatOptions(enable_gapless=gapless)
    )
    fmt = probed.format
    track = fmt.default_track()
    if track is None:
        raise sym.Unsupported("no audio tracks in input")
    dec = sym.get_codecs().make_audio_decoder(
        track.codec_params, AudioDecoderOptions(verify=True)
    )
    outs = []
    spans = []  # (start_frame, n_frames) per decoded packet
    pos = 0
    while True:
        pkt = fmt.next_packet()
        if pkt is None:
            break
        if pkt.track_id != track.id:
            continue
        try:
            buf = dec.decode(pkt)
        except DecodeError:
            # --keep-going: continue after a decode error (main.rs:404);
            # default aborts the comparison like the reference does.
            if keep_going:
                continue
            raise
        if buf.frames:
            outs.append(buf.to_float().copy())
            spans.append((pos, buf.frames))
            pos += buf.frames
    pcm = np.concatenate(outs, axis=1) if outs else np.zeros((1, 0), np.float32)
    return pcm, track, dec.finalize(), spans


def sdl_decode(path: str, rate: int, channels: int) -> np.ndarray:
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    import pygame

    pygame.mixer.quit()
    pygame.mixer.init(frequency=rate, size=-16, channels=channels)
    got = pygame.mixer.get_init()
    if got is None or got[0] != rate or abs(got[1]) != 16 or \
            got[2] != channels:
        # Sound.get_raw() is at the OPENED format; comparing against a
        # silently-changed rate/layout would produce thousands of false
        # failures.
        raise RuntimeError(f"mixer opened at {got}, wanted "
                           f"({rate}, +-16, {channels})")
    raw = np.frombuffer(pygame.mixer.Sound(path).get_raw(), dtype=np.int16)
    return (raw.astype(np.float32) / 32768.0).reshape(-1, channels).T


def run_check(path: str, tolerance: float = 1e-5, gapless: bool = False,
              ref_name: str = "auto", quiet: bool = False,
              samples: bool = False, first_fail: bool = False,
              keep_going: bool = False) -> int:
    with open(path, "rb") as f:
        data = f.read()
    ours, track, fin, spans = our_decode(data, gapless, keep_going)
    codec = track.codec_params.codec
    if not quiet:
        print(f"checking {path} ({codec})")

    use_md5 = ref_name == "md5" or (ref_name == "auto" and codec == "flac")
    if use_md5:
        # Bit-exact whole-stream MD5 self-verification (validate.rs:18).
        if fin.verify_ok is None:
            print("  no STREAMINFO MD5 present; nothing to verify against")
            return 1
        print(f"  FLAC MD5 self-verification: {'PASS' if fin.verify_ok else 'FAIL'}")
        return 0 if fin.verify_ok else 2

    # SDL_mixer's MP3 backend here is drmp3 (Layer III ONLY) — mp1/mp2
    # have no SDL reference and route to cross mode.
    sdl_ok = (codec in ("mp3", "vorbis")
              or codec.startswith(("pcm", "adpcm")))
    sdl_ok = (sdl_ok and track.codec_params.sample_rate
              and track.codec_params.channels is not None)
    if ref_name in ("auto", "sdl") and sdl_ok:
        try:
            ref = sdl_decode(path, track.codec_params.sample_rate,
                             track.codec_params.channels.count)
        except Exception as e:
            # SDL can't load this file (corrupt input, unsupported
            # variant, mixer format rejected): fail THIS file gracefully
            # in sdl mode, fall through to cross mode in auto.
            if ref_name == "sdl":
                print(f"  SDL reference unavailable: {e}")
                return 1
            ref = None
        if ref is not None:
            # Reference output is s16-quantized and clips at full scale.
            clipped = np.clip(ours, -1.0, 32767.0 / 32768.0)
            # No independent span table: SDL decode has no packet
            # structure.
            return _compare(clipped, ref, spans, tolerance + S16_LSB,
                            None, quiet, samples, first_fail)

    if ref_name == "cross" or ref_name == "auto":
        # Cross-implementation check (no external binary oracle exists for
        # AAC/ALAC/OGG-FLAC in this environment, main.rs:69-118 spawns
        # ffmpeg there): decode a second time with every native fast path
        # disabled, so the pure-Python oracle decoders are the independent
        # reference implementation.
        from symphonia_tpu_torch import native

        if not quiet:
            print("  cross check: native fast paths vs Python oracle path")
        with native.disabled():
            ref, _, _, ref_spans = our_decode(data, gapless, keep_going)
        return _compare(ours, ref, spans, tolerance, ref_spans, quiet,
                        samples, first_fail)

    print(f"  no external reference decoder for codec '{codec}'")
    return 1


def _compare(ours: np.ndarray, ref: np.ndarray, spans, tol: float,
             ref_spans, quiet: bool, samples: bool,
             first_fail: bool) -> int:
    if ours.shape[0] != ref.shape[0]:
        print(f"  channel count mismatch: {ours.shape[0]} vs {ref.shape[0]}")
        return 2
    n = min(ours.shape[1], ref.shape[1])
    delta = np.abs(ours[:, :n] - ref[:, :n])
    result = TestResult(
        n_samples=int(delta.size),
        n_failed_samples=int((delta > tol).sum()),
        abs_max_delta=float(delta.max()) if delta.size else 0.0,
    )
    # Per-packet accounting (main.rs:228-340): a packet fails when any of
    # its samples exceeds the tolerance.
    for start, length in spans:
        if start >= n:
            break
        d = delta[:, start : min(start + length, n)]
        result.n_packets += 1
        if d.size and float(d.max()) > tol:
            result.n_failed_packets += 1
            if samples and not quiet:
                bad = np.argwhere(d > tol)
                for ch, off in bad[:20]:
                    print(f"    packet@{start}: ch{ch} frame "
                          f"{start + int(off)} delta "
                          f"{float(d[ch, off]):.3e}")
            if first_fail:
                break
    if ours.shape[1] != ref.shape[1]:
        print(f"  length mismatch: {ours.shape[1]} vs {ref.shape[1]} frames")
        result.n_failed_packets += 1
    # Span-table divergence (cross mode): the two implementations decoded
    # a different packet structure (e.g. one path dropped a packet the
    # other decoded) — a conformance failure even if the overlapping
    # samples agree.
    if ref_spans is not None and list(spans) != list(ref_spans):
        print(f"  packet-span divergence: {len(spans)} vs "
              f"{len(ref_spans)} decoded spans")
        result.n_failed_packets += 1
    result.print_report(quiet)
    ok = result.n_failed_samples == 0 and result.n_failed_packets == 0
    return 0 if ok else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="symphonia_tpu conformance checker")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--tolerance", type=float, default=1e-5)
    ap.add_argument("--gapless", action="store_true")
    ap.add_argument("--no-gapless", action="store_true",
                    help="disable gapless decoding (reference default here)")
    ap.add_argument("--ref", choices=["auto", "sdl", "md5", "cross"],
                    default="auto",
                    help="reference oracle (main.rs:410 --ref analog); "
                         "'cross' compares the native fast paths against "
                         "the in-tree Python oracle decoders (for codecs "
                         "with no external binary oracle: AAC, ALAC, "
                         "OGG-FLAC)")
    ap.add_argument("--samples", action="store_true",
                    help="print failures per sample (main.rs:384)")
    ap.add_argument("-f", "--first-fail", action="store_true",
                    help="stop after the first failed packet (main.rs:390)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print test results (main.rs:397)")
    ap.add_argument("--keep-going", action="store_true",
                    help="continue after a decode error (main.rs:404)")
    args = ap.parse_args(argv)
    worst = 0
    for path in args.files:
        worst = max(worst, run_check(
            path, args.tolerance, args.gapless and not args.no_gapless,
            args.ref, args.quiet, args.samples, args.first_fail,
            args.keep_going))
    return worst


if __name__ == "__main__":
    raise SystemExit(main())
