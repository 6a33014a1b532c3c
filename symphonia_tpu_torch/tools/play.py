"""symphonia-play equivalent: probe, decode, benchmark, and play media.

Analog of symphonia-play/src/main.rs: ``--probe-only`` prints container/
track/metadata info, ``--decode-only`` benchmarks decode speed (main.rs:258),
``--output`` writes decoded PCM to a WAV file, ``--seek`` seeks before
decoding, ``--verify`` enables decode verification (FLAC MD5), and ``--play``
plays through the SDL audio device when one exists (the reference's
PulseAudio/CPAL backends, output.rs).

Usage: python -m symphonia_tpu_torch.tools.play [flags] <file>
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def format_time(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"


def print_probe_info(probed, track) -> None:
    p = track.codec_params
    print(f"  codec:        {p.codec}")
    print(f"  sample rate:  {p.sample_rate}")
    print(f"  channels:     {p.channels.count if p.channels else '?'}")
    if p.bits_per_sample:
        print(f"  bits/sample:  {p.bits_per_sample}")
    if track.num_frames and p.sample_rate:
        print(f"  duration:     {format_time(track.num_frames / p.sample_rate)}")
    rev = probed.metadata.current() if probed.metadata else None
    if rev is None:
        fr = probed.format.metadata()
        rev = fr.current() if fr else None
    if rev:
        print("  tags:")
        for tag in rev.tags[:20]:
            key = tag.std_key or tag.key
            print(f"    {key}: {tag.value}")
        for v in rev.visuals:
            print(f"    [visual] {v.media_type or 'image'} ({len(v.data)} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="symphonia_tpu player")
    ap.add_argument("file")
    ap.add_argument("--probe-only", action="store_true")
    ap.add_argument("--decode-only", action="store_true",
                    help="decode without output and report realtime speed")
    ap.add_argument("--output", help="write decoded audio to a WAV file")
    ap.add_argument("--seek", type=float, help="seek to time (seconds)")
    ap.add_argument("--seek-ts", type=int,
                    help="seek to a timestamp in TimeBase units (main.rs:67)")
    ap.add_argument("--track", type=int, help="track id to decode")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--verify-only", action="store_true",
                    help="decode solely to verify, no output (main.rs:99)")
    ap.add_argument("--no-gapless", action="store_true")
    ap.add_argument("--no-progress", action="store_true",
                    help="suppress the playback progress line")
    ap.add_argument("--play", action="store_true", help="play via SDL")
    ap.add_argument("--tui", action="store_true",
                    help="curses now-playing UI during --play (ui.rs analog)")
    ap.add_argument("--dump-visuals", action="store_true",
                    help="write attached pictures next to the input file")
    args = ap.parse_args(argv)

    import symphonia_tpu_torch as sym
    from symphonia_tpu_torch.core.formats import FormatOptions, SeekMode, SeekTo
    from symphonia_tpu_torch.core.codecs import AudioDecoderOptions
    from symphonia_tpu_torch.core.io import MediaSourceStream

    with open(args.file, "rb") as f:
        data = f.read()
    mss = MediaSourceStream(data)
    fmt_opts = FormatOptions(enable_gapless=not args.no_gapless)
    probed = sym.get_probe().probe(mss, fmt_opts=fmt_opts)
    fmt = probed.format
    track = fmt.default_track()
    if args.track is not None:
        track = next((t for t in fmt.tracks() if t.id == args.track), None)
        if track is None:
            print(f"no audio track with id {args.track}", file=sys.stderr)
            return 1
    if track is None:
        print("no audio tracks in input", file=sys.stderr)
        return 1

    print(f"{type(fmt).__name__}:")
    print_probe_info(probed, track)

    if args.dump_visuals:
        # symphonia-play --dump-visuals: write each attached picture to
        # <input>-<n>.<ext>.
        import os

        exts = {"image/jpeg": "jpg", "image/png": "png", "image/gif": "gif",
                "image/bmp": "bmp"}
        # The reader's log already includes probe-consumed revisions (they
        # ride in via FormatOptions.external_data), so dedupe by identity.
        revs = []
        for log in (fmt.metadata(), probed.metadata):
            rev = log.current() if log else None
            if rev is not None and not any(rev is r for r in revs):
                revs.append(rev)
        count = 0
        base, _ = os.path.splitext(args.file)
        for rev in revs:
            if rev is None:
                continue
            for v in rev.visuals:
                ext = exts.get(v.media_type or "", "bin")
                out_path = f"{base}-{count}.{ext}"
                with open(out_path, "wb") as fo:
                    fo.write(v.data)
                print(f"  wrote visual: {out_path} ({len(v.data)} bytes)")
                count += 1
        if count == 0:
            print("  no visuals to dump")

    if args.probe_only:
        return 0

    seeked = args.seek is not None or args.seek_ts is not None
    if args.seek is not None:
        fmt.seek(SeekMode.ACCURATE, SeekTo(time=sym.Time.from_seconds(args.seek)))
    elif args.seek_ts is not None:
        fmt.seek(SeekMode.ACCURATE, SeekTo(ts=args.seek_ts))

    verify = args.verify or args.verify_only
    if verify and seeked:
        # The MD5 monitor would hash only the post-seek suffix and
        # "FAIL" a pristine file (the decoder disables verification on
        # reset/seek for the same reason, codecs/flac.py).
        print("  verification skipped: whole-stream MD5 cannot be "
              "checked after a seek", file=sys.stderr)
        verify = False
    dec = sym.get_codecs().make_audio_decoder(
        track.codec_params,
        AudioDecoderOptions(verify=verify),
    )
    outs = []
    n_samples = 0
    t0 = time.perf_counter()
    while True:
        pkt = fmt.next_packet()
        if pkt is None:
            break
        if pkt.track_id != track.id:
            continue
        try:
            buf = dec.decode(pkt)
        except sym.DecodeError as e:
            print(f"  decode error (skipped packet): {e}", file=sys.stderr)
            continue
        n_samples += buf.frames
        if not (args.decode_only or args.verify_only):
            outs.append(buf.planes().copy())
            pcm_bits = buf.bits_per_sample
    elapsed = time.perf_counter() - t0

    fin = dec.finalize()
    if fin.verify_ok is not None:
        print(f"  verification: {'passed' if fin.verify_ok else 'FAILED'}")
    if args.verify_only:
        return 0 if fin.verify_ok is not False else 1

    rate = track.codec_params.sample_rate or 1
    audio_s = n_samples / rate
    print(f"  decoded {n_samples} frames ({format_time(audio_s)}) in "
          f"{elapsed * 1e3:.0f} ms ({audio_s / max(elapsed, 1e-9):.0f}x realtime)")

    if args.decode_only or not outs:
        return 0

    pcm = np.concatenate(outs, axis=1)
    if pcm.dtype.kind != "f":
        # Integer planes are right-justified at the stream's bit depth
        # (core/audio.py); scale to full-range float BEFORE export or
        # playback (raw s16 clipping turned 24-bit audio into garbage and
        # 8-bit audio into near-silence).
        pcm = pcm.astype(np.float32) / float(1 << (int(pcm_bits) - 1))
    if args.output:
        _write_wav(args.output, pcm, rate)
        print(f"  wrote {args.output}")
    if args.play:
        ui = None
        if args.tui:
            from .ui import NowPlayingUI

            rev = fmt.metadata().current() if fmt.metadata() else None
            info = [("codec", track.codec_params.codec or "?"),
                    ("rate", str(rate)),
                    ("channels", str(pcm.shape[0]))]
            title = args.file
            if rev:
                for tag in rev.tags[:8]:
                    info.append((tag.std_key or tag.key, str(tag.value)))
                    if tag.std_key == "track_title":
                        title = str(tag.value)
            ui = NowPlayingUI(title, info, pcm.shape[1] / rate)
        _play_sdl(pcm, rate, ui, progress=not args.no_progress)
    return 0


def _write_wav(path: str, pcm: np.ndarray, rate: int) -> None:
    import wave

    if pcm.dtype.kind == "f":
        s16 = (np.clip(pcm, -1, 32767 / 32768) * 32768.0).astype("<i2")
    else:  # callers normalize to float; raw ints are assumed s16-range
        s16 = np.clip(pcm, -(1 << 15), (1 << 15) - 1).astype("<i2")
    inter = np.ascontiguousarray(s16.T)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(inter.tobytes())


def _play_sdl(pcm: np.ndarray, rate: int, ui=None, progress=True) -> None:
    try:
        import pygame

        pygame.mixer.init(frequency=rate, size=-16, channels=pcm.shape[0])
        total = pcm.shape[1] / rate  # before any device-rate resample
        # If the device opened at a different rate/layout, convert
        # (resampler.rs analog; tools/resample.py).
        got = pygame.mixer.get_init()
        got_rate, got_ch = got[0], got[2]
        if got_ch and got_ch != pcm.shape[0]:
            if pcm.dtype.kind != "f":
                pcm = pcm.astype(np.float32) / 32768.0
            # Downmix to mono then tile: crude but playback survives a
            # device that refused the file's channel count.
            pcm = np.tile(pcm.mean(axis=0, keepdims=True), (got_ch, 1))
        if got_rate and got_rate != rate:
            from .resample import resample

            if pcm.dtype.kind != "f":
                pcm = pcm.astype(np.float32) / 32768.0
            pcm = resample(pcm, rate, got_rate)
        if pcm.dtype.kind == "f":
            s16 = (np.clip(pcm, -1, 32767 / 32768) * 32768.0).astype(np.int16)
        else:
            s16 = np.clip(pcm, -32768, 32767).astype(np.int16)
        arr = s16.T if s16.shape[0] > 1 else s16[0]  # mono mixer wants 1-D
        snd = pygame.sndarray.make_sound(np.ascontiguousarray(arr))
        ch = snd.play()
        if ui is not None:
            ui.controls = {"pause": pygame.mixer.pause,
                           "resume": pygame.mixer.unpause,
                           "stop": pygame.mixer.stop}
            ui.run(ch.get_busy)
        else:
            t0 = time.monotonic()
            while ch.get_busy():
                if progress:
                    pos = min(time.monotonic() - t0, total)
                    print(f"\r  playing {format_time(pos)} / "
                          f"{format_time(total)} ", end="", flush=True)
                time.sleep(0.1)
            if progress:
                print()
    except Exception as e:  # no audio device etc.
        print(f"  playback unavailable: {e}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
