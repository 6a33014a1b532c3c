"""Getting started: probe a file, decode its default track, report timing.

Analog of symphonia/examples/getting-started.rs: open -> probe -> decoder
loop with ResetRequired handling, printing basic stream info.

Usage: python -m symphonia_tpu_torch.examples.getting_started <media-file>
"""

import os
import sys
import time

# Allow running as a script from a repo checkout.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import symphonia_tpu_torch as sym
from symphonia_tpu_torch.core.errors import DecodeError, ResetRequired
from symphonia_tpu_torch.core.io import MediaSourceStream


def main(path: str) -> int:
    with open(path, "rb") as f:
        data = f.read()

    probed = sym.get_probe().probe(MediaSourceStream(data))
    fmt = probed.format
    track = fmt.default_track()
    if track is None:  # e.g. a video-only container: demuxable, no audio
        print("no audio track in this container", file=sys.stderr)
        return 1
    params = track.codec_params
    print(f"container: {type(fmt).__name__}")
    print(f"codec:     {params.codec}")
    print(f"rate:      {params.sample_rate} Hz, "
          f"channels: {params.channels.count if params.channels else '?'}")

    decoder = sym.get_codecs().make_audio_decoder(params)
    n_frames = 0
    t0 = time.perf_counter()
    while True:
        packet = fmt.next_packet()
        if packet is None:
            break
        if packet.track_id != track.id:
            continue  # another track (video/subtitle or second audio)
        try:
            audio = decoder.decode(packet)
        except ResetRequired:
            decoder.reset()
            continue
        except DecodeError as e:
            print(f"  skipping bad packet: {e}", file=sys.stderr)
            continue
        n_frames += audio.frames
    wall = time.perf_counter() - t0
    secs = n_frames / params.sample_rate if params.sample_rate else 0.0
    print(f"decoded:   {n_frames} frames ({secs:.2f} s) in {wall*1e3:.1f} ms"
          + (f" ({secs/wall:.0f}x realtime)" if wall > 0 else ""))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    raise SystemExit(main(sys.argv[1]))
