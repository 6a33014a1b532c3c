"""Batch serving: decode many files with merged device dispatches.

Port of ``examples/batch_serving.py``: probe and group a batch of streams,
merge frame lanes across files into shared kernel launches on the card
(FLAC, MPEG audio, AAC, Vorbis; every other stream takes the per-packet
loop), and get per-file planar PCM back, equal to decoding each file
alone.

Usage: python -m symphonia_tpu_torch.examples.batch_serving <file> [<file> ...]
"""

import os
import sys
import time


def main(argv=None, device="cuda") -> int:
    paths = sys.argv[1:] if argv is None else list(argv)
    if not paths:
        print(__doc__)
        return 2
    from ..batch import decode_many, resolve_device

    resolve_device(device)
    datas = [open(p, "rb").read() for p in paths]
    t0 = time.perf_counter()
    outs = decode_many(datas, device=device)
    dt = time.perf_counter() - t0
    audio_s = 0.0
    for path, out in zip(paths, outs):
        secs = out.samples.shape[1] / max(out.sample_rate, 1)
        audio_s += secs
        print(f"  {os.path.basename(path)}: {out.samples.shape[0]} ch, "
              f"{out.samples.shape[1]} frames ({secs:.2f}s) "
              f"@ {out.sample_rate} Hz")
    print(f"decoded {len(outs)} files, {audio_s:.1f}s of audio in "
          f"{dt * 1e3:.0f} ms ({audio_s / max(dt, 1e-9):.0f}x realtime)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
