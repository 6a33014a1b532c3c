"""Decode a whole file through the batch (CUDA) path and export interleaved
samples — the analog of symphonia/examples/basic-interleaved.rs, but using
the batch-native API that is this framework's preferred bulk entry point.

Usage: python -m symphonia_tpu_torch.examples.basic_interleaved <media-file>
"""

import os
import sys

import numpy as np

# Allow running as a script from a repo checkout.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from symphonia_tpu_torch import batch


def main(path: str, device="cuda") -> int:
    out = batch.decode_bytes(open(path, "rb").read(), device=device)
    planar = out.samples                      # [channels, frames]
    interleaved = np.ascontiguousarray(planar.T)  # [frames, channels]
    print(f"rate={out.sample_rate} bits={out.bits_per_sample} "
          f"shape={interleaved.shape} dtype={interleaved.dtype}")
    if out.md5_ok is not None:
        print(f"verified: {out.md5_ok}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    raise SystemExit(main(sys.argv[1]))
