"""Run one cell of the benchmark:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card and prints one JSON line
last on standard output; see ``benchmark/harness.py``.
"""

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Compile caches at fixed paths inside the checkout (the port's own nvcc
# and g++ outputs already are: symphonia_tpu_torch/_build/, native/).
CACHE = os.path.join(ROOT, "benchmark", ".cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(t0=T0))
