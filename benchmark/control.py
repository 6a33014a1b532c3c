"""Read a cell's compared numbers for the program and for its control, on
the card at the cell's own size, seed after seed, in one process:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--control-seeds <n> ...]

For each seed: the pool, then ``decode_many`` over it as the cell's
traffic sends it (the whole pool in one request for bulk traffic, each
stream alone otherwise), judged by the reference; for each control seed,
the reference's control in the program's place, judged the same way. One JSON line per reading. The limits in the configuration
files were set from these readings (PERF.md). Not part of a cell's run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from benchmark import harness
    from symphonia_tpu_torch import batch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    spec = harness.load_spec(ROOT)
    c = harness.cell(spec, a.workload, ROOT)
    cfg, tr = c["config"], c["traffic"]
    gen = harness.codec_module("gen", cfg["codec"])
    ref = harness.codec_module("reference", cfg["codec"])
    kw = dict(device=a.device, verify=bool(cfg.get("verify", False)))
    whole = int(tr["batch"]) >= int(tr["pool"])
    for seed in a.seeds + a.control_seeds:
        control = seed in a.control_seeds and seed not in a.seeds
        t = time.perf_counter()
        pool = gen.make_pool(cfg, int(tr["pool"]), seed, a.device)
        idx = list(range(len(pool)))
        if control:
            outs = ref.control(pool, a.device)
            reqs = [(idx, outs)]
        elif whole:
            reqs = [(idx, batch.decode_many([s.data for s in pool], **kw))]
        else:
            reqs = [([i], batch.decode_many([pool[i].data], **kw))
                    for i in idx]
        if a.device == "cuda":
            torch.cuda.empty_cache()
        got = ref.judge(pool, reqs, a.device)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "side": "control" if control else "program",
                          **got, "limits": cfg["checks"],
                          "s": time.perf_counter() - t}), flush=True)
        del pool, reqs
    return 0


if __name__ == "__main__":
    sys.exit(main())
