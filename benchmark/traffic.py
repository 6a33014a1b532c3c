"""The one traffic generator: a traffic file's parameters -> requests.

A traffic file (``traffic/<name>.json``) gives:

- ``pool``: distinct streams the cell's generator makes;
- ``batch``: streams in each request (``decode_many`` on that many);
- ``compare_every``: the outputs of request 0 and of every
  ``compare_every``-th request after it are kept for the check after the
  window, the same requests whatever the seed.

Requests come from one caller in a closed loop: the next one goes in when
the last one returns. Streams are taken in seeded permutations of the
pool, one after another, so every stream is used equally often whatever
the seed.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def requests(traffic: dict, seed: int) -> Iterator[List[int]]:
    """The cell's endless sequence of requests (pool indices) for
    ``seed``."""
    rng = np.random.default_rng([seed % (1 << 64), 0x7EAF])
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    if not 0 < batch <= pool:
        raise ValueError("batch must be in 1..pool")
    order: list = []
    while True:
        while len(order) < batch:
            order.extend(rng.permutation(pool).tolist())
        idx, order = order[:batch], order[batch:]
        yield idx


def kept(traffic: dict, n: int) -> bool:
    """Whether request ``n`` of the window keeps its outputs for the
    check."""
    return n % int(traffic["compare_every"]) == 0


def warm_up(traffic: dict, pool) -> List[List[int]]:
    """The requests set-up runs before the window: the shapes the
    traffic uses, each stream of the pool once, in requests of the
    traffic's batch (one request of the whole pool for bulk traffic)."""
    batch = int(traffic["batch"])
    return [list(range(a, min(a + batch, len(pool))))
            for a in range(0, len(pool), batch)]
