"""The (dp, tp) mesh of ranks for the batched decode step.

Counterpart of ``symphonia_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` of devices and ``NamedSharding`` specs tell XLA how
to split the arrays, and XLA inserts the collectives. Here a mesh is the
layout of ``torch.distributed`` ranks: the ``dp`` axis splits the lane
(frame, granule) batch into contiguous blocks, the ``tp`` axis splits the
outputs' sample axis into column blocks, and :mod:`.step` moves the
tensors itself. Ranks are laid out row-major as the reference's devices
are: rank ``r`` sits at ``(r // tp, r % tp)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Mesh:
    """``dp`` rows by ``tp`` columns of ranks."""

    dp: int
    tp: int

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def ranks(self) -> np.ndarray:
        """The ranks in their mesh positions, ``[dp, tp]``."""
        return np.arange(self.size).reshape(self.dp, self.tp)

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(dp, tp)`` coordinates of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        return rank // self.tp, rank % self.tp


def make_mesh(world_size: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1) -> Mesh:
    """Build a (dp, tp) mesh over ``world_size`` ranks (the initialized
    process group's size when None)."""
    if world_size is None:
        import torch.distributed as dist

        world_size = dist.get_world_size()
    n = int(world_size)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    return Mesh(dp, tp)


def block_range(n: int, parts: int, i: int) -> Tuple[int, int]:
    """``[lo, hi)`` of block ``i`` when ``n`` items split into ``parts``
    contiguous blocks of ``ceil(n / parts)`` (the last one shorter, or
    empty), as a sharded axis splits."""
    size = -(-n // parts)
    return min(n, i * size), min(n, (i + 1) * size)


def lane_range(mesh: Mesh, rank: int, n: int) -> Tuple[int, int]:
    """The contiguous lanes of ``n`` that ``rank``'s dp row holds (the
    reference's ``lane_sharding``, ``P("dp")``); the tp ranks of a row hold
    the same lanes."""
    return block_range(n, mesh.dp, mesh.coords(rank)[0])


def column_range(mesh: Mesh, rank: int, n: int) -> Tuple[int, int]:
    """The columns of a sample axis of ``n`` that ``rank``'s tp coordinate
    holds (``P(..., "tp")``)."""
    return block_range(n, mesh.tp, mesh.coords(rank)[1])


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Zero-pad an axis to a multiple (lanes must divide evenly across dp)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths)
