"""The combined decode step sharded over a (dp, tp) mesh of ranks.

Counterpart of the reference's sharded ``_decode_step``
(``__graft_entry__.py:181-246``). There ``jax.jit`` takes
``in_shardings``/``out_shardings`` and XLA inserts the collectives,
including the ``ppermute``s that carry the step's couplings between
neighbouring lanes across a shard's edge. ``torch.distributed`` inserts
nothing, so each rank is given, besides its own contiguous block of lanes,
the lanes before it that its first outputs depend on (its halo). It runs
the port's own stages (``entry._stages``: the kernels on CUDA tensors,
their plain twins on the CPU) on the halo and its block as one stream that
starts at the halo, drops the halo's outputs, keeps its tp column block of
each output's sample axis, and all ranks gather every block into the full
outputs.

The halo lanes get the stream-start treatment that the single step gives
lane 0 (MP3's carried tails None, A3's ``first`` set, Vorbis' first overlap
zero), so the outputs kept equal the unsharded step's. The tp ranks of one
dp row compute the same lanes, as the reference's step computes them;
splitting the work of the products' columns over tp is later work.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, column_range, lane_range, pad_to_multiple

# Halo depths: the lanes before a rank's first lane that its first kept
# output depends on, through the state the single step carries from lane to
# lane.
# FLAC frames are independent.
FLAC_HALO = 0
# MP3 (M1, M2; the reference's mp3_dense_batch_jax, symphonia_tpu/ops/
# mp3_dense.py:346-362): the hybrid tail [C, 32, 18] entering granule g is
# the second half of x[g-1]'s IMDCT, and the 480-sample synthesis tail
# entering g is the last 15 of the 18 slots of S[g-1], which itself takes
# x[g-2]'s hybrid tail. So pcm[g] needs x[g], x[g-1] and x[g-2]: two
# granules.
MP3_HALO = 2
# AAC (A3; _ola_jax, symphonia_tpu/ops/aac_dense.py:209): lane a's output
# overlaps the second half of lane a-1's time signal.
AAC_HALO = 1
# Vorbis (V2; __graft_entry__.py:120): lane v's lap rolls in the second
# half of lane v-1's IMDCT.
VORBIS_HALO = 1


class Stage(NamedTuple):
    """One codec stage of the step: ``fn`` maps a run of lanes on the device
    (axis 0 of every tensor), its first lane taken as the stream's start,
    to their outputs; ``arrays`` are the whole batch's lanes on the host;
    ``halo`` is the stage's halo depth."""

    fn: Callable
    arrays: Sequence[np.ndarray]
    halo: int


def flac_stage(k, arrays, n_samples: int) -> Stage:
    """FLAC's ``[F, 2, N]`` output from ``arrays``: ``res [F, 2, N]``,
    ``coefs [F, 2, 32]``, ``order``/``shift``/``wasted`` ``[F, 2]`` and
    ``assign [F]``, frame-major."""
    from ..entry import flac_step

    def fn(res, coefs, order, shift, wasted, assign):
        L = 2 * res.shape[0]
        return flac_step(k, res.reshape(L, n_samples), coefs.reshape(L, -1),
                         order.reshape(L), shift.reshape(L),
                         wasted.reshape(L), assign, n_samples)

    return Stage(fn, arrays, FLAC_HALO)


def mp3_stage(k, arrays) -> Stage:
    """MP3's ``[G, C, 576]`` output from ``(spectra, bt, mixed)``."""
    from ..entry import mp3_step

    return Stage(lambda *a: mp3_step(k, *a), arrays, MP3_HALO)


def aac_stage(k, arrays, sfb: torch.Tensor) -> Stage:
    """AAC's ``[A, 1024]`` output from ``(coeffs, qbuf, scales, deq, seqs,
    shapes, prev_shapes)`` and the band map ``sfb`` on the device (every
    rank holds all of it)."""
    from ..entry import aac_step

    return Stage(lambda *a: aac_step(k, *a, sfb), arrays, AAC_HALO)


def vorbis_stage(k, arrays) -> Stage:
    """Vorbis' ``[V, n1/2]`` output from ``(spec,)``."""
    from ..entry import vorbis_step

    return Stage(lambda spec: vorbis_step(k, spec), arrays, VORBIS_HALO)


class Local(NamedTuple):
    """A run of lanes on the device: the lanes ``arrays`` (the halo first),
    the halo's length ``h``, the kept lanes' count ``m`` and the whole
    batch's lane count ``n``."""

    arrays: list
    h: int
    m: int
    n: int


def cut(arrays: Sequence[np.ndarray], lo: int, hi: int, halo: int,
        device) -> Local:
    """Lanes ``[lo, hi)`` of ``arrays`` with the ``halo`` lanes before them
    (fewer at the batch's start), copied to ``device``: the one place a
    halo is cut."""
    h = min(halo, lo)
    return Local([torch.as_tensor(a[lo - h:hi]).to(device) for a in arrays],
                 h, hi - lo, len(arrays[0]))


def run(fn: Callable, local: Local) -> torch.Tensor:
    """``fn`` on ``local``'s lanes as one stream that starts at the halo,
    the halo's outputs dropped."""
    return fn(*local.arrays)[local.h:]


def local_lanes(arrays: Sequence[np.ndarray], mesh: Mesh, rank: int,
                halo: int, device) -> Local:
    """``rank``'s block of the lanes padded with zeros to a multiple of dp,
    with its halo, on ``device``."""
    padded = [pad_to_multiple(np.asarray(a), mesh.dp) for a in arrays]
    lo, hi = lane_range(mesh, rank, len(padded[0]))
    return cut(padded, lo, hi, halo, device)._replace(n=len(arrays[0]))


def gather(block: torch.Tensor, mesh: Mesh, n_cols: int) -> torch.Tensor:
    """Every rank's ``[rows, ..., cols]`` block (equal rows on every rank,
    its tp column block of ``n_cols``) into the full ``[dp * rows, ...,
    n_cols]`` on the block's device, on every rank. Under gloo the
    collective's tensors go through host memory (gloo's ``all_gather``
    takes CPU tensors)."""
    width = -(-n_cols // mesh.tp)
    send = torch.nn.functional.pad(block, (0, width - block.shape[-1]))
    if dist.get_backend() == "gloo":
        send = send.cpu()
    send = send.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send)
    rows = [torch.cat(parts[i * mesh.tp:(i + 1) * mesh.tp], dim=-1)
            [..., :n_cols] for i in range(mesh.dp)]
    return torch.cat(rows, dim=0).to(block.device)


def sharded_stages(stages: Sequence[Stage], mesh: Mesh, rank: int,
                   device) -> Tuple[Tuple[torch.Tensor, ...], dict]:
    """``stages`` on ``rank`` of ``mesh``, in the initialized process group:
    each stage's lanes with their halo to ``device``, its ``fn`` run there,
    the halo's outputs dropped, the rank's tp column block of the sample
    axis kept, every rank's block gathered and the padding cut. Returns
    each stage's full output on ``device`` and the rank's times in
    milliseconds: ``h2d_ms`` (the lanes to the device), ``step_ms`` (the
    stages), both CUDA events on the card and the host clock on the CPU,
    and ``gather_ms`` (the gathers, host clock)."""
    timer = _Timer(device)
    locals_ = [local_lanes(s.arrays, mesh, rank, s.halo, device)
               for s in stages]
    h2d_ms = timer.lap()
    blocks = []
    for s, local in zip(stages, locals_):
        y = run(s.fn, local)
        c0, c1 = column_range(mesh, rank, y.shape[-1])
        blocks.append((y[..., c0:c1], y.shape[-1]))
    step_ms = timer.lap()
    t0 = time.perf_counter()
    outs = tuple(gather(b, mesh, n_cols)[:local.n]
                 for (b, n_cols), local in zip(blocks, locals_))
    _sync(device)
    return outs, {"h2d_ms": h2d_ms, "step_ms": step_ms,
                  "gather_ms": (time.perf_counter() - t0) * 1e3}


def sharded_step(args: Sequence[np.ndarray], n_samples: int, mesh: Mesh,
                 rank: int, device) -> Tuple[Tuple[torch.Tensor, ...], dict]:
    """The combined decode step sharded (:func:`sharded_stages`): ``args``
    are the whole batch's host arrays in the reference step's order (every
    rank holds them all, as ``entry``'s ``example_batch`` gives them).
    Returns the full ``(flac_pcm, mp3_pcm, aac_pcm, vorb_pcm)`` on
    ``device`` and the rank's times."""
    from ..entry import _stages

    k = _stages(False)
    (res, coefs, order, shift, wasted, assign, spectra, bt, mixed, coeffs,
     qbuf, scales, deq, seqs, shapes, prev, sfb, spec) = args
    F = len(assign)
    stages = [
        flac_stage(k, (res.reshape(F, 2, n_samples), coefs.reshape(F, 2, -1),
                       order.reshape(F, 2), shift.reshape(F, 2),
                       wasted.reshape(F, 2), assign), n_samples),
        mp3_stage(k, (spectra, bt, mixed)),
        aac_stage(k, (coeffs, qbuf, scales, deq, seqs, shapes, prev),
                  torch.as_tensor(sfb).to(device)),
        vorbis_stage(k, (spec,)),
    ]
    return sharded_stages(stages, mesh, rank, device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """Milliseconds between laps: CUDA events on the card (the work queued
    on the device's stream), the host clock after the work on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self._mark()

    def _mark(self):
        if self.cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.t = time.perf_counter()

    def lap(self) -> float:
        last, t = (self.event if self.cuda else None), self.t
        self._mark()
        _sync(self.device)
        return (last.elapsed_time(self.event) if self.cuda
                else (self.t - t) * 1e3)


# ---------------------------------------------------------------------------
# Ranks: one process each, started with spawn
# ---------------------------------------------------------------------------


class Rank(NamedTuple):
    """What a rank's body is given besides its arguments (the process
    group is initialized): its rank and its device."""

    rank: int
    device: torch.device


BACKENDS = ("nccl", "gloo")


def _rank_device(device_type: str, backend: str, rank: int) -> torch.device:
    """NCCL: card ``rank`` (one card a rank). gloo on CUDA: card ``rank %
    count``, ranks sharing the cards. CPU: the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, init: str, backend: str,
               device_type: str, work: str, results) -> None:
    with open(work, "rb") as f:
        body, args = pickle.load(f)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = _rank_device(device_type, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        out = body(Rank(rank, dev), *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def _check_launch(n: int, backend: str, device) -> torch.device:
    """The checks :func:`spawn` makes before it starts a process: a known
    backend, NCCL only on CUDA with a card for every rank. Returns the
    device (CUDA raises without a card)."""
    from ..batch import resolve_device

    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if n < 1:
        raise ValueError(f"{n} ranks")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA devices only")
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"backend 'nccl' needs one card a rank: {n} ranks, "
                f"{torch.cuda.device_count()} cards")
    return dev


def spawn(n: int, body: Callable, args: tuple = (), *, backend: str,
          device) -> List:
    """Run ``body(Rank, *args)`` on ``n`` ranks, one process each (start
    method ``spawn``; ``body`` and ``args`` must pickle, ``body`` a
    module-level function), in one process group of ``backend`` whose
    rendezvous is a file in a fresh temporary directory. ``body`` and
    ``args`` reach the ranks through a file there too: a large argument
    through the spawn pipe would make each start wait for the rank before
    it to import. Returns the bodies' results in rank order. A rank that
    raises makes this raise (the others are stopped). On CUDA the kernel
    library is built here first, so that the ranks do not race ``nvcc``."""
    import torch.multiprocessing as mp

    dev = _check_launch(n, backend, device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        work = os.path.join(tmp, "work.pkl")
        with open(work, "wb") as f:
            pickle.dump((body, args), f)
        procs = mp.start_processes(
            _rank_main, args=(n, init, backend, dev.type, work, results),
            nprocs=n, join=False, start_method="spawn")
        try:
            while len(got) < n:
                try:
                    rank, out = results.get(timeout=0.2)
                    got[rank] = out
                except queue_mod.Empty:
                    procs.join(timeout=0)  # raises if a rank failed
            while not procs.join():
                pass
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
    return [got[r] for r in range(n)]
