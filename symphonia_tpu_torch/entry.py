"""The combined four-codec decode step: the port of the driver entry point.

Counterpart of ``__graft_entry__.py`` (whose name, at the repository root,
belongs to the driver): :func:`decode_step` is its ``_decode_step`` (K14,
``:62``), one dense-stage step over a FLAC, an MP3, an AAC and a Vorbis
lane batch, composed of the port's kernels:

* FLAC: F1 ``flac_lpc`` (recurrence and wasted bits) over ``[2F, N]``
  lanes, then F2 ``flac_decorrelate`` over ``[F, 2, N]``;
* MP3: M1 ``mp3_hybrid`` and M2 ``mp3_synth`` (the factored polyphase
  synthesis: matrixing, then the 16-tap windowed FIR) with zero carried
  state, all ``G`` granules one stream;
* AAC: A1 ``aac_imdct`` with its dequant prologue over the lanes whose
  window sequence is not EIGHT_SHORT, A2 ``aac_dequant`` over the short
  lanes (those that hand off, ``deq == 0``, dequantized), A1 without its
  prologue over their eight windows of 128, each reading and writing its
  lanes through one index sorted on the card, then A3 ``aac_ola`` over the
  whole batch as one sequence;
* Vorbis: V1 ``vorbis_imdct`` at block size ``n1``, then V2 ``vorbis_lap``.

The reference step is one XLA program with no host round trip; so is this
one on the card: no stage waits for the card or copies from the host, and
:func:`capture_step` replays the whole step as one CUDA graph, its four
codec stages as four branches. :func:`decode_step_plain` is the same step
of the plain twins (tests and ``chip_smoke.py`` hold the kernels against
it). :func:`example_batch` is
the reference's ``_example_batch`` (``:126``), equal array by array, and
:func:`entry` gives ``(fn, args)`` as the reference's ``entry()`` does,
with ``args`` as tensors on the card unless the caller asks for the CPU.
:func:`dryrun_multichip` is the reference's (``:181``): the step sharded
over a (dp, tp) mesh of ``torch.distributed`` ranks (:mod:`.parallel`),
one codec stage at a time (:func:`flac_step`, :func:`mp3_step`,
:func:`aac_step`, :func:`vorbis_step`).
"""

from __future__ import annotations

from functools import lru_cache, partial
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from .batch import resolve_device
from .codecs.aac import EIGHT_SHORT, subband_info
from .codecs.vorbis import vorbis_window
from .native import aac_sfb_map
from .ops import aac_dense, flac_dense, mp3_dense, vorbis_dense


def example_batch(F: int = 8, N: int = 256, G: int = 8, A: int = 8,
                  V: int = 8, n1: int = 512, seed: int = 0,
                  aac_rate: int = 44100):
    """The reference's example step inputs, numpy, from ``seed``: FLAC
    ``[2F, N]`` residual lanes with random LPC coefficients (their sums
    wrap int32 all the time), ``G`` stereo MP3 granules, ``A`` AAC lanes
    (about half of the long ones hand off their quants, ``deq == 0``), ``V``
    Vorbis spectra of block size ``n1``, and the per-coefficient band map
    for ``aac_rate``."""
    rng = np.random.default_rng(seed)
    L = 2 * F
    res = rng.integers(-1000, 1000, size=(L, N)).astype(np.int32)
    coefs = np.zeros((L, 32), dtype=np.int32)
    order = np.zeros(L, dtype=np.int32)
    shift = np.zeros(L, dtype=np.int32)
    wasted = np.zeros(L, dtype=np.int32)
    assign = rng.integers(0, 4, size=F).astype(np.int32)
    for l in range(L):
        k = int(rng.integers(0, 13))
        order[l] = k
        if k:
            coefs[l, :k] = rng.integers(-(2**13), 2**13, size=k)
            shift[l] = int(rng.integers(8, 15))
    spectra = (rng.standard_normal((G, 2, 576)) * 0.05).astype(np.float32)
    bt = rng.integers(0, 4, size=(G, 2)).astype(np.int32)
    mixed = (bt == 2) & (rng.random((G, 2)) < 0.5)
    aac_coeffs = (rng.standard_normal((A, 1024)) * 0.05).astype(np.float32)
    aac_seqs = rng.integers(0, 4, size=A).astype(np.int32)
    aac_shapes = rng.integers(0, 2, size=A).astype(np.int32)
    aac_prev = np.concatenate([[0], aac_shapes[:-1]]).astype(np.int32)
    aac_qbuf = rng.integers(-60, 61, size=(A, 1024)).astype(np.int16)
    aac_scales = np.abs(rng.standard_normal((A, 64)) * 0.01).astype(
        np.float32)
    aac_deq = ((aac_seqs == 2) | (rng.random(A) < 0.5)).astype(np.int32)
    vorb_spec = (rng.standard_normal((V, n1 // 2)) * 0.05).astype(np.float32)
    _, bl, _ = subband_info(aac_rate)
    aac_sfb = np.asarray(aac_sfb_map(bl), dtype=np.int32)
    return (res, coefs, order, shift, wasted, assign, spectra, bt, mixed,
            aac_coeffs, aac_qbuf, aac_scales, aac_deq,
            aac_seqs, aac_shapes, aac_prev, aac_sfb, vorb_spec)


class _Constants:
    """The step's constant operators on one device: the MP3 and AAC dense
    stages' buffers, the Vorbis IMDCT matrices and window slopes by block
    size."""

    def __init__(self, device: torch.device):
        self.mp3 = mp3_dense.Mp3Dense.from_numpy(
            mp3_dense.reference_tables(), device)
        self.aac = aac_dense.AacDense.from_numpy(
            aac_dense.reference_tables(), device)
        self.vorbis = vorbis_dense.VorbisDense({}, device)
        self._windows: Dict[int, torch.Tensor] = {}

    def window(self, n: int) -> torch.Tensor:
        if n not in self._windows:
            self._windows[n] = torch.from_numpy(vorbis_window(n)).to(
                self.vorbis.device)
        return self._windows[n]


@lru_cache(maxsize=None)
def _constants(device: torch.device) -> _Constants:
    return _Constants(device)


def _stages(plain: bool) -> SimpleNamespace:
    """The step's stages: the kernel wrappers, or their plain twins."""
    fd, md, ad, vd = flac_dense, mp3_dense, aac_dense, vorbis_dense
    if plain:
        return SimpleNamespace(
            lpc=lambda res, c, o, s, n, w: fd.apply_wasted_bits(
                fd.lpc_reconstruct_plain(res, c, o, s, n), w),
            decorrelate=fd.decorrelate_plain, hybrid=md.mp3_hybrid_plain,
            synth=md.mp3_synth_plain, imdct=ad.aac_imdct_plain,
            dequant=ad.aac_dequant_plain, ola=ad.aac_ola_plain,
            vorbis_imdct=vd.vorbis_imdct_plain, lap=vd.vorbis_lap_plain)
    return SimpleNamespace(
        lpc=lambda res, c, o, s, n, w: fd.lpc_reconstruct_batch(
            res, c, o, s, n, wasted=w),
        decorrelate=fd.decorrelate_batch, hybrid=md.mp3_hybrid,
        synth=md.mp3_synth, imdct=ad.aac_imdct, dequant=ad.aac_dequant,
        ola=ad.aac_ola, vorbis_imdct=vd.vorbis_imdct, lap=vd.vorbis_lap)


def flac_step(k: SimpleNamespace, res, coefs, order, shift, wasted, assign,
              n_samples: int):
    """FLAC: F1 over the ``[2F, N]`` channel lanes, then F2 over
    ``[F, 2, N]``. Frames are independent."""
    x = k.lpc(res, coefs, order, shift, n_samples, wasted)
    F = res.shape[0] // 2
    return k.decorrelate(x.reshape(F, 2, n_samples), assign)


def mp3_step(k: SimpleNamespace, spectra, bt, mixed):
    """MP3: M1 then M2 over the ``G`` granules as one stream, zero carried
    state at granule 0."""
    mp3 = _constants(spectra.device).mp3
    S, _ = k.hybrid(spectra, bt, mixed, None, None, mp3.hybrid, mp3.cs,
                    mp3.ca, mp3.finv)
    pcm, _ = k.synth(S, mp3.matrixing, mp3.window, None, None)
    return pcm


def aac_step(k: SimpleNamespace, coeffs, qbuf, scales, deq, seqs, shapes,
             prev_shapes, sfb):
    """AAC: one IMDCT per window class, each over its own lanes, then the
    window/overlap-add over the batch as one sequence (lane 0 starts it).

    The lanes are split on the device, with no count on the host and no
    copy: ``rows`` is a stable partition of the lanes, long ones first, and
    reversed it starts with the short ones. A1 with its dequant prologue
    reads and writes the long lanes through it (``n_long`` of them), A2
    resolves the short lanes' handoff through it reversed (``n_short``),
    and A1 reads those and writes their windows into the same ``aac_time``.
    Both counts are device scalars, so the stage never waits for the card
    and can be captured in a CUDA graph."""
    aac = _constants(coeffs.device).aac
    A = coeffs.shape[0]
    is_short = seqs == EIGHT_SHORT
    rows = torch.argsort(is_short.to(torch.int8), stable=True).to(torch.int32)
    short_first = rows.flip(0)
    n_short = is_short.sum(dtype=torch.int32)
    n_long = A - n_short
    quant = (qbuf, scales, deq, sfb, aac.pow43)
    aac_time = torch.empty((A, 2048), dtype=torch.float32,
                           device=coeffs.device)
    k.imdct(coeffs, aac.imdct_long, quant, rows=rows, n_rows=n_long,
            out=aac_time)
    x = k.dequant(coeffs, *quant, rows=short_first, n_rows=n_short)
    k.imdct(x, aac.imdct_short, rows=short_first, n_rows=n_short,
            out=aac_time)
    # Lane 0 starts the sequence (made on the card: setting one element from
    # a Python value would copy it from the host and wait).
    first = torch.arange(A, device=coeffs.device) == 0
    return k.ola(aac_time, seqs, shapes, prev_shapes, first, *aac.ola_tables)


def vorbis_step(k: SimpleNamespace, spec):
    """Vorbis: V1 at block size ``n1 = 2 * spec.shape[1]``, then V2's lap
    of consecutive lanes (lane 0 with a zero overlap)."""
    c = _constants(spec.device)
    n1 = 2 * spec.shape[1]
    return k.lap(k.vorbis_imdct(spec, c.vorbis.matrix(n1)), c.window(n1))


def _stage_calls(k: SimpleNamespace, args, n_samples: int):
    """The step's four codec stages on ``args`` (the reference step's
    argument order), each a call of no arguments: they share no data, so
    they may run in any order or at once."""
    return (partial(flac_step, k, *args[0:6], n_samples),
            partial(mp3_step, k, *args[6:9]),
            partial(aac_step, k, *args[9:17]),
            partial(vorbis_step, k, args[17]))


def decode_step(*args, n_samples: int) -> Tuple[torch.Tensor, ...]:
    """One combined decode step on the inputs' device, in the reference
    step's argument order: ``(flac_res, flac_coefs, flac_order,
    flac_shift, flac_wasted, flac_assign, mp3_spectra, mp3_bt, mp3_mixed,
    aac_coeffs, aac_qbuf, aac_scales, aac_deq, aac_seqs, aac_shapes,
    aac_prev_shapes, aac_sfb, vorb_spec)`` -> ``(flac_pcm [F, 2, N],
    mp3_pcm [G, 2, 576], aac_pcm [A, 1024], vorb_pcm [V, n1/2])``. On CUDA
    tensors each stage launches its kernel or raises, and nothing waits for
    the card: once the constants are on it (a first call), the step makes
    no host sync and can be captured (:func:`capture_step`)."""
    return tuple(f() for f in _stage_calls(_stages(False), args, n_samples))


def decode_step_plain(*args, n_samples: int) -> Tuple[torch.Tensor, ...]:
    """:func:`decode_step` composed of the kernels' plain PyTorch twins."""
    return tuple(f() for f in _stage_calls(_stages(True), args, n_samples))


class CapturedStep:
    """:func:`decode_step` on fixed input tensors as one CUDA graph. A call
    replays it and returns the step's four outputs, the same tensors at
    every replay (the graph writes them in place): copy what must outlive
    the next replay. ``launches`` counts the kernel launches that the graph
    holds, i.e. one replay's; :meth:`reset` frees the graph and its memory
    pool (the step's intermediates)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, launches):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def __call__(self) -> Tuple[torch.Tensor, ...]:
        self.graph.replay()
        return self.outputs

    def reset(self) -> None:
        self.outputs = None
        self.graph.reset()


def capture_step(*args, n_samples: int) -> CapturedStep:
    """:func:`decode_step` on ``args`` (tensors on one card) captured as one
    CUDA graph, its four codec stages as four branches: side streams forked
    from the capturing stream and joined before the capture ends, so that
    the card may run one stage's small kernels beside another's large ones.

    One eager step first builds what the step keeps on the card (the
    constants, the Vorbis matrix and window, the kernel library and its
    attributes); inside the capture nothing is copied from the host and
    nothing waits. A failed capture raises: the step never falls back to
    running eagerly."""
    from .ops import _build

    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"capture_step needs tensors on a CUDA card, got "
                         f"{dev}")
    decode_step(*args, n_samples=n_samples)
    streams = [torch.cuda.Stream(dev) for _ in range(4)]
    torch.cuda.synchronize(dev)
    before = dict(_build.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        root = torch.cuda.current_stream(dev)
        outputs = []
        for call, side in zip(_stage_calls(_stages(False), args, n_samples),
                              streams):
            side.wait_stream(root)
            with torch.cuda.stream(side):
                outputs.append(call())
        for side in streams:
            root.wait_stream(side)
    launches = {name: _build.LAUNCHES[name] - before[name]
                for name in _build.KERNELS}
    return CapturedStep(graph, tuple(outputs), launches)


def entry(device="cuda"):
    """``(fn, args)``: the step at ``n_samples = 256`` and the reference
    entry's example batch (8 lanes a codec) as tensors on ``device``, the
    card unless the caller asks for ``"cpu"``; raises without CUDA."""
    dev = resolve_device(device)
    N = 256
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in example_batch(F=8, N=N, G=8, A=8, V=8))
    return partial(decode_step, n_samples=N), args


_NAMES = ("flac", "mp3", "aac", "vorbis")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _compare(got, want) -> Tuple[dict, dict]:
    """Each output's largest absolute difference and bit-equality."""
    return ({n: float((g.double() - w.double()).abs().max())
             for n, g, w in zip(_NAMES, got, want)},
            {n: g.shape == w.shape and _bits_equal(g, w)
             for n, g, w in zip(_NAMES, got, want)})


def _dryrun_rank(rank, mesh, size: dict, seed: int) -> dict:
    """One rank of :func:`dryrun_multichip`: the example batch made from
    ``seed``, the sharded step once to warm up (the constants and the
    allocator's blocks on the device, every kernel loaded, NCCL's
    communicator made), then again, timed, with the launches it made;
    rank 0 also runs the unsharded step and the plain twins' step on its
    device and compares the gathered outputs with both."""
    from .ops import _build
    from .parallel.step import sharded_step

    host = example_batch(**size, seed=seed, aac_rate=48000)
    N = size["N"]
    sharded_step(host, N, mesh, rank.rank, rank.device)
    _build.reset_launches()
    outs, times = sharded_step(host, N, mesh, rank.rank, rank.device)
    res = {"rank": rank.rank, "device": str(rank.device),
           "launches": dict(_build.LAUNCHES), **times}
    if rank.rank == 0:
        args = tuple(torch.from_numpy(a).to(rank.device) for a in host)
        ref = decode_step(*args, n_samples=N)
        res["max_abs_err"], res["bits_equal"] = _compare(outs, ref)
        res["ref_shapes"] = {n: tuple(w.shape) for n, w in zip(_NAMES, ref)}
        del ref
        plain = decode_step_plain(*args, n_samples=N)
        res["max_abs_err_vs_plain"], res["bit_exact_vs_plain"] = _compare(
            outs, plain)
        res["outputs"] = {n: g.cpu().numpy() for n, g in zip(_NAMES, outs)}
    return res


def _check_rank0(r0: dict) -> None:
    """Raise unless rank 0's gathered outputs have the unsharded step's
    shapes and meet the bars of :func:`dryrun_multichip` against the
    unsharded step and the plain twins' step."""
    for name in _NAMES:
        got = r0["outputs"][name].shape
        if got != r0["ref_shapes"][name]:
            raise AssertionError(f"{name}: sharded {got} vs single-device "
                                 f"{r0['ref_shapes'][name]}")
    if not r0["bits_equal"]["flac"]:
        raise AssertionError("flac sharded vs single-device mismatch")
    for name in _NAMES[1:]:
        if not r0["max_abs_err"][name] <= 1e-5:
            raise AssertionError(f"{name} sharded vs single-device mismatch:"
                                 f" {r0['max_abs_err'][name]:.3g} > 1e-5")
    # Against the plain twins' step: FLAC bit for bit, and on the card
    # Vorbis too; MP3 and AAC within 1e-5, bit-equality reported. The plain
    # AAC step's long-window product is cuBLAS's, whose sum order changes
    # with the row count: at the reference's sizes (778 long rows) it is not
    # the same product over all the rows as over two halves of them, so A1
    # (one order at every row count) cannot equal it bit for bit there. On
    # the CPU the plain step is the unsharded step (the twins), whose
    # products sum in an order that depends on the row count: the
    # reference's bars there, as above.
    on_card = torch.device(r0["device"]).type == "cuda"
    exact = ("flac", "vorbis") if on_card else ("flac",)
    for name in _NAMES:
        err = r0["max_abs_err_vs_plain"][name]
        if not (r0["bit_exact_vs_plain"][name] if name in exact
                else err <= 1e-5):
            raise AssertionError(
                f"{name} sharded vs the plain step: max |err| {err:.3g}, "
                + ("not bit for bit" if name in exact else "> 1e-5"))


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     size=None, seed: int = 1) -> dict:
    """The combined decode step over ``n_devices`` ranks, the counterpart of
    the reference's ``dryrun_multichip`` (``__graft_entry__.py:181``): the
    same (dp, tp) mesh (tp = 2 when ``n_devices`` is even), the same
    batch (``lanes = max(1024, 128 * dp)`` a codec, FLAC frames of ``128 *
    tp`` samples, Vorbis blocks of 512, the 48 kHz band map, ``seed``), or
    ``size`` (``example_batch``'s F, N, G, A, V, n1) at the same rate and
    seed. Each rank is a process (``parallel.step.spawn``) in a
    ``backend`` process group: ``"nccl"`` with rank r on card r, ``"gloo"``
    with the ranks sharing the cards (or on the CPU with ``device="cpu"``).
    Lane counts that dp does not divide are padded and cut after the
    gather. Asserts what the reference asserts against the step run
    unsharded on the same device: FLAC equal, MP3, AAC and Vorbis within
    1e-5; and against the plain twins' step on the same device: on the
    card FLAC and Vorbis bit for bit, MP3 and AAC within 1e-5 (on the
    CPU, where the plain step is the unsharded one, the same bars as
    above).
    Returns the mesh, sizes, each rank's times (its lanes to the device,
    its stages, the gathers; ``parallel.step.sharded_step``), the errors
    and bit-equality against both steps, the launches summed over ranks
    and rank 0's gathered outputs (numpy)."""
    from .parallel.mesh import make_mesh
    from .parallel.step import spawn

    sp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // sp
    mesh = make_mesh(n_devices, dp=dp, tp=sp)
    if size is None:
        lanes = max(1024, 128 * dp)
        size = dict(F=lanes // 2, N=128 * sp, G=lanes, A=lanes, V=lanes,
                    n1=512)
    ranks = spawn(n_devices, _dryrun_rank, (mesh, dict(size), seed),
                  backend=backend, device=device)
    r0 = ranks[0]
    _check_rank0(r0)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return {"mesh": [mesh.dp, mesh.tp], "backend": backend,
            "devices": [r["device"] for r in ranks], "size": dict(size),
            "seed": seed, "h2d_ms": [r["h2d_ms"] for r in ranks],
            "step_ms": [r["step_ms"] for r in ranks],
            "gather_ms": [r["gather_ms"] for r in ranks],
            "max_abs_err": r0["max_abs_err"], "bits_equal": r0["bits_equal"],
            "max_abs_err_vs_plain": r0["max_abs_err_vs_plain"],
            "bit_exact_vs_plain": r0["bit_exact_vs_plain"],
            "launches": launches, "outputs": r0["outputs"]}
