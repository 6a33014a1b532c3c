"""A1 ``aac_imdct`` and A2 ``aac_dequant`` through a row map, and the entry
step's AAC stage that splits long from short lanes with it on the device.

On the CPU the wrappers run their plain twins: with ``rows``/``n_rows``
those gather the lanes ``rows[:n_rows]``, run the dense twin, and scatter
into ``out``. Here the twins are held (1) to that definition written out,
bit for bit, with every other row of ``out`` untouched; (2) to a numpy
model of what the kernel does with the index: a 128-row tile's copy slots
``tid / 8 + 32 s`` and its epilogue rows, each through the block's map
(``rows[g]`` at n = 1024, window ``8 * rows[g >> 3] + (g & 7)`` at n =
128), blocks past the count doing nothing, the product in float64, within
the reference's AAC bar (1e-5 of the larger of 1 and the peak); and (3)
``entry.aac_step`` on CPU tensors against the reference's
``__graft_entry__._decode_step`` under JAX at splits of the batch that
``tests/test_torch_entry.py`` lacks (no short lane, only short lanes,
short lanes that hand off), within 1e-5 (the reference's AAC bar)."""

import ast
import inspect
import os
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symphonia_tpu_torch import entry
from symphonia_tpu_torch.codecs.aac import subband_info
from symphonia_tpu_torch.ops import aac_dense as ad

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ref  # noqa: E402

A = 300  # lanes: three long blocks of 128 rows, 19 short ones


@pytest.fixture(scope="module")
def dense():
    return ad.AacDense.from_numpy(ad.reference_tables(), "cpu")


def _lanes_inputs(seed: int):
    """Coefficients and handoff operands for A lanes, half of them handing
    off (``deq == 0``); the others carry stale quants and scales whose
    product overflows, as the entropy stage leaves them."""
    rng = np.random.default_rng(seed)
    coeffs = (rng.standard_normal((A, 1024)) * 0.1).astype(np.float32)
    qbuf = np.clip(np.rint(rng.laplace(0.0, 4.0, (A, 1024))), -60, 60)
    qbuf = qbuf.astype(np.int16)
    scales = np.exp2((rng.integers(60, 100, (A, 64)) - 100) / 4.0)
    scales = scales.astype(np.float32)
    scales[:, 49:] = 0.0
    deq = (rng.random(A) >= 0.5).astype(np.int32)
    qbuf[deq != 0] = 8191
    scales[deq != 0] = 3e38
    return coeffs, qbuf, scales, deq


def _split(name: str, seed: int):
    """(rows int32 [A], n_rows) of one split of the A lanes."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(A).astype(np.int32)
    ident = np.arange(A, dtype=np.int32)
    return {
        "all": (ident, A),
        "none": (perm, 0),
        "alternating": (np.concatenate([ident[::2], ident[1::2]]), A // 2),
        "one_lane": (perm, 1),
        "perm_all": (perm, A),
        "perm_part": (perm, int(rng.integers(2, A - 1))),
    }[name]


SPLITS = ("all", "none", "alternating", "one_lane", "perm_all", "perm_part")
MODES = ("long_prologue", "long", "short")


def _case(dense, mode: str, split: str):
    """(x, m, quant or None, rows, n_rows) of one mode and split, tensors."""
    seed = SPLITS.index(split) * 3 + MODES.index(mode)
    coeffs, qbuf, scales, deq = _lanes_inputs(seed)
    _, bands_long, _ = subband_info(44100)
    quant = (dense.quant(torch.from_numpy(qbuf), torch.from_numpy(scales),
                         torch.from_numpy(deq), bands_long)
             if mode == "long_prologue" else None)
    m = dense.imdct_short if mode == "short" else dense.imdct_long
    rows, n = _split(split, seed)
    return (torch.from_numpy(coeffs), m, quant, torch.from_numpy(rows),
            torch.tensor(n, dtype=torch.int32))


def _sentinel_out():
    out = torch.empty((A, 2048), dtype=torch.float32)
    out.view(torch.int32).fill_(0x7FC01234)  # a NaN no product gives
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("mode", MODES)
def test_a1_row_map_is_gather_product_scatter(dense, mode, split):
    x, m, quant, rows, n_rows = _case(dense, mode, split)
    out = _sentinel_out()
    before = out.clone()
    got = ad.aac_imdct(x, m, quant, rows=rows, n_rows=n_rows, out=out)
    assert got is out
    lanes = rows[:int(n_rows)].long()
    n = m.shape[1]
    q = None if quant is None else (quant[0][lanes], quant[1][lanes],
                                    quant[2][lanes], quant[3], quant[4])
    y = ad.aac_imdct_plain(x[lanes].reshape(-1, n), m, q)
    want = before.clone()
    want[lanes] = y.reshape(len(lanes), 2048)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    untouched = np.ones(A, bool)
    untouched[lanes.numpy()] = False
    np.testing.assert_array_equal(_bits(out[untouched]),
                                  _bits(before[untouched]))


def _dequant_np(coeffs, qbuf, scales, deq, sfb, pow43):
    """The dequantization in numpy float32, a select per row."""
    q = qbuf.astype(np.int32)
    with np.errstate(over="ignore"):  # the stale rows; the select drops them
        v = pow43[np.minimum(np.abs(q), 8191)] * scales[:, sfb]
    v = np.where(q < 0, -v, v).astype(np.float32) + np.float32(0.0)
    return np.where((deq == 0)[:, None], v, coeffs)


def _kernel_model(x, m, quant, rows, n_rows, out):
    """What A1 does with a row map, in numpy: the grid covers R lanes of
    ``group = 1024 / n`` tile rows; a block of 128 tile rows at row0 past
    the end (``group * n_rows``) does nothing; otherwise its map (simt_gemm.
    cuh's fill_row_map) names each tile row's operand row, the 256 threads'
    copy slots (tile row tid / 8 + 32 s, k-quad tid % 8) load those rows
    (zeros past the end), the prologue dequantizes the rows with deq == 0,
    the half product Z = A . M[n/2 : 3n/2]^T is taken in float64, and the
    epilogue's threads (tile rows 4 ty + c and 64 + 4 ty + c) write each
    mapped row mirrored."""
    x = x.numpy()
    m = m.numpy().astype(np.float64)
    rows = rows.numpy()
    n = m.shape[1]
    group = 1024 // n
    h = n // 2
    xv = x.reshape(-1, n)
    outv = out.numpy().reshape(-1, 2 * n)
    if quant is not None:
        xv = _dequant_np(x, *(t.numpy() for t in quant))
    end = group * int(n_rows)
    for row0 in range(0, len(rows) * group, 128):
        if row0 >= end:
            continue
        g = row0 + np.arange(128)
        cmap = np.where(g < end, group * rows[np.minimum(g, end - 1) // group]
                        + g % group, -1)
        tile = np.zeros((128, n), np.float64)
        loaded = np.zeros((128, 8), int)
        for tid in range(256):
            for s in range(4):
                t = tid // 8 + 32 * s
                loaded[t, tid % 8] += 1
                if cmap[t] >= 0:
                    tile[t] = xv[cmap[t]]
        assert (loaded == 1).all()  # every (row, k-quad) once a slab
        z = tile @ m[h:h + n].T
        stored = np.zeros(128, int)
        for ty in range(16):
            for i in range(8):
                t = 4 * ty + (i & 3) + 64 * (i >> 2)
                stored[t] += 1
                if cmap[t] < 0:
                    continue
                y = np.empty(2 * n)
                y[h:h + n] = z[t]
                y[h - 1 - np.arange(h)] = -z[t, :h]
                y[2 * n + h - 1 - np.arange(h, n)] = z[t, h:]
                outv[cmap[t]] = y
        assert (stored == 1).all()  # each row by one ty (its 16 tx)
    return out


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("mode", MODES)
def test_a1_twin_matches_a_model_of_the_kernels_row_map(dense, mode, split):
    x, m, quant, rows, n_rows = _case(dense, mode, split)
    twin = ad.aac_imdct(x, m, quant, rows=rows, n_rows=n_rows,
                        out=_sentinel_out())
    model = _kernel_model(x, m, quant, rows, n_rows, _sentinel_out())
    mapped = np.zeros(A, bool)
    mapped[rows[:int(n_rows)].numpy()] = True
    # Rows outside the map: untouched by both, bit for bit.
    np.testing.assert_array_equal(_bits(model[~mapped]), _bits(twin[~mapped]))
    if mapped.any():
        peak = float(twin[mapped].abs().max())
        np.testing.assert_allclose(model[mapped].numpy(),
                                   twin[mapped].numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, peak))


@pytest.mark.parametrize("split", SPLITS)
def test_a2_row_map_is_gather_dequant_scatter(dense, split):
    x, _, quant, rows, n_rows = _case(dense, "long_prologue", split)
    got = ad.aac_dequant(x, *quant, rows=rows, n_rows=n_rows)
    assert got.shape == (A, 1024) and got.dtype == torch.float32
    lanes = rows[:int(n_rows)].long()
    want = ad.aac_dequant_plain(x[lanes], quant[0][lanes], quant[1][lanes],
                                quant[2][lanes], *quant[3:])
    np.testing.assert_array_equal(_bits(got[lanes]), _bits(want))
    # ... and the numpy dequantization, row by row.
    want_np = _dequant_np(*(t.numpy() for t in (x, *quant)))
    np.testing.assert_array_equal(got[lanes].numpy().view(np.int32),
                                  want_np[lanes.numpy()].view(np.int32))


def test_row_map_arguments_go_together(dense):
    x, m, _, rows, n_rows = _case(dense, "long", "all")
    with pytest.raises(ValueError, match="together"):
        ad.aac_imdct(x, m, rows=rows, n_rows=n_rows)
    with pytest.raises(ValueError, match="together"):
        ad.aac_imdct(x, m, n_rows=n_rows, out=_sentinel_out())
    with pytest.raises(ValueError, match="together"):
        ad.aac_dequant(x, *dense.quant(torch.zeros((A, 1024), dtype=torch.int16),
                                       torch.zeros((A, 64)),
                                       torch.ones(A, dtype=torch.int32),
                                       subband_info(44100)[1]),
                       rows=rows)


# --- the entry step's AAC stage against the reference's step -------------

SIZE = dict(F=2, N=64, G=2, A=40, V=2, n1=256)


def _step_args(split: str, seed: int):
    """The example batch with its AAC window sequences set to one split:
    none short, all short, or short lanes of which some hand off."""
    args = list(entry.example_batch(**SIZE, seed=seed))
    rng = np.random.default_rng(seed)
    seqs, deq = args[13].copy(), args[12].copy()
    if split == "no_short":
        seqs[seqs == 2] = 0
    elif split == "only_short":
        seqs[:] = 2
    elif split == "short_handoff":
        seqs[rng.random(len(seqs)) < 0.4] = 2
        deq[(seqs == 2) & (rng.random(len(seqs)) < 0.5)] = 0
        assert ((seqs == 2) & (deq == 0)).any()
    elif split == "only_short_handoff":
        seqs[:] = 2
        deq[:] = 0
    args[13], args[12] = seqs, deq
    return args


STEP_SPLITS = ("no_short", "only_short", "short_handoff",
               "only_short_handoff")


@pytest.fixture(scope="module")
def ref_step():
    return jax.jit(partial(ref._decode_step, n_samples=SIZE["N"]))


@pytest.mark.parametrize("split", STEP_SPLITS)
def test_aac_step_matches_reference_at_split(ref_step, split):
    args = _step_args(split, 11 + STEP_SPLITS.index(split))
    want = [np.asarray(o) for o in ref_step(*(jnp.asarray(a) for a in args))]
    got = entry.decode_step(*(torch.from_numpy(a) for a in args),
                            n_samples=SIZE["N"])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    aac = got[2].numpy()
    assert aac.shape == want[2].shape and np.isfinite(aac).all()
    np.testing.assert_allclose(aac, want[2], atol=1e-5, rtol=0)
    # The plain twins' step gives the same AAC output bit for bit.
    plain = entry.decode_step_plain(*(torch.from_numpy(a) for a in args),
                                    n_samples=SIZE["N"])
    np.testing.assert_array_equal(_bits(plain[2]), _bits(got[2]))


@pytest.mark.parametrize("split", STEP_SPLITS)
def test_aac_step_passes_each_class_its_lanes(split, monkeypatch):
    # A1 long over the long lanes with the prologue, A2 and A1 short over
    # the short lanes, each given the whole batch and the index.
    args = _step_args(split, 11 + STEP_SPLITS.index(split))
    seqs = args[13]
    calls = []
    for name in ("aac_imdct", "aac_dequant"):
        real = getattr(ad, name)

        def spy(*a, _name=name, _real=real, **kw):
            lanes = sorted(kw["rows"][:int(kw["n_rows"])].tolist())
            short = _name == "aac_dequant" or a[1].shape[1] == 128
            calls.append((_name, short, a[0].shape[0], lanes))
            return _real(*a, **kw)

        monkeypatch.setattr(ad, name, spy)
    entry.decode_step(*(torch.from_numpy(a) for a in args),
                      n_samples=SIZE["N"])
    short = sorted(np.flatnonzero(seqs == 2).tolist())
    long = sorted(np.flatnonzero(seqs != 2).tolist())
    A_ = len(seqs)
    assert calls == [("aac_imdct", False, A_, long),
                     ("aac_dequant", True, A_, short),
                     ("aac_imdct", True, A_, short)]


def _calls(fn) -> set:
    """The names of the functions and methods that ``fn``'s body calls."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return {c.func.attr if isinstance(c.func, ast.Attribute) else c.func.id
            for c in ast.walk(tree) if isinstance(c, ast.Call)
            and isinstance(c.func, (ast.Attribute, ast.Name))}


@pytest.mark.parametrize("fn,banned", [
    (entry.aac_step, {"nonzero", "item", "any", "bool", "int", "numel",
                      "tolist", "cpu", "index_select", "index_copy_"}),
    (ad.AacDense._decode_span, {"nonzero", "flatnonzero", "item",
                                "index_select", "index_copy_"}),
], ids=["aac_step", "decode_span"])
def test_split_has_no_host_wait_and_no_gather(fn, banned):
    # aac_step: nothing that waits for the card or copies rows; the
    # decode path's split keeps its counts on the host (it has them) but
    # gathers and scatters nothing.
    assert not _calls(fn) & banned, _calls(fn) & banned


def test_capture_step_needs_a_card():
    fn, args = entry.entry(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        entry.capture_step(*args, n_samples=256)


def test_time_trees_needs_a_card(monkeypatch, capsys):
    # The tool that times the step, A1 and V1 in whole checkouts (parent
    # and change in turns on one card) prints its usage without a tree and
    # raises without a card rather than timing the CPU.
    from symphonia_tpu_torch.tools import time_trees

    assert time_trees.main([]) == 2
    assert "ROOT" in capsys.readouterr().out
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(RuntimeError, match="CUDA"):
        time_trees.measure(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
