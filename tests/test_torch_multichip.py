"""The port's multi-card shell (``symphonia_tpu_torch.parallel`` and
``entry.dryrun_multichip``) on the CPU: the mesh against the reference's
``make_mesh`` on 8 virtual devices, the halo depths at a rank boundary on
every lane of a small batch, and the sharded step over 1-8 gloo ranks
against ``__graft_entry__._decode_step`` run unsharded in JAX.

Bars: FLAC bit for bit; MP3, AAC and Vorbis within 1e-5 absolute, as the
reference's own dry run asserts (``__graft_entry__.py:238-246``)."""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from symphonia_tpu.parallel import mesh as ref_mesh
from symphonia_tpu_torch import entry
from symphonia_tpu_torch.parallel import mesh, step

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ref  # noqa: E402

NAMES = ("flac", "mp3", "aac", "vorbis")
BAR = 1e-5


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8), (None, 2),
                                   (None, 1), (None, 4)])
def test_make_mesh_layout_matches_reference(dp, tp):
    want = ref_mesh.make_mesh(jax.devices()[:8], dp=dp, tp=tp)
    got = mesh.make_mesh(8, dp=dp, tp=tp)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert (got.dp, got.tp) == tuple(want.shape.values())
    np.testing.assert_array_equal(got.ranks, ids)
    for r in range(8):
        assert got.coords(r) == tuple(int(i) for i in np.argwhere(ids == r)[0])
    # Lane and column blocks: the slices the reference's specs give each
    # device, at sizes the mesh divides.
    for n in (8 * 16, 1024, 4096):
        lanes = NamedSharding(want, P("dp")).devices_indices_map((n,))
        cols = NamedSharding(want, P(None, "tp")).devices_indices_map((3, n))
        for d in want.devices.flat:
            s = lanes[d][0]
            assert mesh.lane_range(got, d.id, n) == s.indices(n)[:2]
            c = cols[d][1]
            assert mesh.column_range(got, d.id, n) == c.indices(n)[:2]


@pytest.mark.parametrize("n,dp,tp", [(8, 3, 2), (8, None, 3), (8, 4, 4),
                                     (6, 4, 1)])
def test_make_mesh_errors_match_reference(n, dp, tp):
    with pytest.raises(ValueError) as want:
        ref_mesh.make_mesh(jax.devices()[:n], dp=dp, tp=tp)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(n, dp=dp, tp=tp)
    assert str(got.value) == str(want.value)


def test_block_range_covers_uneven_counts():
    for n in range(0, 40):
        for parts in (1, 2, 3, 4, 6, 8):
            blocks = [mesh.block_range(n, parts, i) for i in range(parts)]
            assert blocks[0][0] == 0 and blocks[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
            assert max(hi - lo for lo, hi in blocks) == -(-n // parts)
    with pytest.raises(ValueError):
        mesh.make_mesh(4, dp=2, tp=2).coords(4)


# ---------------------------------------------------------------------------
# The halo depths: a rank boundary at every lane
# ---------------------------------------------------------------------------

SMALL = dict(F=6, N=64, G=6, A=6, V=6, n1=128)


@pytest.fixture(scope="module")
def small():
    host = entry.example_batch(**SMALL, seed=3, aac_rate=48000)
    return host, entry._stages(False)


def _blocks(host, k):
    """(name, halo constant, block(lo, hi)) for each codec stage: lanes
    ``[lo, hi)`` cut with the constant's halo, run, the halo dropped."""
    (res, coefs, order, shift, wasted, assign, spectra, bt, mixed, coeffs,
     qbuf, scales, deq, seqs, shapes, prev, sfb, spec) = host
    F, N = SMALL["F"], SMALL["N"]
    flac = (res.reshape(F, 2, N), coefs.reshape(F, 2, 32),
            order.reshape(F, 2), shift.reshape(F, 2), wasted.reshape(F, 2),
            assign)
    aac = (coeffs, qbuf, scales, deq, seqs, shapes, prev)
    stages = [
        ("flac", "FLAC_HALO", step.flac_stage(k, flac, N)),
        ("mp3", "MP3_HALO", step.mp3_stage(k, (spectra, bt, mixed))),
        ("aac", "AAC_HALO", step.aac_stage(k, aac, torch.as_tensor(sfb))),
        ("vorbis", "VORBIS_HALO", step.vorbis_stage(k, (spec,))),
    ]
    return [(name, const, lambda lo, hi, s=s, const=const: step.run(
        s.fn, step.cut(s.arrays, lo, hi, getattr(step, const), "cpu")))
            for name, const, s in stages]


def _err(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("codec", NAMES)
def test_halo_keeps_every_boundary_equal_to_the_whole(small, codec):
    host, k = small
    name, _, block = next(b for b in _blocks(host, k) if b[0] == codec)
    whole = block(0, 6)
    assert whole.shape[0] == 6
    for b in range(1, 6):
        got = block(b, 6)
        if codec == "flac":
            assert torch.equal(got, whole[b:]), b
        else:
            assert _err(got, whole[b:]) <= BAR, (codec, b)
        # A block that ends early: its lanes do not depend on later ones
        # (the CPU twins' products may sum in another order at another row
        # count: the bar, not bits).
        assert _err(block(0, b), whole[:b]) <= (
            0 if codec == "flac" else BAR), (codec, b)


@pytest.mark.parametrize("codec", ["mp3", "aac", "vorbis"])
def test_halo_is_the_least_depth(small, codec, monkeypatch):
    # One lane less of halo: the first kept lane of a rank that starts at
    # or beyond the halo depth is wrong by far more than the bar.
    host, k = small
    name, const, block = next(b for b in _blocks(host, k) if b[0] == codec)
    halo = getattr(step, const)
    assert halo >= 1
    whole = block(0, 6)
    monkeypatch.setattr(step, const, halo - 1)
    for b in range(halo, 6):
        got = block(b, 6)
        assert _err(got[:1], whole[b:b + 1]) > 1e-3, (codec, b)
    if halo > 1:
        # ... while a rank that starts closer to lane 0 than the halo has
        # lane 0 as its start, as the whole batch has.
        assert _err(block(halo - 1, 6), whole[halo - 1:]) <= BAR


def test_halo_depths():
    assert (step.FLAC_HALO, step.MP3_HALO, step.AAC_HALO,
            step.VORBIS_HALO) == (0, 2, 1, 1)


# ---------------------------------------------------------------------------
# The dry run over gloo ranks on the CPU, against the reference in JAX
# ---------------------------------------------------------------------------


def _jax_step(host, n_samples):
    fn = jax.jit(partial(ref._decode_step, n_samples=n_samples))
    return [np.asarray(o) for o in fn(*(jnp.asarray(a) for a in host))]


def _check_against_reference(res, size, seed):
    want = _jax_step(ref._example_batch(**size, seed=seed, aac_rate=48000),
                     size["N"])
    got = [res["outputs"][n] for n in NAMES]
    np.testing.assert_array_equal(got[0], want[0])
    for name, g, w in zip(NAMES[1:], got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=BAR, rtol=0, err_msg=name)
        assert np.abs(w).max() > 0


# Lane counts that none of dp = 1..4 divides but 1 (and N a multiple of 2).
SIZES = dict(F=13, N=96, G=19, A=23, V=17, n1=256)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_dryrun_multichip_small_matches_jax(n):
    res = entry.dryrun_multichip(n, device="cpu", backend="gloo",
                                 size=SIZES, seed=5)
    sp = 2 if n % 2 == 0 else 1
    assert res["mesh"] == [n // sp, sp] and res["backend"] == "gloo"
    assert res["devices"] == ["cpu"] * n
    times = res["h2d_ms"] + res["step_ms"] + res["gather_ms"]
    assert len(times) == 3 * n and all(t > 0 for t in times)
    assert res["bits_equal"]["flac"] and res["max_abs_err"]["flac"] == 0
    assert all(v <= BAR for v in res["max_abs_err"].values())
    # The CPU runs the twins: no kernel is launched.
    assert sum(res["launches"].values()) == 0
    # Against the plain step (on the CPU the unsharded twins' step).
    assert res["bit_exact_vs_plain"]["flac"]
    assert all(v <= BAR for v in res["max_abs_err_vs_plain"].values())
    _check_against_reference(res, SIZES, 5)


def _rank0(device, **vs_plain):
    """A rank 0 result that meets every bar, with ``vs_plain``'s outputs
    (name: (max_abs_err, bit-exact)) against the plain step."""
    ok = {n: (0.0, True) for n in NAMES}
    ok.update(vs_plain)
    shape = {n: (2, 3) for n in NAMES}
    return {"device": device,
            "outputs": {n: np.zeros(s) for n, s in shape.items()},
            "ref_shapes": shape,
            "max_abs_err": {n: 0.0 for n in NAMES},
            "bits_equal": {n: True for n in NAMES},
            "max_abs_err_vs_plain": {n: e for n, (e, _) in ok.items()},
            "bit_exact_vs_plain": {n: b for n, (_, b) in ok.items()}}


@pytest.mark.parametrize("device,vs_plain,fails", [
    ("cuda:0", {}, False),
    ("cuda:0", dict(mp3=(9e-6, False)), False),
    ("cuda:0", dict(mp3=(2e-5, False)), True),
    ("cuda:0", dict(flac=(1.0, False)), True),
    ("cuda:0", dict(aac=(9e-8, False)), False),
    ("cuda:0", dict(aac=(2e-5, False)), True),
    ("cuda:0", dict(vorbis=(6e-8, False)), True),
    ("cpu", dict(aac=(6e-8, False), vorbis=(6e-8, False)), False),
    ("cpu", dict(aac=(2e-5, False)), True),
    ("cpu", dict(flac=(1.0, False)), True),
])
def test_dryrun_checks_against_the_plain_step(device, vs_plain, fails):
    # On the card the sharded outputs meet these bars against the plain
    # twins' step: FLAC and Vorbis bit for bit, MP3 and AAC within 1e-5
    # (cuBLAS, the plain AAC product, sums in an order that depends on the
    # row count); on the CPU, where that step is the unsharded one, the
    # reference's bars.
    r0 = _rank0(device, **vs_plain)
    if fails:
        with pytest.raises(AssertionError, match="plain step"):
            entry._check_rank0(r0)
    else:
        entry._check_rank0(r0)


def test_dryrun_multichip_8_reference_sizes_matches_jax():
    # dp = 4, tp = 2, 1024 lanes a codec, FLAC frames of 256, n1 = 512,
    # seed 1 and the 48 kHz band map: the reference's dry run.
    res = entry.dryrun_multichip(8, device="cpu", backend="gloo")
    assert res["mesh"] == [4, 2]
    assert res["size"] == dict(F=512, N=256, G=1024, A=1024, V=1024, n1=512)
    assert res["outputs"]["flac"].shape == (512, 2, 256)
    assert res["outputs"]["vorbis"].shape == (1024, 256)
    _check_against_reference(res, res["size"], 1)


@pytest.mark.parametrize("kwargs,err", [
    (dict(backend=None), ValueError),
    (dict(backend="mpi"), ValueError),
    (dict(backend="nccl"), ValueError),   # NCCL wants CUDA tensors
])
def test_dryrun_multichip_backend_is_explicit(kwargs, err):
    with pytest.raises(err, match="backend"):
        entry.dryrun_multichip(2, device="cpu", **kwargs)


def test_rank_failure_raises_in_the_parent():
    # A rank whose body raises stops the run, and the parent raises (rank
    # 1's error, or rank 0's, whose barrier lost its peer) with no rank
    # left running.
    import multiprocessing

    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        step.spawn(2, _failing_body, backend="gloo", device="cpu")
    assert multiprocessing.active_children() == []


def _failing_body(rank):
    if rank.rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()
    return rank.rank


def test_chip_smoke_phase_9_on_the_cpu(monkeypatch, capsys):
    # chip_smoke.py's phase 9 rehearsed on the CPU: the dry run mapped to
    # gloo ranks on the CPU at a small size; its line printed, its rows
    # and launches (none: the twins launch nothing) read.
    import chip_smoke

    real = entry.dryrun_multichip
    monkeypatch.setattr(entry, "dryrun_multichip",
                        lambda n, backend, **kw: real(
                            n, device="cpu", backend="gloo", **kw))
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    split = chip_smoke._plain_aac_row_split
    monkeypatch.setattr(chip_smoke, "_plain_aac_row_split",
                        lambda: split("cpu"))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.phase_multichip(((2, "nccl", SIZES),))
    out = capsys.readouterr().out
    assert out.startswith("phase 9 multichip: ")
    import json

    info = json.loads(out[len("phase 9 multichip: "):])
    (row,) = info["runs"]
    assert row["ranks"] == 2 and row["mesh"] == [1, 2]
    assert row["size"] == SIZES and row["seed"] == chip_smoke.SEED
    assert all(row["bits_equal"].values())
    assert row["bit_exact_vs_plain"]["flac"]
    assert set(row["max_abs_err_vs_plain"]) == set(NAMES)
    # The reference's sizes: 778 of the 1024 AAC lanes are long windows.
    assert info["plain_aac_row_split"]["rows"] == 778
    assert row["shapes"]["flac"] == [13, 2, 96]
    assert set(chip_smoke.MULTICHIP_PATH) == set(chip_smoke.STEP_PATH)
    assert [r[:2] for r in chip_smoke.MULTICHIP_RUNS] == [
        (1, "nccl"), (8, "gloo"), (4, "gloo"), (6, "gloo")]
