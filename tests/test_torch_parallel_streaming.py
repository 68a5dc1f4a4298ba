"""Sharded out-of-core NMF of the PyTorch port (``decomp_tpu_torch.parallel
.nmf.solve_streaming`` and ``masked_completion_streaming(mesh=)``) on gloo
worlds of CPU ranks, against the port's one-process loader mode and
``decomp_tpu.parallel.nmf.solve_streaming`` on a JAX mesh of the same shape.

The same seeded numpy inputs and explicit ``d0`` / ``x0`` go to all three.
The ranks' loaders slice the global numpy arrays at global offsets; JAX's
are ``dynamic_slice`` windows of a device array. Each rank returns its rows
of x (empty on a rank wholly past the data) and the parent reassembles them.
The held-out cases pass ``decomp_tpu``'s per-chunk draws, computed here, to
the private ``_chunk_reserve`` hook. Tolerances: f64, 1e-12 relative
against the one-process port (the statistics sum the ranks' chunks in
another order) and 1e-10 against JAX (measured <= 7.6e-16 against either,
at the shapes of test_matches_single_and_jax), with equal niter
and converged and d the same bits on every rank; the kernels' twins form
their statistics in f32 and agree with the composition to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from decomp_tpu.models.nmf import _HELDOUT_SALT
from decomp_tpu_torch.models import nmf_streaming as tns
from decomp_tpu_torch.utils import exceptions as texc
from decomp_tpu_torch.utils.exceptions import DecompError
from problems import planted_nmf, random_mask, rel_err
from torch_parallel_ranks import assemble, worlds  # noqa: F401

MESHES = {
    "row2": (((2,), ("rows",)), "rows"),
    "row4": (((4,), ("rows",)), "rows"),
    "slice2x2": (((2, 2), ("slice", "rows")), ("slice", "rows")),
}
F64 = dict(dtype=torch.float64)


def _problem(seed, m=200, n=24, k=4, masked=False, noise=0.01):
    """A planted f64 problem, pre-masked where masked, and its start. At
    m = 200 in 32-row chunks a world of 4 has 2 chunks a rank: rank 3
    holds rows 192..199, one ragged chunk and one wholly past the data."""
    y, *_ = planted_nmf(seed=seed, n_samples=m, n_channels=n, rank=k,
                        noise=noise)
    rng = np.random.default_rng(seed + 1)
    x0, d0 = rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n))
    mask = random_mask(seed + 2, y.shape) if masked else None
    return dict(y=y if mask is None else y * mask, mask=mask, x=x0, d=d0)


def _run(worlds, name, arrays, draws=None, **kw):
    spec, row_axis = MESHES[name]
    return worlds(int(np.prod(spec[0]))).run(
        ranks.nmf_streaming, spec, row_axis, arrays, {**F64, **kw}, draws)


def _single(arrays, **kw):
    """The port's one-process loader mode on the same loaders."""
    y, mask = arrays["y"], arrays["mask"]
    kw = {**F64, **kw}
    return dt.nmf.solve_streaming(
        lambda lo, hi: y[lo:hi], arrays["d"], x=arrays["x"],
        mask=None if mask is None else (lambda lo, hi: mask[lo:hi]),
        n_samples=y.shape[0], n_channels=y.shape[1], x_device=True,
        jit_loader=True, device="cpu", **kw)


def _jax_loaders(arrays, chunk):
    def loader(a):
        if a is None:
            return None
        aj = jnp.asarray(a)
        return lambda lo, hi: jax.lax.dynamic_slice(aj, (lo, 0),
                                                    (chunk, a.shape[1]))

    return loader(arrays["y"]), loader(arrays["mask"])


def _jax_mesh(name):
    from decomp_tpu import parallel as jpar

    (shape, names), row_axis = MESHES[name]
    mesh = jpar.make_mesh(shape, names,
                          devices=jax.devices()[:int(np.prod(shape))])
    return mesh, row_axis


def _jax(arrays, name, **kw):
    """decomp_tpu's sharded streamer on a JAX mesh of the same shape."""
    from decomp_tpu import parallel as jpar

    mesh, row_axis = _jax_mesh(name)
    yj, mj = _jax_loaders(arrays, kw["chunk_rows"])
    y = arrays["y"]
    return jpar.nmf.solve_streaming(
        yj, arrays["d"], x=arrays["x"], mask=mj, mesh=mesh,
        row_axis=row_axis, n_samples=y.shape[0], n_channels=y.shape[1],
        dtype=kw.pop("dtype", np.float64), use_pallas=False, **kw)


def _jax_draws(seed, frac, m, n, chunk, n_dev):
    """decomp_tpu's held-out draw of every chunk of the sharded grid, by
    global offset (nmf_streaming.py:857-867)."""
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                             _HELDOUT_SALT)
    n_pad = n_dev * -(-m // (n_dev * chunk)) * chunk
    return {lo: np.asarray(jax.random.uniform(
        jax.random.fold_in(key, np.uint32(lo)), (chunk, n)) < frac,
        dtype=np.float64) for lo in range(0, n_pad, chunk)}


def _check(outs, ref, tol, m=None):
    """The reassembled x, d, niter and converged against ``ref``; d the
    same bits on every rank."""
    x = assemble(outs, "x")
    if m is not None:
        assert x.shape[0] == m
    assert rel_err(x, np.asarray(ref.x)) < tol
    assert rel_err(outs[0]["d"], np.asarray(ref.d)) < tol
    assert {o["niter"] for o in outs} == {int(ref.niter)}
    assert {bool(o["converged"]) for o in outs} == {bool(ref.converged)}
    assert all(o["d_same"] for o in outs)


@pytest.mark.parametrize("name,method,masked", [
    ("row4", "mu", False), ("row4", "mu", True), ("row4", "kl-mu", False),
    ("row4", "kl-mu", True), ("row2", "kl-mu", True),
    ("slice2x2", "mu", True)])
def test_matches_single_and_jax(worlds, name, method, masked):
    """Ragged grids: a world of 4 has a ragged chunk and a chunk past the
    data on rank 3; a world of 2 the same on rank 1; ('slice', 'rows')
    reduces over each dim's group in turn."""
    arrays = _problem(3, masked=masked)
    kw = dict(tol=0.0, maxiter=12, method=method, chunk_rows=32)
    outs = _run(worlds, name, arrays, **kw)
    _check(outs, _single(arrays, **kw), 1e-12, m=200)
    _check(outs, _jax(arrays, name, **kw), 1e-10)
    assert [o["x"].shape[0] for o in outs] == (
        [64, 64, 64, 8] if name != "row2" else [128, 72])


@pytest.mark.parametrize("masked", [False, True])
def test_padding_only_rank(worlds, masked):
    """n = 257 over 4 ranks of 64-row chunks (decomp_tpu's
    test_sharded_streaming_padding_beyond_one_chunk): rank 2 holds one row,
    rank 3 none; every loader window stays inside the data, and the result
    is the in-core solve's."""
    arrays = _problem(5, m=257, n=20, masked=masked)
    kw = dict(tol=0.0, maxiter=10, chunk_rows=64)
    outs = _run(worlds, "row4", arrays, **kw)
    assert [o["x"].shape[0] for o in outs] == [128, 128, 1, 0]
    assert all(0 <= lo <= 257 - 64 for o in outs for lo in o["calls"])
    _check(outs, _single(arrays, **kw), 1e-12, m=257)
    core = decomp_tpu.nmf.solve(arrays["y"], arrays["d"], x=arrays["x"],
                                mask=arrays["mask"], tol=0.0, maxiter=10,
                                use_pallas=False)
    _check(outs, core, 1e-10)


@pytest.mark.parametrize("variant", ["mixed", "inner_iter"])
def test_mixed_and_inner_iter_match_single_and_jax(worlds, variant):
    """bf16 chunks with f32 factors (the loaders return bf16-exact f32,
    cast on load; every product on bf16 operands summed in f32, so the
    ranks' partial sums agree with one sum to 1e-5, and with JAX to 1e-4),
    and inner_iter 3 in f64."""
    arrays = _problem(7)
    if variant == "mixed":
        arrays["y"] = np.asarray(jnp.asarray(arrays["y"], jnp.bfloat16),
                                 np.float32)
        kw = dict(dtype=torch.bfloat16, factor_dtype=torch.float32,
                  precision="default")
        jkw = dict(dtype=jnp.bfloat16, factor_dtype=jnp.float32,
                   precision="default")
        lim = (1e-5, 1e-4)
    else:
        kw, jkw, lim = dict(inner_iter=3), dict(inner_iter=3), (1e-12, 1e-10)
    base = dict(tol=0.0, maxiter=10, chunk_rows=32)
    outs = _run(worlds, "row2", arrays, **base, **kw)
    _check(outs, _single(arrays, **base, **kw), lim[0])
    if variant == "mixed":
        assert outs[0]["d"].dtype == np.float32
    ja = dict(arrays)
    if variant == "mixed":
        ja["y"] = jnp.asarray(arrays["y"], jnp.bfloat16)
    _check(outs, _jax(ja, "row2", **base, **jkw), lim[1])


def test_check_every_and_record_objective(worlds):
    """A rel-change stop amortised over check epochs lands on the one-
    process and JAX epochs; the objective curve is the global one."""
    arrays = _problem(9)
    kw = dict(tol=1e-3, maxiter=600, check_every=6, chunk_rows=32)
    outs = _run(worlds, "row4", arrays, **kw)
    ref = _single(arrays, **kw)
    assert ref.converged and ref.niter % 6 == 0
    _check(outs, ref, 1e-12)
    _check(outs, _jax(arrays, "row4", **kw), 1e-10)
    kw = dict(tol=0.0, maxiter=8, record_objective=True, chunk_rows=32)
    outs = _run(worlds, "row4", arrays, **kw)
    ref, jref = _single(arrays, **kw), _jax(arrays, "row4", **kw)
    for o in outs:
        assert rel_err(o["objective"], ref.objective.numpy()) < 1e-12
        assert rel_err(o["objective"], np.asarray(jref.objective)) < 1e-10


@pytest.mark.parametrize("masked", [False, True])
def test_hbm_cache_matches_uncached(worlds, masked):
    """Each rank caches the head of its own rows: the same bits as
    uncached, and the loader called for the uncached chunks alone (the
    cache once, before the first epoch)."""
    arrays = _problem(11, m=256, masked=masked)
    kw = dict(tol=0.0, maxiter=5, chunk_rows=32)
    ref = _run(worlds, "row2", arrays, **kw)
    outs = _run(worlds, "row2", arrays, hbm_cache_chunks=3, **kw)
    for o, r in zip(outs, ref):
        assert np.array_equal(o["x"], r["x"])
        assert np.array_equal(o["d"], r["d"])
        row0 = 128 * o["row"]
        cached = [row0 + 32 * i for i in range(3)]
        assert o["calls"] == cached + [row0 + 96] * 5


@pytest.mark.parametrize("method,masked", [("mu", False), ("kl-mu", True)])
def test_kernel_twins(worlds, method, masked):
    """use_kernel=True runs each chunk through its ops.cuda_mu wrapper (the
    twin on CPU ranks); record_objective under it is refused on every
    rank, as nmf_streaming._chunk_kernel_gate refuses it in one process."""
    arrays = {k: None if v is None else v.astype(np.float32)
              for k, v in _problem(13, masked=masked).items()}
    kw = dict(tol=0.0, maxiter=8, method=method, chunk_rows=32,
              dtype=torch.float32)
    comp = _run(worlds, "row4", arrays, **kw)
    outs = _run(worlds, "row4", arrays, use_kernel=True, **kw)
    _check(outs, _single(arrays, use_kernel=True, **kw), 1e-6)
    assert rel_err(assemble(outs, "x"), assemble(comp, "x")) < 1e-6
    assert rel_err(outs[0]["d"], comp[0]["d"]) < 1e-6
    refused = worlds(4).run(
        ranks.refusal, MESHES["row4"][0], "nmf_streaming",
        dict(y=arrays["y"], d=arrays["d"], n_samples=200, n_channels=24,
             dtype=torch.float32, chunk_rows=32, use_kernel=True,
             record_objective=True), None, False, ("y",))
    assert all(o[0] == "DecompError" and "record_objective" in o[1]
               for o in refused)


@pytest.mark.parametrize("tol,maxiter", [(1e-2, 400), (np.inf, 10)])
def test_heldout_lockstep(worlds, tol, maxiter):
    """stop='heldout' fed decomp_tpu's draws stops on JAX's epoch; with the
    port's own draw it stops on the one-process run's epoch with the same
    reported error (the draw of a chunk depends on its global offset
    alone)."""
    arrays = _problem(15, m=300, n=32, masked=True)
    kw = dict(tol=tol, maxiter=maxiter, chunk_rows=64, stop="heldout",
              check_every=5, random_seed=3, heldout_frac=0.1)
    draws = _jax_draws(3, 0.1, 300, 32, 64, 4)
    outs = _run(worlds, "row4", arrays, draws, **kw)
    jref = _jax(arrays, "row4", **kw)
    assert bool(jref.converged)
    _check(outs, jref, 1e-10)
    for o in outs:
        assert abs(o["heldout"] - float(jref.aux["heldout_rel_err"])) <= (
            1e-6 * o["heldout"])
    outs = _run(worlds, "row4", arrays, **kw)
    ref = _single(arrays, **kw)
    _check(outs, ref, 1e-12)
    for o in outs:
        assert o["heldout"] == pytest.approx(
            float(ref.aux["heldout_rel_err"]), rel=1e-12)


def test_masked_completion_streaming_mesh(worlds):
    """The preset over a mesh: the one-process preset's run and JAX's
    sharded preset, fed JAX's draws; the one-process refusal is gone."""
    arrays = _problem(17, m=256, n=32, masked=True, noise=0.05)
    kw = dict(chunk_rows=64, tol=5e-3, maxiter=400, check_every=10,
              random_seed=3, rank=4)
    draws = _jax_draws(3, 0.05, 256, 32, 64, 2)
    outs = worlds(2).run(ranks.completion_streaming, MESHES["row2"][0],
                         arrays, {**F64, **kw}, draws)
    y, mask = arrays["y"], arrays["mask"]
    ref = tns.masked_completion_streaming(
        lambda lo, hi: y[lo:hi], lambda lo, hi: mask[lo:hi], d=arrays["d"],
        x=arrays["x"], n_samples=256, n_channels=32, device="cpu",
        _chunk_reserve=lambda lo, shape: draws[lo], **F64, **kw)
    assert ref.converged
    _check(outs, ref, 1e-12)
    mesh, _ = _jax_mesh("row2")
    yj, mj = _jax_loaders(arrays, 64)
    jref = decomp_tpu.nmf.masked_completion_streaming(
        yj, mj, d=arrays["d"], x=arrays["x"], n_samples=256, n_channels=32,
        dtype=np.float64, mesh=mesh, **kw)
    _check(outs, jref, 1e-10)


def test_seeded_start(worlds):
    """Without d and x: d from the head chunk's observed mean, the same on
    every rank and equal to decomp_tpu's seeded d; x drawn per rank from
    its row coordinate, nonnegative, repeatable."""
    arrays = _problem(19, masked=True)
    arrays.update(d=None, x=None)
    kw = dict(rank=4, tol=0.0, chunk_rows=32, random_seed=5)
    start = _run(worlds, "row4", arrays, maxiter=0, **kw)
    jstart = _jax(arrays, "row4", maxiter=0, **kw)
    assert rel_err(start[0]["d"], np.asarray(jstart.d)) < 1e-12
    assert all(o["d_same"] for o in start)
    outs = _run(worlds, "row4", arrays, maxiter=5, **kw)
    again = _run(worlds, "row4", arrays, maxiter=5, **kw)
    x = assemble(outs, "x")
    assert np.array_equal(x, assemble(again, "x"))
    assert np.isfinite(x).all() and (x >= 0).all()
    assert not np.array_equal(outs[0]["x"][:8], outs[1]["x"][:8])


def _nmf_kw(**kw):
    y = np.ones((64, 6))
    return {**dict(y=y, rank=2, n_samples=64, n_channels=6, chunk_rows=16,
                   dtype=torch.float64), **kw}


REFUSALS = {
    "method": (_nmf_kw(method="hals"), ("y",)),
    "host array": (_nmf_kw(), ()),
    "chunk rows": (_nmf_kw(chunk_rows=65), ("y",)),
    "heldout without mask": (_nmf_kw(stop="heldout"), ("y",)),
    "x rows": (_nmf_kw(x=np.ones((63, 2))), ("y",)),
    "dtype": (_nmf_kw(dtype=np.float64), ("y",)),
    "axis": (_nmf_kw(row_axis="cols"), ("y",)),
    "kernel rank": (_nmf_kw(rank=200, use_kernel=True), ("y",)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_on_every_rank(worlds, case):
    kw, loaders = REFUSALS[case]
    outs = worlds(2).run(ranks.refusal, MESHES["row2"][0], "nmf_streaming",
                         kw, None, False, loaders)
    assert all(o is not None for o in outs), outs
    for name, _ in outs:
        assert issubclass(getattr(texc, name), DecompError)


def test_mesh_must_be_a_device_mesh():
    y = np.ones((8, 4))
    with pytest.raises(DecompError, match="DeviceMesh"):
        dt.parallel.nmf.solve_streaming(
            lambda lo, hi: y[lo:hi], rank=2, mesh=object(), n_samples=8,
            n_channels=4, dtype=torch.float64, chunk_rows=4)
