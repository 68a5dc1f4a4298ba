"""Sharded out-of-core dictionary learning and batch lasso of the PyTorch
port (``parallel.dictionary_learning.solve_streaming``,
``parallel.lasso.solve_streaming``) on gloo worlds of CPU ranks, against the
port's one-process streamers and in-core solves and against
``decomp_tpu.parallel``'s streamers on a JAX mesh of the same shape.

Dictionary learning: each rank codes its chunks against the same d, and the
statistics are all-reduced once an epoch, so d holds the same bits on every
rank. Each chunk's inner lasso stops on its own chunk, as in one process and
in JAX, so a run with ``lasso_tol > 0`` agrees with the one-process streamer
(a summed inner stop would not). Lasso: every rank passes the global
arrays; each chunk is split over the ranks and put together again, so every
rank returns the whole x. Tolerances: f64, 1e-12 relative against the port
and 1e-10 against JAX (measured <= 2.3e-16 against either for the masked
DL case of test_dl_matches_single_and_jax), with equal niter and
converged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from decomp_tpu.models.nmf import _HELDOUT_SALT
from problems import planted_lasso, planted_patches, random_mask, rel_err
from torch_parallel_ranks import assemble, worlds  # noqa: F401

ROW2 = ((2,), ("rows",))
ROW4 = ((4,), ("rows",))
SLICE = ((2, 2), ("slice", "rows"))
F64 = dict(dtype=torch.float64)


def _jax_mesh(spec):
    from decomp_tpu import parallel as jpar

    shape, names = spec
    return jpar.make_mesh(shape, names,
                          devices=jax.devices()[:int(np.prod(shape))])


def _dl_problem(seed=31, m=200, masked=False):
    """Planted patches (16 channels, 8 atoms), pre-masked where masked, and
    a perturbed start. In 32-row chunks a world of 4 has 2 chunks a rank,
    rank 3 one ragged chunk and one wholly past the data."""
    y, d_true, _ = planted_patches(seed=seed, n_samples=m, n_channels=16,
                                   n_atoms=8)
    rng = np.random.default_rng(seed + 2)
    d0 = d_true + 0.3 * rng.normal(size=d_true.shape)
    mask = random_mask(seed + 1, y.shape) if masked else None
    return dict(y=y if mask is None else y * mask, mask=mask, d=d0,
                alpha=0.05)


def _dl_single(arrays, **kw):
    y, mask = arrays["y"], arrays["mask"]
    return dt.dictionary_learning.solve_streaming(
        lambda lo, hi: y[lo:hi], arrays["d"], arrays["alpha"],
        mask=None if mask is None else (lambda lo, hi: mask[lo:hi]),
        n_samples=y.shape[0], n_channels=y.shape[1], jit_loader=True,
        device="cpu", **F64, **kw)


def _dl_jax(arrays, spec, row_axis, **kw):
    from decomp_tpu import parallel as jpar

    y, mask, chunk = arrays["y"], arrays["mask"], kw["chunk_rows"]

    def loader(a):
        aj = jnp.asarray(a)
        return lambda lo, hi: jax.lax.dynamic_slice(aj, (lo, 0),
                                                    (chunk, a.shape[1]))

    return jpar.dictionary_learning.solve_streaming(
        loader(y), arrays["d"], arrays["alpha"],
        mask=None if mask is None else loader(mask), mesh=_jax_mesh(spec),
        row_axis=row_axis, n_samples=y.shape[0], n_channels=y.shape[1],
        dtype=np.float64, **kw)


def _dl_run(worlds, spec, row_axis, arrays, draws=None, **kw):
    return worlds(int(np.prod(spec[0]))).run(
        ranks.dl_streaming, spec, row_axis, arrays, {**F64, **kw}, draws)


def _check(outs, ref, tol, m=None):
    x = assemble(outs, "x")
    if m is not None:
        assert x.shape[0] == m
    assert rel_err(x, np.asarray(ref.x)) < tol
    assert rel_err(outs[0]["d"], np.asarray(ref.d)) < tol
    assert {o["niter"] for o in outs} == {int(ref.niter)}
    assert {bool(o["converged"]) for o in outs} == {bool(ref.converged)}
    assert all(o["d_same"] for o in outs)


@pytest.mark.parametrize("spec,row_axis,masked", [
    (ROW4, "rows", False), (ROW4, "rows", True),
    (SLICE, ("slice", "rows"), True)])
def test_dl_matches_single_and_jax(worlds, spec, row_axis, masked):
    """Ragged grids and a chunk past the data, at the full inner budget
    (lasso_tol 0); the objective curve is the global one."""
    arrays = _dl_problem(masked=masked)
    kw = dict(tol=0.0, maxiter=6, lasso_iter=8, lasso_tol=0.0,
              chunk_rows=32, record_objective=True)
    outs = _dl_run(worlds, spec, row_axis, arrays, **kw)
    ref = _dl_single(arrays, **kw)
    _check(outs, ref, 1e-12, m=200)
    assert [o["x"].shape[0] for o in outs] == [64, 64, 64, 8]
    jref = _dl_jax(arrays, spec, row_axis, **kw)
    _check(outs, jref, 1e-10)
    for o in outs:
        assert rel_err(o["objective"], ref.objective.numpy()) < 1e-12
        assert rel_err(o["objective"], np.asarray(jref.objective)) < 1e-10


@pytest.mark.parametrize("masked", [False, True])
def test_dl_inner_stop_is_chunk_local(worlds, masked):
    """lasso_tol > 0 with a rel-change stop: each chunk's inner lasso stops
    on its own chunk, so the sharded run is the one-process streamer's (and
    JAX's), and not a run whose inner stop sums over the ranks' chunks."""
    arrays = _dl_problem(37, masked=masked)
    kw = dict(tol=1e-3, maxiter=30, lasso_iter=40, lasso_tol=1e-3,
              chunk_rows=32, check_every=3)
    outs = _dl_run(worlds, ROW4, "rows", arrays, **kw)
    _check(outs, _dl_single(arrays, **kw), 1e-12)
    _check(outs, _dl_jax(arrays, ROW4, "rows", **kw), 1e-10)


@pytest.mark.parametrize("masked", [False, True])
def test_dl_kernel_twins(worlds, masked):
    """f32 chunks on the kernel routes, their twins on CPU ranks: masked,
    use_kernel=True sends each chunk's gradients to masked_grad_rows and
    masked_grad_dict; unmasked, _bcd_kernel=True sweeps the summed
    statistics through bcd_sweep on every rank. Within 1e-6 of the
    one-process streamer on the same routes."""
    arrays = {k: v.astype(np.float32) if isinstance(v, np.ndarray) else v
              for k, v in _dl_problem(43, masked=masked).items()}
    kw = dict(tol=0.0, maxiter=5, lasso_iter=8, lasso_tol=0.0,
              chunk_rows=32, dtype=torch.float32,
              **({"use_kernel": True} if masked else {"_bcd_kernel": True}))
    outs = worlds(4).run(ranks.dl_streaming, ROW4, "rows", arrays, kw)
    y, mask = arrays["y"], arrays["mask"]
    ref = dt.dictionary_learning.solve_streaming(
        lambda lo, hi: y[lo:hi], arrays["d"], arrays["alpha"],
        mask=None if mask is None else (lambda lo, hi: mask[lo:hi]),
        n_samples=200, n_channels=16, jit_loader=True, device="cpu", **kw)
    _check(outs, ref, 1e-6)


def test_dl_heldout_lockstep(worlds):
    """stop='heldout' fed decomp_tpu's draws (by global chunk offset) stops
    on JAX's outer iteration; with the port's own draw it stops on the
    one-process streamer's. 320 rows in 64-row chunks over 2 ranks: rank
    1's third chunk lies wholly past the data."""
    rng = np.random.default_rng(104)
    m, ch, k = 320, 24, 6
    d_true = rng.normal(size=(k, ch))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    xt = rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.3)
    mask = (rng.random((m, ch)) >= 0.3).astype(np.float64)
    y = (xt @ d_true + 0.01 * rng.normal(size=(m, ch))) * mask
    arrays = dict(y=y, mask=mask, d=rng.normal(size=(k, ch)), alpha=0.02)
    kw = dict(tol=1e-2, maxiter=200, lasso_iter=8, chunk_rows=64,
              stop="heldout", check_every=4, random_seed=5)
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(5)),
                             _HELDOUT_SALT)
    draws = {lo: np.asarray(jax.random.uniform(
        jax.random.fold_in(key, np.uint32(lo)), (64, ch)) < 0.05,
        dtype=np.float64) for lo in range(0, 384, 64)}
    outs = _dl_run(worlds, ROW2, "rows", arrays, draws, **kw)
    jref = _dl_jax(arrays, ROW2, "rows", **kw)
    assert bool(jref.converged) and int(jref.niter) < 200
    _check(outs, jref, 1e-10)
    for o in outs:
        assert o["heldout"] == pytest.approx(
            float(jref.aux["heldout_rel_err"]), rel=1e-6)
    outs = _dl_run(worlds, ROW2, "rows", arrays, **kw)
    _check(outs, _dl_single(arrays, **kw), 1e-12)


def _lasso_problem(seed=43, m=300, masked=False):
    y, a, _ = planted_lasso(seed=seed, n_samples=m, n_features=24,
                            n_channels=16, density=0.2)
    mask = random_mask(seed + 1, y.shape) if masked else None
    return dict(y=y, a=a, alpha=0.05, mask=mask)


def _lasso_run(worlds, spec, axis, arrays, **kw):
    return worlds(int(np.prod(spec[0]))).run(ranks.lasso_streaming, spec,
                                             axis, arrays, kw)


@pytest.mark.parametrize("per_problem,masked", [(False, False),
                                                (True, False), (False, True)])
def test_lasso_matches_single_core_and_jax(worlds, per_problem, masked):
    """300 rows in chunks of 128 (a ragged last chunk, padded to 4 ranks):
    every rank holds the whole x, equal to the one-process streamer's, to
    the in-core solve's with per-problem stopping (rows are independent),
    and to JAX's sharded streamer."""
    arrays = _lasso_problem(masked=masked)
    kw = dict(tol=1e-6, maxiter=500, method="fista", chunk_rows=128,
              per_problem=per_problem)
    outs = _lasso_run(worlds, ROW4, "rows", arrays, **kw)
    y, a, mask = arrays["y"], arrays["a"], arrays["mask"]
    single = dt.lasso.solve_streaming(y, a, 0.05, mask=mask, device="cpu",
                                      **kw)
    jref = decomp_tpu.parallel.lasso.solve_streaming(
        y, a, 0.05, mask=mask, mesh=_jax_mesh(ROW4), use_pallas=False, **kw)
    for o in outs:
        assert np.array_equal(o["x"], outs[0]["x"])
        assert rel_err(o["x"], single.x) < 1e-12
        assert rel_err(o["x"], np.asarray(jref.x)) < 1e-10
        assert np.array_equal(o["niter"], np.asarray(single.niter))
        assert np.array_equal(o["converged"], np.asarray(single.converged))
        assert np.array_equal(o["niter"], np.asarray(jref.niter))
    if per_problem:
        core = dt.lasso.solve(torch.as_tensor(y), torch.as_tensor(a), 0.05,
                              device="cpu", per_problem=True,
                              **{k: kw[k] for k in ("tol", "maxiter",
                                                    "method")})
        assert rel_err(outs[0]["x"], core.x.numpy()) < 1e-12
        assert np.array_equal(outs[0]["niter"], core.niter.numpy())


def test_lasso_whole_solve_twin_and_tuple_axis(worlds):
    """use_kernel=True with per_problem: each rank's slice of a chunk goes
    to the whole-solve kernel (its twin on CPU ranks) with no collective,
    over a ('slice', 'rows') axis; the rows' x equal the one-process
    kernel path's to 1e-6 (f32), with the same per-row counts."""
    arrays = {k: v.astype(np.float32) if isinstance(v, np.ndarray) else v
              for k, v in _lasso_problem(47, m=200).items()}
    kw = dict(tol=1e-4, maxiter=300, method="acc_ista", chunk_rows=64,
              per_problem=True, use_kernel=True)
    outs = _lasso_run(worlds, SLICE, ("slice", "rows"), arrays, **kw)
    y, a = (torch.as_tensor(arrays[k]) for k in ("y", "a"))
    core = dt.lasso.solve(y, a, 0.05, device="cpu",
                          **{k: v for k, v in kw.items() if k != "chunk_rows"})
    for o in outs:
        assert rel_err(o["x"], core.x.numpy()) < 1e-6
        assert (o["niter"] == core.niter.numpy()).mean() > 0.95


def test_streaming_refusals_raise_on_every_rank(worlds):
    """The lasso's chunk must split over the axis; the DL streamer takes a
    loader and a scalar alpha: refused on every rank."""
    y, a = np.ones((40, 6)), np.ones((3, 6))
    cases = [
        ("lasso_streaming", dict(y=y, a=a, alpha=0.1, chunk_rows=15), ()),
        ("dl_streaming", dict(y=y, d=a, alpha=0.1, n_samples=40,
                              n_channels=6, dtype=torch.float64,
                              chunk_rows=8), ()),
        ("dl_streaming", dict(y=y, d=a, alpha=np.full((3,), 0.1),
                              n_samples=40, n_channels=6,
                              dtype=torch.float64, chunk_rows=8), ("y",)),
    ]
    for solver, kw, loaders in cases:
        outs = worlds(2).run(ranks.refusal, ROW2, solver, kw, None, False,
                             loaders)
        assert all(o is not None and o[0] == "DecompError" for o in outs), (
            solver, outs)
