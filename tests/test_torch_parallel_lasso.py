"""Sharded batch lasso of the PyTorch port (``decomp_tpu_torch.parallel.
lasso``) on gloo worlds of CPU ranks, against the port's one-process solve
and ``decomp_tpu.parallel.lasso`` on a JAX mesh of the same shape.

Rows are independent problems, so a rank's rows follow the one-process
trajectory; only the global stopping scalars are summed. Tolerances: f64,
1e-12 relative against the one-process port and JAX at a fixed budget,
1e-10 where the run stops on the global rule (the rule's sums differ in
order); the kernels' twins (f32) to 1e-6 against the one-process kernel
path, whose rows they split."""

import numpy as np
import pytest
import torch

import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from problems import planted_lasso, random_mask, rel_err
from torch_parallel_ranks import assemble, worlds  # noqa: F401

ROW4 = ((4,), ("rows",))
SLICE = ((2, 2), ("slice", "rows"))


def _single(arrays, **kw):
    t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in arrays.items()}
    return dt.lasso.solve(t.pop("y"), t.pop("a"), t.pop("alpha"),
                          device="cpu", **t, **kw)


def _jax(arrays, spec, axis, **kw):
    import jax
    from decomp_tpu import parallel as jpar

    mesh = jpar.make_mesh(*spec, devices=jax.devices()[:4])
    a = dict(arrays)
    return jpar.lasso.solve(a.pop("y"), a.pop("a"), a.pop("alpha"),
                            mesh=mesh, axis=axis, **a, **kw)


def _counts(outs, key):
    return np.concatenate([o[key] for o in sorted(outs,
                                                  key=lambda o: o["row"])])


@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd", "cd"])
def test_every_method_matches_single_and_jax(worlds, method):
    y, a, _ = planted_lasso(seed=13, n_samples=16)
    arrays = dict(y=y, a=a, alpha=0.05)
    kw = dict(tol=0.0, maxiter=30, method=method)
    outs = worlds(4).run(ranks.lasso, ROW4, "rows", arrays, kw)
    x = assemble(outs)
    assert rel_err(x, _single(arrays, **kw).x.numpy()) < 1e-12
    assert rel_err(x, np.asarray(_jax(arrays, ROW4, "rows", **kw).x)) < 1e-12
    assert {o["niter"] for o in outs} == {30}


@pytest.mark.parametrize("method", ["fista", "acc_ista"])
@pytest.mark.parametrize("spec,axis", [(ROW4, "rows"),
                                       (SLICE, ("slice", "rows"))])
def test_per_problem_matches_single_and_jax(worlds, spec, axis,
                                            method):
    """Rows freeze rank-locally; niter and converged come back per row,
    each rank its own."""
    rng = np.random.default_rng(31)
    a = rng.normal(size=(24, 96))
    y = rng.normal(size=(16, 96)) * (10.0 ** rng.uniform(-2, 1, (16, 1)))
    arrays = dict(y=y, a=a, alpha=0.05)
    kw = dict(tol=1e-6, maxiter=5000, method=method, per_problem=True)
    outs = worlds(4).run(ranks.lasso, spec, axis, arrays, kw)
    ref = _single(arrays, **kw)
    jref = _jax(arrays, spec, axis, **kw)
    nit = _counts(outs, "niter")
    assert nit.shape == (16,) and len(set(nit.tolist())) > 1
    np.testing.assert_array_equal(nit, ref.niter.numpy())
    np.testing.assert_array_equal(nit, np.asarray(jref.niter))
    np.testing.assert_array_equal(_counts(outs, "converged"),
                                  ref.converged.numpy())
    assert rel_err(assemble(outs), ref.x.numpy()) < 1e-12
    assert rel_err(assemble(outs), np.asarray(jref.x)) < 1e-12


@pytest.mark.parametrize("spec,axis", [(ROW4, "rows"),
                                       (SLICE, ("slice", "rows"))])
def test_masked_early_stop_matches_single_and_jax(worlds, spec, axis):
    y, a, _ = planted_lasso(seed=14, n_samples=16)
    mask = random_mask(15, y.shape)
    arrays = dict(y=y * mask, a=a, alpha=0.05, mask=mask)
    kw = dict(tol=1e-8, maxiter=5000, method="acc_ista")
    outs = worlds(4).run(ranks.lasso, spec, axis, arrays, kw)
    ref = _single(arrays, **kw)
    jref = _jax(arrays, spec, axis, **kw)
    assert ref.converged
    assert {o["niter"] for o in outs} == {ref.niter, int(jref.niter)}
    assert {o["converged"] for o in outs} == {True}
    assert rel_err(assemble(outs), ref.x.numpy()) < 1e-10
    assert rel_err(assemble(outs), np.asarray(jref.x)) < 1e-10


@pytest.mark.parametrize("per_problem", [False, True])
def test_masked_kernel_twin(worlds, per_problem):
    """use_kernel=True with a mask: cuda_lasso.masked_grad_rows (its twin
    here) on each rank's rows, the 0/1 mask packed where every rank's block
    is 0/1."""
    rng = np.random.default_rng(71)
    m, n, f = 48, 72, 40
    a = rng.normal(size=(f, n)).astype(np.float32)
    y = rng.normal(size=(m, n)).astype(np.float32)
    mask = (rng.random((m, n)) > 0.3).astype(np.float32)
    lip = float(np.linalg.eigvalsh(a @ a.T).max() * 1.05)
    arrays = dict(y=y * mask, a=a, alpha=0.05, mask=mask, lipschitz=lip)
    kw = dict(tol=1e-5, maxiter=2000, method="fista", use_kernel=True,
              per_problem=per_problem)
    outs = worlds(4).run(ranks.lasso, ROW4, "rows", arrays, kw)
    ref = _single(arrays, **kw)
    assert rel_err(assemble(outs), ref.x.numpy()) < 1e-6
    jref = _jax(arrays, ROW4, "rows", tol=1e-5, maxiter=2000,
                method="fista", per_problem=per_problem)
    assert rel_err(assemble(outs), np.asarray(jref.x)) < 1e-4
    if per_problem:
        np.testing.assert_array_equal(_counts(outs, "niter"),
                                      ref.niter.numpy())


def test_whole_solve_twin(worlds):
    """use_kernel=True, unmasked, per_problem: one cuda_lasso.solve_rows
    call (its twin here) on each rank's rows and no collective; a row's
    solve does not depend on the other rows, so every bit is the
    one-process call's."""
    rng = np.random.default_rng(85)
    m, f, n = 64, 48, 32
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    xt = (rng.normal(size=(m, f)) * (rng.random((m, f)) < 0.1)).astype(
        np.float32)
    y = (xt @ a + 0.01 * rng.normal(size=(m, n))).astype(np.float32)
    arrays = dict(y=y, a=a, alpha=0.05)
    kw = dict(tol=1e-5, maxiter=300, method="fista", per_problem=True,
              use_kernel=True)
    outs = worlds(4).run(ranks.lasso, ROW4, "rows", arrays, kw)
    ref = _single(arrays, **kw)
    assert rel_err(assemble(outs), ref.x.numpy()) < 1e-6
    np.testing.assert_array_equal(_counts(outs, "niter"), ref.niter.numpy())
    jref = _jax(arrays, ROW4, "rows", tol=1e-5, maxiter=300, method="fista",
                per_problem=True)
    assert rel_err(assemble(outs), np.asarray(jref.x)) < 1e-4


def test_feature_alpha_warm_start_and_complex(worlds):
    y, a, _ = planted_lasso(seed=32, n_samples=16)
    alphas = np.full((a.shape[0],), 0.05)
    arrays = dict(y=y, a=a, alpha=alphas)
    outs = worlds(4).run(ranks.lasso, ROW4, "rows", arrays,
                         dict(tol=0.0, maxiter=25))
    assert rel_err(assemble(outs), _single(arrays, tol=0.0,
                                           maxiter=25).x.numpy()) < 1e-12
    full = worlds(4).run(ranks.lasso, ROW4, "rows", arrays,
                         dict(tol=1e-12, maxiter=50000))
    assert {o["converged"] for o in full} == {True}
    warm = worlds(4).run(ranks.lasso, ROW4, "rows",
                         {**arrays, "x": assemble(full)},
                         dict(tol=1e-6, maxiter=50, method="ista"))
    assert {o["converged"] for o in warm} == {True}
    assert max(o["niter"] for o in warm) <= 3
    # per-sample alpha (2-D) shards with the rows
    per_row = np.linspace(0.02, 0.08, 16)[:, None] * np.ones((1, a.shape[0]))
    arrays = dict(y=y, a=a, alpha=per_row)
    outs = worlds(4).run(ranks.lasso, ROW4, "rows", arrays,
                         dict(tol=0.0, maxiter=25))
    assert rel_err(assemble(outs), _single(arrays, tol=0.0,
                                           maxiter=25).x.numpy()) < 1e-12
    # complex data run natively
    yc, ac, _ = planted_lasso(seed=33, n_samples=16, complex_=True)
    arrays = dict(y=yc, a=ac, alpha=0.05)
    kw = dict(tol=1e-8, maxiter=3000, method="fista")
    outs = worlds(4).run(ranks.lasso, ROW4, "rows", arrays, kw)
    ref = _single(arrays, **kw)
    assert {o["niter"] for o in outs} == {ref.niter}
    assert rel_err(assemble(outs), ref.x.numpy()) < 1e-10
    assert rel_err(assemble(outs),
                   np.asarray(_jax(arrays, ROW4, "rows", **kw).x)) < 1e-10
