"""Parity of ``decomp_tpu_torch.ops.loop.run_iterations`` with
``decomp_tpu.ops.loop.run_iterations``: a deterministic step and
objective go through both loops, and ``niter``, ``converged`` and the
NaN-padded objective curve must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decomp_tpu.ops import loop as jloop
from decomp_tpu_torch.ops import loop as tloop


def _step(s, it):
    # s -> 2 geometrically; the same IEEE operations in both packages.
    return s * 0.5 + 1.0


def _diff(old, new):
    return abs(new - old) / abs(old)


def _objective(s):
    return (s - 2.0) * (s - 2.0)


def _run_both(**kw):
    j = jloop.run_iterations(
        _step, jnp.asarray(np.float64(7.0)), diff_fn=_diff,
        objective_fn=_objective, **kw)
    t = tloop.run_iterations(
        _step, torch.tensor(7.0, dtype=torch.float64), diff_fn=_diff,
        objective_fn=_objective, **kw)
    return j, t


@pytest.mark.parametrize("tol,maxiter,check_every,min_iter,record", [
    (1e-6, 100, 1, 0, True),     # converges mid-run
    (1e-6, 10, 1, 0, True),      # hits maxiter first
    (0.0, 12, 1, 0, True),       # tol 0: all iterations
    (1e-6, 100, 4, 0, False),    # blocks of 4
    (1e-6, 10, 4, 0, False),     # maxiter not a multiple of check_every
    (0.0, 10, 4, 0, False),
    (0.3, 100, 1, 9, True),      # min_iter delays the verdict
    (0.3, 100, 3, 7, False),
    (0.3, 5, 3, 7, False),       # min_iter beyond maxiter: never converged
])
def test_loop_parity(tol, maxiter, check_every, min_iter, record):
    j, t = _run_both(tol=tol, maxiter=maxiter, check_every=check_every,
                     min_iter=min_iter, record_objective=record)
    assert t.niter == int(j.niter)
    assert t.converged == bool(j.converged)
    assert float(t.state) == float(j.state)
    np.testing.assert_array_equal(t.objective.numpy(), np.asarray(j.objective))


@pytest.mark.parametrize("kw", [
    dict(maxiter=0),
    dict(maxiter=5, check_every=0),
    dict(maxiter=5, check_every=2, record_objective=True),
])
def test_loop_value_errors_match(kw):
    with pytest.raises(ValueError):
        jloop.run_iterations(_step, jnp.asarray(1.0), tol=0.0, diff_fn=_diff,
                             objective_fn=_objective, **kw)
    with pytest.raises(ValueError):
        tloop.run_iterations(_step, torch.tensor(1.0), tol=0.0,
                             diff_fn=_diff, objective_fn=_objective, **kw)


def test_record_objective_requires_fn():
    with pytest.raises(ValueError):
        tloop.run_iterations(_step, torch.tensor(1.0), tol=0.0, maxiter=3,
                             diff_fn=_diff, record_objective=True)


def test_tol_zero_never_reads_diff():
    """With tol <= 0 the stop test of a diff the caller declares
    nonnegative cannot fire, so the loop skips the diff (and its host
    read) entirely."""
    calls = []

    def diff(old, new):
        calls.append(1)
        return _diff(old, new)

    res = tloop.run_iterations(_step, torch.tensor(7.0), tol=0.0,
                               maxiter=6, diff_fn=diff,
                               diff_nonnegative=True)
    assert res.niter == 6 and not res.converged and not calls


def _improvement(old, new):
    # Relative improvement of a held-out-like error e(s) = (s - 3)^2: the
    # step drives s from 7 towards 2, so e falls until s passes 3 and then
    # rises, and the diff goes negative.
    e_old, e_new = (old - 3.0) ** 2, (new - 3.0) ** 2
    return (e_old - e_new) / e_old


@pytest.mark.parametrize("check_every,min_iter", [(1, 0), (2, 0), (1, 4)])
def test_negative_diff_stops_at_tol_zero(check_every, min_iter):
    """A diff that goes negative stops the loop at tol=0, as the JAX loop
    stops (it always compares diff < tol): held-out stopping at tol=0
    must end when the validation error rises."""
    kw = dict(tol=0.0, maxiter=50, diff_fn=_improvement,
              check_every=check_every, min_iter=min_iter)
    j = jloop.run_iterations(_step, jnp.asarray(np.float64(7.0)), **kw)
    t = tloop.run_iterations(_step, torch.tensor(7.0, dtype=torch.float64),
                             **kw)
    assert bool(j.converged) and int(j.niter) < 50
    assert t.niter == int(j.niter)
    assert t.converged == bool(j.converged)
    assert float(t.state) == float(j.state)


def test_step_sees_exact_iteration_indices():
    seen = []

    def step(s, it):
        seen.append(it)
        return _step(s, it)

    tloop.run_iterations(step, torch.tensor(7.0), tol=0.0, maxiter=10,
                         diff_fn=_diff, check_every=4)
    assert seen == list(range(10))


def test_verbose_prints_each_check(capsys):
    tloop.run_iterations(_step, torch.tensor(7.0), tol=0.0, maxiter=8,
                         diff_fn=_diff, check_every=4, verbose=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["iter 4", "iter 8"]
