"""Chunked solves with atomic snapshots in the PyTorch port
(``decomp_tpu_torch.utils.checkpoint``), the in-core cases of
``tests/test_checkpoint.py`` run on the port's solvers on CPU tensors, and
snapshots passed between ``decomp_tpu`` and the port.

On the CPU the port's products are deterministic, so "a chunked run equals
the uninterrupted one" is held bit for bit (``torch.equal``)."""

import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu.utils import checkpoint as jckpt
from decomp_tpu_torch.utils.checkpoint import (CheckpointManager,
                                               checkpointed_solve)
from problems import planted_nmf, rel_err
from test_torch_nmf import _t


def _problem():
    y, *_ = planted_nmf(seed=30, n_samples=60, n_channels=40, rank=4)
    rng = np.random.default_rng(31)
    x0 = rng.uniform(0.1, 1.0, (60, 4))
    d0 = rng.uniform(0.1, 1.0, (4, 40))
    return _t(y), x0, d0


def _lasso_problem(seed, m=8):
    rng = np.random.default_rng(seed)
    return _t(rng.normal(size=(m, 24))), _t(rng.normal(size=(16, 24)))


@pytest.mark.parametrize("method", ["mu", "kl-mu", "hals"])
def test_chunked_matches_straight_run(tmp_path, method):
    y, x0, d0 = _problem()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    res, total = checkpointed_solve(
        decomp_tpu_torch.nmf.solve, y, manager=mgr, chunk_iters=25,
        maxiter=100, tol=0.0, d=d0, x=x0, method=method)
    assert total == 100
    straight = decomp_tpu_torch.nmf.solve(y, _t(d0), x=_t(x0), tol=0.0,
                                          maxiter=100, method=method)
    assert torch.equal(res.d, straight.d) and torch.equal(res.x, straight.x)
    step, state = mgr.load()
    assert step == 100 and set(state) == {"x", "d"}
    assert np.array_equal(state["d"], straight.d.numpy())


def test_bf16_factors_round_trip(tmp_path):
    """bf16 factors widen exactly to f32 in the snapshot and narrow back
    to the same bits, so a chunked bf16 run equals the straight one."""
    y, x0, d0 = _problem()
    y = y.to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path / "bf16"))
    res, total = checkpointed_solve(
        decomp_tpu_torch.nmf.solve, y, manager=mgr, chunk_iters=10,
        maxiter=30, tol=0.0, d=d0, x=x0)
    straight = decomp_tpu_torch.nmf.solve(y, _t(d0), x=_t(x0), tol=0.0,
                                          maxiter=30)
    assert total == 30 and res.d.dtype == torch.bfloat16
    assert mgr.load()[1]["d"].dtype == np.float32
    assert torch.equal(res.d, straight.d) and torch.equal(res.x, straight.x)


def test_resume_after_interruption(tmp_path):
    y, x0, d0 = _problem()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    # "crash" after 50 of 100 iterations
    checkpointed_solve(decomp_tpu_torch.nmf.solve, y, manager=mgr,
                       chunk_iters=25, maxiter=50, tol=0.0, d=d0, x=x0)
    assert mgr.exists()
    step, state = mgr.load()
    assert step == 50 and set(state) == {"x", "d"}
    # resume to 100 in a fresh "session"
    res, total = checkpointed_solve(
        decomp_tpu_torch.nmf.solve, y, manager=mgr, chunk_iters=25,
        maxiter=100, tol=0.0, d=d0, x=x0)
    assert total == 100
    straight = decomp_tpu_torch.nmf.solve(y, _t(d0), x=_t(x0), tol=0.0,
                                          maxiter=100)
    assert torch.equal(res.d, straight.d) and torch.equal(res.x, straight.x)


def test_stops_on_convergence(tmp_path):
    y, x0, d0 = _problem()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    res, total = checkpointed_solve(
        decomp_tpu_torch.nmf.solve, y, manager=mgr, chunk_iters=2000,
        maxiter=100000, tol=1e-5, d=d0, x=x0)
    assert res.converged
    assert total < 100000 and mgr.load()[0] == total


def test_lasso_checkpointing(tmp_path):
    """ISTA is Markovian in x, so chunked == straight exactly; with no
    warm_fields the auto choice threads x alone (a lasso result has no
    d)."""
    y, a = _lasso_problem(32)
    straight = decomp_tpu_torch.lasso.solve(y, a, 0.05, tol=0.0, maxiter=40,
                                            method="ista")
    for name, kw in (("given", dict(warm_fields=("x",))), ("auto", {})):
        mgr = CheckpointManager(str(tmp_path / name))
        res, total = checkpointed_solve(
            decomp_tpu_torch.lasso.solve, y, a, 0.05, manager=mgr,
            chunk_iters=10, maxiter=40, tol=0.0, method="ista", **kw)
        assert total == 40
        assert torch.equal(res.x, straight.x)
        assert set(mgr.load()[1]) == {"x"}


def test_positional_factor_is_refused(tmp_path):
    """dictionary learning's d is positional: the auto warm fields would
    have to re-inject it as a keyword, so the call is refused up front."""
    y, _ = _lasso_problem(57)
    d0 = _t(np.random.default_rng(58).normal(size=(4, 24)))
    with pytest.raises(decomp_tpu_torch.utils.DecompError, match="keyword"):
        checkpointed_solve(
            decomp_tpu_torch.dictionary_learning.solve, y, d0, 0.05,
            manager=CheckpointManager(str(tmp_path / "dl")),
            chunk_iters=5, maxiter=10, tol=0.0)


@pytest.mark.parametrize("method", ["fista", "acc_ista"])
def test_chunked_momentum_matches_straight_exactly(tmp_path, method):
    """(z, t) is threaded between chunks and through an interruption."""
    y, a = _lasso_problem(35)
    straight = decomp_tpu_torch.lasso.solve(y, a, 0.05, tol=0.0, maxiter=40,
                                            method=method)
    mgr = CheckpointManager(str(tmp_path / "fista"))
    res, total = checkpointed_solve(
        decomp_tpu_torch.lasso.solve, y, a, 0.05, manager=mgr,
        chunk_iters=10, maxiter=40, tol=0.0, method=method,
        warm_fields=("x",))
    assert total == 40
    assert torch.equal(res.x, straight.x)
    assert {"__decomp_tpu_aux_z", "__decomp_tpu_aux_t"} <= set(
        np.load(mgr.path).files)
    mgr2 = CheckpointManager(str(tmp_path / "fista2"))
    checkpointed_solve(decomp_tpu_torch.lasso.solve, y, a, 0.05,
                       manager=mgr2, chunk_iters=10, maxiter=20, tol=0.0,
                       method=method, warm_fields=("x",))
    res2, total2 = checkpointed_solve(
        decomp_tpu_torch.lasso.solve, y, a, 0.05, manager=mgr2,
        chunk_iters=10, maxiter=40, tol=0.0, method=method,
        warm_fields=("x",))
    assert total2 == 40
    assert torch.equal(res2.x, straight.x)


@pytest.mark.parametrize("method", ["acc_ista", "fista"])
def test_chunked_per_problem_matches_straight(tmp_path, method):
    """per_problem: rows converge at their own iterations; the chunked
    run freezes the done rows across chunks and counts niter cumulatively,
    so x and niter equal the straight run's row for row."""
    rng = np.random.default_rng(37)
    a = _t(rng.normal(size=(16, 24)))
    y = _t(rng.normal(size=(12, 24)) * rng.uniform(0.2, 3.0, (12, 1)))
    kw = dict(tol=1e-6, method=method, per_problem=True)
    straight = decomp_tpu_torch.lasso.solve(y, a, 0.05, maxiter=300, **kw)
    assert len(set(straight.niter.tolist())) > 1
    mgr = CheckpointManager(str(tmp_path / "pp"))
    res, total = checkpointed_solve(
        decomp_tpu_torch.lasso.solve, y, a, 0.05, manager=mgr,
        chunk_iters=7, maxiter=300, warm_fields=("x",), **kw)
    assert torch.equal(res.x, straight.x)
    assert torch.equal(res.niter, straight.niter)
    assert torch.equal(res.converged, straight.converged)
    assert total == int(straight.niter.max())


def test_per_problem_keeps_return_state_false():
    """An explicit return_state=False is kept (no aux), and per_problem
    without a momentum method runs in chunks."""
    import tempfile

    y, a = _lasso_problem(37, m=4)
    with tempfile.TemporaryDirectory() as tmp:
        res, total = checkpointed_solve(
            decomp_tpu_torch.lasso.solve, y, a, 0.05,
            manager=CheckpointManager(tmp + "/pp"), chunk_iters=10,
            maxiter=20, tol=0.0, method="ista", warm_fields=("x",),
            per_problem=True)
        assert total == 20 and tuple(res.niter.shape) == (4,)
        res2, _ = checkpointed_solve(
            decomp_tpu_torch.lasso.solve, y, a, 0.05,
            manager=CheckpointManager(tmp + "/rs"), chunk_iters=10,
            maxiter=20, tol=0.0, method="fista", warm_fields=("x",),
            return_state=False)
        assert res2.aux is None


def test_exhausted_budget_raises(tmp_path):
    y, x0, d0 = _problem()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    checkpointed_solve(decomp_tpu_torch.nmf.solve, y, manager=mgr,
                       chunk_iters=10, maxiter=10, tol=0.0, d=d0, x=x0)
    with pytest.raises(RuntimeError):
        checkpointed_solve(decomp_tpu_torch.nmf.solve, y, manager=mgr,
                           chunk_iters=10, maxiter=10, tol=0.0, d=d0, x=x0)
    with pytest.raises(ValueError):
        checkpointed_solve(decomp_tpu_torch.nmf.solve, y, manager=mgr,
                           chunk_iters=0, maxiter=20, tol=0.0, d=d0, x=x0)


def test_save_is_atomic_and_takes_tensors(tmp_path):
    """save() writes through a temporary file and a rename: the directory
    holds only the snapshot afterwards, tensors are stored as arrays, and a
    path without the suffix gains it."""
    mgr = CheckpointManager(str(tmp_path / "snap"))
    assert mgr.path.endswith("snap.npz") and not mgr.exists()
    mgr.save(7, {"d": torch.ones(2, 3, dtype=torch.bfloat16),
                 "x": np.zeros(4)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["snap.npz"]
    step, state = mgr.load()
    assert step == 7 and state["d"].dtype == np.float32
    assert np.array_equal(state["d"], np.ones((2, 3)))


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """A snapshot written by decomp_tpu's checkpointed_solve (50 MU
    iterations) resumes in the port, which continues JAX's trajectory:
    after 100 iterations the port's factors equal JAX's straight run to
    1e-10 relative (f64; measured ~1e-15)."""
    y, x0, d0 = _problem()
    path = str(tmp_path / "shared")
    jckpt.checkpointed_solve(decomp_tpu.nmf.solve, y.numpy(),
                             manager=jckpt.CheckpointManager(path),
                             chunk_iters=25, maxiter=50, tol=0.0, d=d0, x=x0)
    res, total = checkpointed_solve(
        decomp_tpu_torch.nmf.solve, y, manager=CheckpointManager(path),
        chunk_iters=25, maxiter=100, tol=0.0, d=d0, x=x0)
    assert total == 100
    straight = decomp_tpu.nmf.solve(y.numpy(), d0, x=x0, tol=0.0,
                                    maxiter=100)
    assert rel_err(res.d.numpy(), straight.d) < 1e-10
    assert rel_err(res.x.numpy(), straight.x) < 1e-10


def test_port_snapshot_resumes_in_jax(tmp_path):
    """The other way: a momentum snapshot of the port (acc_ista, with
    (z, t)) resumes in decomp_tpu and ends on JAX's straight run."""
    y, a = _lasso_problem(39)
    path = str(tmp_path / "shared")
    checkpointed_solve(decomp_tpu_torch.lasso.solve, y, a, 0.05,
                       manager=CheckpointManager(path), chunk_iters=10,
                       maxiter=20, tol=0.0, method="acc_ista")
    res, total = jckpt.checkpointed_solve(
        decomp_tpu.lasso.solve, y.numpy(), a.numpy(), 0.05,
        manager=jckpt.CheckpointManager(path), chunk_iters=10, maxiter=40,
        tol=0.0, method="acc_ista")
    straight = decomp_tpu.lasso.solve(y.numpy(), a.numpy(), 0.05, tol=0.0,
                                      maxiter=40, method="acc_ista")
    assert total == 40
    assert rel_err(np.asarray(res.x), straight.x) < 1e-10


# f64, minibatch rows drawn by decomp_tpu: the same products in other
# summation orders over 30 iterations, so the parity limit of
# tests/test_torch_nmf_minibatch.py, 1e-10 relative (Frobenius).
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
def test_chunked_minibatch_matches_jax_chunked(tmp_path, method):
    """checkpointed_solve over minibatch=: each chunk restarts the draws and
    the forget statistics, in both packages alike, so a chunked run differs
    from the straight one. The port's chunked run, each chunk fed
    decomp_tpu's draws of that chunk (its seed's first draws again, through
    the private ``_solve(batch_idx=)``), equals decomp_tpu's chunked run."""
    from decomp_tpu_torch.models import nmf as tnmf
    from decomp_tpu_torch.utils import convert
    from test_torch_nmf_minibatch import _jax_batches

    y, x0, d0 = _problem()
    m, k, batch, seed, chunk, iters = 60, 4, 16, 7, 10, 30
    kw = dict(tol=0.0, method=method, minibatch=batch, forget=0.8,
              random_seed=seed)
    rj, tj = jckpt.checkpointed_solve(
        decomp_tpu.nmf.solve, y.numpy(),
        manager=jckpt.CheckpointManager(str(tmp_path / "jax")),
        chunk_iters=chunk, maxiter=iters, d=d0, x=x0, **kw)
    straight_j = decomp_tpu.nmf.solve(y.numpy(), d0, x=x0, maxiter=iters,
                                      **kw)
    draws = _jax_batches(seed, chunk, batch, m)

    def port_solve(y, *, d, x, maxiter, tol, method, minibatch, forget,
                   random_seed):
        return tnmf._solve(y, _t(d), _t(x), None, None, rank=k, tol=tol,
                           maxiter=maxiter, method=method,
                           minibatch=minibatch, forget=forget,
                           batch_idx=convert.batch_indices(
                               draws[:maxiter], "cpu", m))

    rt, tt = checkpointed_solve(
        port_solve, y, manager=CheckpointManager(str(tmp_path / "port")),
        chunk_iters=chunk, maxiter=iters, d=d0, x=x0, **kw)
    assert tt == tj == iters and rt.niter == int(rj.niter) == chunk
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10
    assert rel_err(rt.x.numpy(), rj.x) < 1e-10
    # chunked differs from straight, in both packages alike
    assert rel_err(np.asarray(rj.d), straight_j.d) > 1e-2
    assert rel_err(rt.d.numpy(), straight_j.d) > 1e-2
