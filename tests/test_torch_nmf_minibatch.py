"""NMF's minibatch (online) variant in the PyTorch port against
``decomp_tpu``.

``jax.random`` and ``torch.Generator`` draw different rows, so the parity
tests compute ``decomp_tpu``'s draws (``nmf.py:446-451``: ``randint`` of
``fold_in(fold_in(PRNGKey(seed), 1), it)``) and pass them to the port's
private ``_solve(batch_idx=)`` through ``convert.batch_indices``; the
initial factors are passed to both. JAX runs its composition (minibatch
has no Pallas path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.utils import convert
from problems import planted_nmf, rel_err
from test_torch_nmf import _t

M, N, K, B = 60, 40, 5, 16


def _jax_batches(seed, maxiter, minibatch, m):
    """decomp_tpu's minibatch rows (decomp_tpu/models/nmf.py:446-451)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jnp.asarray(seed,
                                                            jnp.uint32)), 1)
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, it), (minibatch,), 0, m))
        for it in range(maxiter)])


def _problem(seed, dtype=np.float64, masked=False):
    y, *_ = planted_nmf(seed=seed, n_samples=M, n_channels=N, rank=K)
    rng = np.random.default_rng(seed + 1)
    x0 = rng.uniform(0.1, 1.0, (M, K))
    d0 = rng.uniform(0.1, 1.0, (K, N))
    mask = ((rng.random((M, N)) >= 0.3).astype(dtype) if masked else None)
    return y.astype(dtype), x0.astype(dtype), d0.astype(dtype), mask


def _port(y, x0, d0, mask, idx, **kw):
    return tnmf._solve(_t(y), _t(d0), _t(x0),
                       None if mask is None else _t(mask), None, rank=K,
                       batch_idx=convert.batch_indices(idx, "cpu", M), **kw)


# f64: the same products in other summation orders, 25 iterations: x and
# d to 1e-10 relative (Frobenius; measured <= 2.1e-15). f32: 1e-4
# (measured <= 1.2e-6). JAX's 25 draws of 16 of 60 rows hold repeated rows.
@pytest.mark.parametrize("dtype,lim", [(np.float64, 1e-10),
                                       (np.float32, 1e-4)])
@pytest.mark.parametrize("inner_iter", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
def test_matches_jax(method, masked, inner_iter, dtype, lim):
    y, x0, d0, mask = _problem(50, dtype, masked)
    iters = 25
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, tol=0.0,
                              maxiter=iters, method=method, minibatch=B,
                              inner_iter=inner_iter, forget=0.8,
                              random_seed=7, record_objective=True)
    idx = _jax_batches(7, iters, B, M)
    assert any(len(set(row)) < B for row in idx)
    rt = _port(y, x0, d0, mask, idx, method=method, tol=0.0, maxiter=iters,
               minibatch=B, inner_iter=inner_iter, forget=0.8,
               record_objective=True)
    assert rt.x.dtype == rt.d.dtype == torch.from_numpy(y).dtype
    assert rel_err(rt.x.numpy(), rj.x) < lim
    assert rel_err(rt.d.numpy(), rj.d) < lim
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=max(lim, 1e-12))


@pytest.mark.parametrize("tol", [1e-2, 3e-3])
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
def test_stop_rule_matches_jax(method, tol):
    """tol > 0 on d's relative change: equal niter and converged."""
    y, x0, d0, _ = _problem(51)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, tol=tol, maxiter=400,
                              method=method, minibatch=B, random_seed=2)
    idx = _jax_batches(2, 400, B, M)
    rt = _port(y, x0, d0, None, idx, method=method, tol=tol, maxiter=400,
               minibatch=B)
    assert rt.niter == int(rj.niter) < 400
    assert rt.converged == bool(rj.converged) is True
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10


def _reference(y, x0, d0, mask, idx, forget, eps=1e-15):
    """A plain numpy run of nmf.py:440-476's 'mu' step, writing each
    batch row's x in batch order (a repeated row is written twice, with
    equal values)."""
    x, d = x0.copy(), d0.copy()
    num, den = np.zeros_like(d), np.zeros_like(d)
    for rows in idx:
        yb = (y if mask is None else mask * y)[rows]
        xb = x[rows]
        recon_den = xb @ (d @ d.T) if mask is None else (
            mask[rows] * (xb @ d)) @ d.T
        xb = xb * (yb @ d.T) / (recon_den + eps)
        for r, row in zip(rows, xb):
            x[r] = row
        recon = xb @ d if mask is None else mask[rows] * (xb @ d)
        num = forget * num + xb.T @ yb
        den = forget * den + xb.T @ recon
        d = d * num / (den + eps)
    return x, d


@pytest.mark.parametrize("masked", [False, True])
def test_repeated_rows_write_back(masked):
    """A batch of one row drawn four times and others twice: the row's x
    is computed from the same inputs each time, so every copy in the
    batch carries the same bits, the statistics count each copy, and the
    write-back is the numpy reference's."""
    y, x0, d0, mask = _problem(52, masked=masked)
    idx = np.array([[3, 9, 3, 3, 11, 9, 3, 0],
                    [11, 11, 5, 5, 5, 2, 59, 59],
                    [0, 1, 2, 3, 4, 5, 6, 7]])
    rt = _port(y, x0, d0, mask, idx, method="mu", tol=0.0, maxiter=3,
               minibatch=8, forget=0.5)
    x_ref, d_ref = _reference(y, x0, d0, mask, idx, 0.5)
    assert rel_err(rt.x.numpy(), x_ref) < 1e-12
    assert rel_err(rt.d.numpy(), d_ref) < 1e-12
    untouched = sorted(set(range(M)) - set(idx.ravel()))
    assert np.array_equal(rt.x.numpy()[untouched], x0[untouched])
    # One batch's refreshed rows: the copies of a repeated row are equal.
    step = tnmf._minibatch_step(_t(y), None, "mu", torch.tensor(1e-15,
                                dtype=torch.float64), 1,
                                torch.tensor(0.5, dtype=torch.float64), 8,
                                None, convert.batch_indices(idx, "cpu"))
    x1 = step((_t(x0).clone(), _t(d0), torch.zeros(K, N, dtype=torch.float64),
               torch.zeros(K, N, dtype=torch.float64)), 0)[0]
    xb = tnmf._update_x(_t(y)[idx[0]], _t(x0)[idx[0]], _t(d0), None,
                        torch.tensor(1e-15, dtype=torch.float64))
    assert torch.equal(xb[0], xb[2]) and torch.equal(xb[0], xb[3])
    assert torch.equal(x1[3], xb[0]) and torch.equal(x1[9], xb[1])


@pytest.mark.parametrize("method", ["mu", "kl-mu"])
@pytest.mark.parametrize("masked", [False, True])
def test_seeded_draws_are_reproducible(method, masked):
    """The port's own draws (torch.Generator seeded with random_seed, after
    the initial factors): a rerun is bit-identical, another seed is not."""
    y, x0, d0, mask = _problem(53, masked=masked)
    kw = dict(x=_t(x0), tol=0.0, maxiter=20, method=method, minibatch=B,
              mask=None if mask is None else _t(mask))
    a = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), random_seed=4, **kw)
    b = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), random_seed=4, **kw)
    c = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), random_seed=5, **kw)
    assert torch.equal(a.x, b.x) and torch.equal(a.d, b.d)
    assert not torch.equal(a.d, c.d)
    for t in (a.x, a.d):
        assert bool(torch.isfinite(t).all()) and bool((t >= 0).all())


def test_seeded_run_reads_nothing_back(monkeypatch):
    """Draws, write-back and statistics stay on the device: at tol = 0 a
    seeded solve makes no host read."""
    y, _, _, mask = _problem(57, masked=True)

    def refuse(*args):
        raise AssertionError("host read of a tensor")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = decomp_tpu_torch.nmf.solve(_t(y), rank=K, mask=_t(mask), tol=0.0,
                                     maxiter=3, minibatch=B, inner_iter=2)
    monkeypatch.undo()
    assert res.niter == 3 and bool(torch.isfinite(res.d).all())


def test_seeded_run_lowers_the_objective():
    y, *_ = planted_nmf(seed=54, n_samples=400, n_channels=40, rank=K)
    res = decomp_tpu_torch.nmf.solve(_t(y), rank=K, tol=0.0, maxiter=200,
                                     minibatch=64, record_objective=True,
                                     random_seed=1)
    obj = res.objective.numpy()
    assert obj[-1] < 0.1 * obj[0]


def test_caller_factors_are_not_written():
    y, x0, d0, _ = _problem(55)
    xt, dt = _t(x0), _t(d0)
    decomp_tpu_torch.nmf.solve(_t(y), dt, x=xt, tol=0.0, maxiter=5,
                               minibatch=B)
    assert torch.equal(xt, _t(x0)) and torch.equal(dt, _t(d0))


def test_batch_indices_checks():
    assert convert.batch_indices(np.array([[1, 2]], np.int32),
                                 "cpu").dtype == torch.int64
    with pytest.raises(ValueError):
        convert.batch_indices(np.array([1, 2]), "cpu")
    with pytest.raises(ValueError):
        convert.batch_indices(np.array([[0.5]]), "cpu")
    with pytest.raises(ValueError):
        convert.batch_indices(np.array([[0, 60]]), "cpu", 60)


# decomp_tpu/models/nmf.py:183-185, :207-212, :252-253, :271-273 and
# :284-286, by exception type against JAX (use_pallas=True on the JAX side
# where the port says use_kernel=True).
@pytest.mark.parametrize("kw", [
    dict(minibatch=0),
    dict(minibatch=M + 1),
    dict(minibatch=-3),
    dict(minibatch=4, factor_dtype="wide"),
    dict(minibatch=4, use_kernel=True),
    dict(minibatch=4, stop="heldout", mask="m"),
    dict(minibatch=4, method="hals"),
    dict(minibatch=4, method="kl-mu", use_kernel=True),
])
def test_refusals_match_jax_types(kw):
    y, _, _, mask = _problem(56, np.float32, masked=True)
    jkw, tkw = dict(rank=2), dict(rank=2)
    for k, v in kw.items():
        if v == "m":
            jkw[k], tkw[k] = mask, _t(mask)
        elif v == "wide":
            jkw[k], tkw[k] = jnp.float64, torch.float64
        elif k == "use_kernel":
            jkw["use_pallas"], tkw[k] = v, v
        else:
            jkw[k] = tkw[k] = v
    with pytest.raises(Exception) as ej:
        decomp_tpu.nmf.solve(y, **jkw)
    with pytest.raises(Exception) as et:
        decomp_tpu_torch.nmf.solve(_t(y), **tkw)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert isinstance(et.value, decomp_tpu_torch.utils.DecompError)
