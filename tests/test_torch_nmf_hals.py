"""NMF's HALS method in the PyTorch port against ``decomp_tpu``.

The same numpy inputs, made from a seed, go through
``decomp_tpu.nmf.solve(method='hals')`` (its composition: HALS has no
Pallas kernel) and ``decomp_tpu_torch.nmf.solve(method='hals')`` on CPU
tensors. Seeded initial factors differ between the packages, so every
parity test passes ``x`` and ``d`` in."""

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


def _start(seed, m, n, k, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, k)).astype(dtype),
            rng.uniform(0.1, 1.0, (k, n)).astype(dtype))


def _both(y, x0, d0, **kw):
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, method="hals", **kw)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), method="hals",
                                    **kw)
    return rj, rt


# f64: the same sweeps with products summed in other orders: x and d to
# 1e-10 relative (Frobenius) over 30 iterations (measured ~5e-15), and the
# objective curve under tests/test_nmf.py:280-293's rtol / atol.
@pytest.mark.parametrize("inner_iter", [1, 2])
def test_trajectory_matches_jax_f64(inner_iter):
    y, *_ = planted_nmf(seed=31)
    x0, d0 = _start(32, y.shape[0], y.shape[1], 5)
    rj, rt = _both(y, x0, d0, tol=0.0, maxiter=30, inner_iter=inner_iter,
                   record_objective=True)
    assert rt.x.dtype == rt.d.dtype == torch.float64
    assert rt.x.is_contiguous()
    assert rt.niter == int(rj.niter) == 30
    assert rel_err(rt.x.numpy(), rj.x) < 1e-10
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10
    objs = np.asarray(rj.objective)
    np.testing.assert_allclose(rt.objective.numpy(), objs, rtol=1e-6,
                               atol=1e-9 * max(objs[0], 1.0))
    assert objs[-1] < objs[0]


# f32: products summed in other orders, 30 iterations on planted rank-5
# data: 1e-4 relative (measured 2.6e-6).
def test_trajectory_matches_jax_f32():
    y, *_ = planted_nmf(seed=41, n_samples=80, n_channels=50, rank=5)
    y = y.astype(np.float32)
    x0, d0 = _start(42, 80, 50, 5, np.float32)
    rj, rt = _both(y, x0, d0, tol=0.0, maxiter=30)
    assert rt.x.dtype == rt.d.dtype == torch.float32
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


@pytest.mark.parametrize("tol,check_every", [(1e-3, 1), (1e-4, 1), (2e-3, 5)])
def test_stop_rule_matches_jax(tol, check_every):
    y, *_ = planted_nmf(seed=33, noise=0.02)
    x0, d0 = _start(34, y.shape[0], y.shape[1], 5)
    rj, rt = _both(y, x0, d0, tol=tol, maxiter=2000,
                   check_every=check_every)
    assert rt.niter == int(rj.niter) < 2000
    assert rt.converged == bool(rj.converged) is True
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10


def test_warm_start_continues_jax_trajectory():
    """A JAX result carried over continues as JAX's own warm start does."""
    y, *_ = planted_nmf(seed=35)
    x0, d0 = _start(36, y.shape[0], y.shape[1], 5)
    first = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=15,
                                 method="hals")
    rj = decomp_tpu.nmf.solve(y, first.d, x=first.x, tol=0.0, maxiter=15,
                              method="hals")
    warm = convert.from_numpy(first, "cpu")
    rt = decomp_tpu_torch.nmf.solve(_t(y), warm.d, x=warm.x, tol=0.0,
                                    maxiter=15, method="hals")
    straight = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=30,
                                    method="hals")
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10
    assert rel_err(rt.x.numpy(), straight.x) < 1e-10
    # The caller's warm start is not written to.
    assert torch.equal(warm.x, _t(np.asarray(first.x)))


def test_overcomplete_rank_stays_finite_and_matches_jax():
    """tests/test_edge_cases.py:95-104's case with both packages started
    from the same factors: rank 16 on rank-2 data, f32, 3000 iterations.
    Near-dead components meet the relative floor; nothing blows up, and
    the reconstructions agree to 1e-4 relative (measured 1.3e-6; the
    factors of a non-unique factorisation drift further apart, 5e-4)."""
    y, *_ = planted_nmf(seed=57, n_samples=60, n_channels=30, rank=2)
    y = y.astype(np.float32)
    x0, d0 = _start(58, 60, 30, 16, np.float32)
    rj, rt = _both(y, x0, d0, tol=0.0, maxiter=3000)
    for t in (rt.x, rt.d):
        assert bool(torch.isfinite(t).all()) and bool((t >= 0).all())
    recon_t = rt.x.double().numpy() @ rt.d.double().numpy()
    recon_j = np.asarray(rj.x, np.float64) @ np.asarray(rj.d, np.float64)
    assert rel_err(recon_t, y) < 0.05
    assert rel_err(recon_t, recon_j) < 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dead_component_keeps_its_value(dtype):
    """A component that is zero in both x and d has a zero Gram diagonal,
    at or below the floor eps * trace: both packages keep it exactly zero
    while the others move, and agree (f64 to 1e-10, f32 to 1e-4: measured
    3.9e-15 and 4.3e-6)."""
    y, *_ = planted_nmf(seed=37)
    y = y.astype(dtype)
    x0, d0 = _start(38, y.shape[0], y.shape[1], 5, dtype)
    x0[:, 2] = 0.0
    d0[2] = 0.0
    rj, rt = _both(y, x0, d0, tol=0.0, maxiter=30)
    assert not rt.x[:, 2].any() and not rt.d[2].any()
    assert not np.asarray(rj.x)[:, 2].any()
    lim = 1e-10 if dtype == np.float64 else 1e-4
    assert rel_err(rt.x.numpy(), rj.x) < lim
    assert rel_err(rt.d.numpy(), rj.d) < lim


def test_sweep_reads_nothing_back(monkeypatch):
    """The component loop stays on the device: at tol = 0 a solve makes
    no host read (no .item(), bool() or float() of a tensor)."""
    y, *_ = planted_nmf(seed=39)
    x0, d0 = _start(40, y.shape[0], y.shape[1], 5)

    def refuse(*args):
        raise AssertionError("host read of a tensor")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), tol=0.0,
                                     maxiter=3, method="hals",
                                     inner_iter=2)
    monkeypatch.undo()
    assert res.niter == 3 and bool(torch.isfinite(res.d).all())


def test_seeded_start_is_reproducible():
    y, *_ = planted_nmf(seed=43)
    a = decomp_tpu_torch.nmf.solve(_t(y), rank=4, tol=0.0, maxiter=10,
                                   method="hals", random_seed=3)
    b = decomp_tpu_torch.nmf.solve(_t(y), rank=4, tol=0.0, maxiter=10,
                                   method="hals", random_seed=3)
    assert torch.equal(a.x, b.x) and torch.equal(a.d, b.d)


# decomp_tpu/models/nmf.py:180-182, :254-259, :269-273, :281-283: every
# refusal HALS meets, by exception type against JAX (use_pallas=True on
# the JAX side where the port says use_kernel=True).
@pytest.mark.parametrize("kw", [
    dict(mask="m"),
    dict(minibatch=4),
    dict(factor_dtype="wide"),
    dict(stop="heldout", mask="m"),
    dict(use_kernel=True),
])
def test_refusals_match_jax_types(kw):
    y, *_ = planted_nmf(seed=44, n_samples=16, n_channels=8)
    y = y.astype(np.float32)
    mask = (np.random.default_rng(45).random(y.shape) > 0.3).astype(
        np.float32)
    jkw, tkw = dict(method="hals", rank=2), dict(method="hals", rank=2)
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


def test_auto_takes_no_kernel():
    """use_kernel='auto' runs HALS's composition (on the CPU it would be
    False anyway; here the CUDA gate is asked directly)."""
    y, *_ = planted_nmf(seed=46)
    x0, d0 = _start(47, y.shape[0], y.shape[1], 5)
    calls = []
    orig = tnmf._kernel_step
    tnmf._kernel_step = lambda *a, **k: calls.append(a) or orig(*a, **k)
    try:
        decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), tol=0.0,
                                   maxiter=2, method="hals")
    finally:
        tnmf._kernel_step = orig
    assert calls == []


# bf16 data and factors against the f32 run from the same start: bf16's
# rounding (eps 7.8e-3) enters every product and update, in other places
# in the two packages (the port's addmv / addcdiv round once, JAX's bf16
# elementwise steps at each), so neither follows the other; each stays
# within a bf16 bound of the f32 trajectory. Measured on this problem:
# <= 1.3e-2 after 1 iteration and <= 5.7e-2 after 20 (d and x, both
# packages); the limits are 2.5e-2 and 1.5e-1.
@pytest.mark.parametrize("iters,lim", [(1, 2.5e-2), (20, 1.5e-1)])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_bf16_stays_within_a_bf16_bound_of_f32(package, iters, lim):
    y, *_ = planted_nmf(seed=51)
    x0, d0 = _start(52, y.shape[0], y.shape[1], 5, np.float32)
    y = y.astype(np.float32)
    ref = decomp_tpu.nmf.solve(y, d0, x=x0, method="hals", tol=0.0,
                               maxiter=iters)
    if package == "jax":
        r = decomp_tpu.nmf.solve(
            *(jnp.asarray(a, jnp.bfloat16) for a in (y, d0)),
            x=jnp.asarray(x0, jnp.bfloat16), method="hals", tol=0.0,
            maxiter=iters)
        assert r.d.dtype == jnp.bfloat16
        x, d = (np.asarray(jnp.asarray(a, jnp.float32)) for a in (r.x, r.d))
    else:
        r = decomp_tpu_torch.nmf.solve(
            *(_t(a, torch.bfloat16) for a in (y, d0)),
            x=_t(x0, torch.bfloat16), method="hals", tol=0.0, maxiter=iters)
        assert r.d.dtype == torch.bfloat16 and r.niter == iters
        x, d = r.x.float().numpy(), r.d.float().numpy()
    assert rel_err(d, ref.d) < lim
    assert rel_err(x, ref.x) < lim
