"""KL-divergence MU-NMF (``method='kl-mu'``) in the PyTorch port against
``decomp_tpu``.

The same numpy inputs, made from a seed, go through both packages: the
dense and masked KL Pallas kernels (interpret mode on CPU) against the
port's ``kl_stats_dense`` / ``kl_stats_masked`` (their plain twins on
CPU), and ``solve(method='kl-mu')`` end to end on both paths, with and
without a mask. Parity tests pass ``x`` and ``d`` in."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_mu
from problems import planted_nmf, random_mask, rel_err
from test_torch_masked import _masked_arrs
from test_torch_nmf import _bf16_np, _t


def _args(masked, my, mask, x, d, conv):
    return ((conv(my), conv(mask), conv(x), conv(d)) if masked
            else (conv(my), conv(x), conv(d)))


# f64: the Pallas kernels form the ratio, x_new and the statistics in f32
# even for f64 data (pallas_mu.py:294-317, :341-367), and the twins mirror
# those casts, so both agree to f32 summation order: 1e-6 relative.
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m,jax_rows,port_rows", [
    (64, 32, 32),
    (64, 16, 24),      # ragged last chunk on the port side
    (72, 8, 16),       # M not a multiple of the port's chunk
    (72, 24, None),
])
def test_twin_matches_pallas_f64(masked, m, jax_rows, port_rows):
    name = "kl_update_masked" if masked else "kl_update_dense"
    arrs = _masked_arrs(m + 1, m, 256, 128)
    xj, dj = getattr(pallas_mu, name)(*_args(masked, *arrs, jnp.asarray),
                                      1e-15, block_rows=jax_rows,
                                      interpret=True)
    xt, dt = getattr(cuda_mu, name)(*_args(masked, *arrs, _t), 1e-15,
                                    block_rows=port_rows)
    assert xt.dtype == dt.dtype == torch.float64
    assert rel_err(xt.numpy(), xj) < 1e-6
    assert rel_err(dt.numpy(), dj) < 1e-6


# bf16 data, mask and d with f32 x: the same bf16 quantisation of the
# operands and of the ratio, f32 sums in another order. x_new (f32):
# 1e-5 relative (Frobenius). The statistics take cdt(x_new) and the bf16
# ratio, where an ulp-level difference of the f32 values can flip one bf16
# rounding (2^-8 of one entry): one flip moved numd by 1.95e-5 and dend by
# 5.6e-6 at this shape (seed 12 of _masked_arrs), so their limit is 1e-4.
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [12, 14])
def test_twin_matches_pallas_mixed(masked, seed):
    name = "kl_stats_masked" if masked else "kl_stats_dense"
    my, mask, x, d = _masked_arrs(seed, 72, 256, 128)
    my, d, x = _bf16_np(my), _bf16_np(d), x.astype(np.float32)
    jb = lambda a: jnp.asarray(a, jnp.float32 if a is x else jnp.bfloat16)
    tb = lambda a: _t(a, torch.float32 if a is x else torch.bfloat16)
    sj = getattr(pallas_mu, name)(*_args(masked, my, mask, x, d, jb), 1e-6,
                                  block_rows=24, interpret=True)
    st = getattr(cuda_mu, name)(*_args(masked, my, mask, x, d, tb), 1e-6,
                                block_rows=16)
    for a, b, limit in zip(st, sj, (1e-5, 1e-4, 1e-4)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_err(a.numpy(), b) < limit


@pytest.mark.parametrize("rows", [8, 16, 40, 1000])
@pytest.mark.parametrize("masked", [False, True])
def test_twin_chunking_is_invisible(rows, masked):
    """The twins' row chunk only bounds their f32 temporaries."""
    fn = (cuda_mu.kl_stats_masked_plain if masked
          else cuda_mu.kl_stats_dense_plain)
    args = _args(masked, *_masked_arrs(5, 40, 30, 6), _t)
    ref = fn(*args, 1e-12, block_rows=40)
    got = fn(*args, 1e-12, block_rows=rows)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_xsum_sums_the_f32_iterate():
    """xsum is the column sum of the f32 x_new, not of the stored one
    (pallas_mu.py:317): with bf16 x the two differ."""
    my, _, x, d = _masked_arrs(13, 40, 30, 6)
    my, x, d = (_t(_bf16_np(a), torch.bfloat16) for a in (my, x, d))
    x_new, _, xsum = cuda_mu.kl_stats_dense(my, x, d, 1e-6)
    assert x_new.dtype == torch.bfloat16 and xsum.shape == (1, 6)
    stored = x_new.float().sum(0)
    assert not torch.equal(xsum[0], stored)
    assert rel_err(xsum[0].numpy(), stored.numpy()) < 1e-2


def _problem(seed=1, m=60, n=40, k=5):
    y, *_ = planted_nmf(seed=seed, n_samples=m, n_channels=n, rank=k)
    mask = random_mask(seed + 50, y.shape)
    rng = np.random.default_rng(seed + 100)
    return y, mask, rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("check_every", [1, 4])
def test_solve_composition_matches_jax_f64(masked, check_every):
    y, mask, x0, d0 = _problem()
    kw = dict(tol=1e-4, maxiter=3000, method="kl-mu",
              check_every=check_every)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask if masked else None,
                              use_pallas=False, **kw)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0),
                                    mask=_t(mask) if masked else None,
                                    use_kernel=False, **kw)
    assert bool(rj.converged) and rt.converged
    assert rt.niter == int(rj.niter)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-10
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10


@pytest.mark.parametrize("masked", [False, True])
def test_solve_objective_curve_matches_jax(masked):
    y, mask, x0, d0 = _problem(seed=2)
    kw = dict(tol=1e-3, maxiter=200, method="kl-mu", record_objective=True)
    m = mask if masked else None
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=m, use_pallas=False, **kw)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0),
                                    mask=None if m is None else _t(m),
                                    use_kernel=False, **kw)
    oj, ot = np.asarray(rj.objective), rt.objective.numpy()
    assert rt.niter == int(rj.niter) and ot.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(ot), np.isnan(oj))
    np.testing.assert_allclose(ot[:rt.niter], oj[:rt.niter], rtol=1e-10)
    assert np.all(np.diff(ot[:rt.niter]) <= 1e-12 * ot[0])


@pytest.mark.parametrize("masked", [False, True])
def test_solve_kernel_path_matches_jax_pallas(masked):
    """f32 through the kernel path (the twin on CPU) against the KL Pallas
    kernels in interpret mode, 15 fixed iterations: 1e-4 (as
    tests/test_pallas.py)."""
    y, mask, x0, d0 = (a.astype(np.float32)
                       for a in _problem(seed=5, m=70, n=50, k=4))
    m = mask if masked else None
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=m, tol=0.0, maxiter=15,
                              method="kl-mu", use_pallas=True,
                              pallas_block_rows=16, _pallas_interpret=True)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0),
                                    mask=None if m is None else _t(m),
                                    tol=0.0, maxiter=15, method="kl-mu",
                                    use_kernel=True, kernel_block_rows=16)
    assert rt.niter == 15 and not rt.converged
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def _mixed_pair(masked, maxiter):
    y, mask, x0, d0 = _problem(seed=3, m=48, n=40, k=4)
    yb = _bf16_np(y)
    x0, d0 = x0.astype(np.float32), d0.astype(np.float32)
    m = mask if masked else None
    kw = dict(tol=0.0, maxiter=maxiter, method="kl-mu", eps=1e-6,
              precision="default")
    rj = decomp_tpu.nmf.solve(jnp.asarray(yb, jnp.bfloat16), d0, x=x0,
                              mask=m, use_pallas=False,
                              factor_dtype=jnp.float32, **kw)
    rt = decomp_tpu_torch.nmf.solve(_t(yb, torch.bfloat16), _t(d0), x=_t(x0),
                                    mask=None if m is None else _t(m),
                                    factor_dtype=torch.float32, **kw)
    assert rt.x.dtype == rt.d.dtype == torch.float32
    return yb, m, rj, rt


def test_solve_mixed_matches_jax_masked():
    """Masked KL, bf16 data with f32 factors (the composition path: the KL
    kernels take factors in the data's dtype only) against the JAX
    composition path in the same mode, 15 iterations: 1e-4."""
    _, _, rj, rt = _mixed_pair(True, 15)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_solve_mixed_matches_jax_dense():
    """Dense KL in the same mode. Its denominators are plain f32 sums
    (row sums of d, column sums of x), which torch and XLA add in other
    orders (1 ulp). Each iteration then flips a few bf16 roundings of the
    ratio, and the trajectories separate to the ratio's bf16 level
    (measured: 1e-7 after one iteration, 1.3e-3 after 15). So one
    iteration is held at 1e-6, and after 15 the KL objective (which the
    flips do not move) at 1e-4 and the factors at the bf16 level, 1e-2."""
    _, _, rj, rt = _mixed_pair(False, 1)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-6
    assert rel_err(rt.d.numpy(), rj.d) < 1e-6
    yb, _, rj, rt = _mixed_pair(False, 15)
    eps = torch.tensor(1e-6, dtype=torch.float32)
    obj_t = float(tnmf._kl_objective(_t(yb, torch.bfloat16), rt.x, rt.d,
                                     None, eps))
    obj_j = float(tnmf._kl_objective(_t(yb, torch.bfloat16), _t(rj.x),
                                     _t(rj.d), None, eps))
    assert obj_t == pytest.approx(obj_j, rel=1e-4)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-2
    assert rel_err(rt.d.numpy(), rj.d) < 1e-2


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_and_composition_paths_agree(masked):
    y, mask, x0, d0 = _problem(seed=8)
    kw = dict(x=_t(x0), mask=_t(mask) if masked else None, tol=0.0,
              maxiter=20, method="kl-mu")
    a = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), use_kernel=True, **kw)
    b = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), use_kernel=False, **kw)
    assert rel_err(a.x.numpy(), b.x.numpy()) < 1e-6
    assert rel_err(a.d.numpy(), b.d.numpy()) < 1e-6


def test_auto_is_the_composition_on_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel path taken on CPU under 'auto'")

    for name in ("kl_stats_dense", "kl_stats_masked", "mu_stats_masked"):
        monkeypatch.setattr(cuda_mu, name, boom)
    y, mask, x0, d0 = _problem(seed=6)
    for method in ("mu", "kl-mu"):
        res = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0),
                                         mask=_t(mask), tol=0.0, maxiter=3,
                                         method=method)
        assert res.niter == 3


def test_kl_objective_matches_jax():
    import decomp_tpu.models.nmf as jnmf

    y, mask, x0, d0 = _problem(seed=9)
    for m in (None, mask):
        want = float(jnmf._kl_objective(jnp.asarray(y), jnp.asarray(x0),
                                        jnp.asarray(d0), m, 1e-15))
        got = float(tnmf._kl_objective(_t(y), _t(x0), _t(d0),
                                       None if m is None else _t(m),
                                       torch.tensor(1e-15,
                                                    dtype=torch.float64)))
        assert got == pytest.approx(want, rel=1e-12)


def test_planted_kl_solve_lowers_the_objective():
    y, *_ = planted_nmf(seed=11, n_samples=80, n_channels=60, rank=5)
    yt = _t(y.astype(np.float32))
    res = decomp_tpu_torch.nmf.solve(yt, rank=5, tol=0.0, maxiter=300,
                                     method="kl-mu", record_objective=True)
    obj = res.objective.numpy()
    assert obj[-1] < 0.05 * obj[0]
    err = float(torch.linalg.norm(yt - res.x @ res.d) / torch.linalg.norm(yt))
    assert err < 5e-2
