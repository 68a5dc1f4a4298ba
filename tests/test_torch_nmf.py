"""Dense MU-NMF in the PyTorch port against ``decomp_tpu``.

The same numpy inputs, made from a seed, go through the JAX function and
its port: the Pallas kernel (interpret mode on CPU) against the port's
``mu_stats_dense`` (its plain twin on CPU), and ``solve`` end to end on
both paths. Seeded initial factors differ between the packages
(``jax.random`` vs ``torch.Generator``), so every parity test passes
``x`` and ``d`` in."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import convert
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_nmf, rel_err


def _arrs(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1, (m, n)), rng.uniform(0.1, 1, (m, k)),
            rng.uniform(0.1, 1, (k, n)))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16_np(a):
    """Round to bf16 (numpy's f32 holds every bf16 exactly)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# f64: the Pallas kernel forms x_new and its statistics in f32 even for
# f64 data (pallas_mu.py:191, :488-489), and the twin mirrors those
# casts, so both agree to f32 summation order: 1e-6 relative.
@pytest.mark.parametrize("m,jax_rows,port_rows,inner", [
    (64, 32, 32, 1),
    (64, 16, 24, 3),      # ragged last chunk on the port side
    (72, 8, 16, 1),       # M not a multiple of the port's chunk
    (72, 24, None, 3),
])
def test_twin_matches_pallas_f64(m, jax_rows, port_rows, inner):
    y, x, d = _arrs(m, m, 256, 128)
    xj, dj = pallas_mu.mu_update_dense(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(d), 1e-15,
        block_rows=jax_rows, interpret=True, inner_iter=inner)
    xt, dt = cuda_mu.mu_update_dense(_t(y), _t(x), _t(d), 1e-15,
                                     block_rows=port_rows, inner_iter=inner)
    assert xt.dtype == dt.dtype == torch.float64
    assert rel_err(xt.numpy(), xj) < 1e-6
    assert rel_err(dt.numpy(), dj) < 1e-6


# Mixed mode: bf16 y and d, f32 x and d_master. The same bf16 operand
# quantisation and f32 sums in another order: measured ~4e-7 here, so
# 1e-5 relative (Frobenius).
@pytest.mark.parametrize("inner", [1, 3])
def test_twin_matches_pallas_mixed(inner):
    y, x, d = _arrs(10 + inner, 64, 256, 128)
    yb, x32, d32 = _bf16_np(y), x.astype(np.float32), d.astype(np.float32)
    xj, dj = pallas_mu.mu_update_dense(
        jnp.asarray(yb, jnp.bfloat16), jnp.asarray(x32),
        jnp.asarray(d32, jnp.bfloat16), 1e-6, block_rows=16,
        interpret=True, inner_iter=inner, d_master=jnp.asarray(d32))
    xt, dt = cuda_mu.mu_update_dense(
        _t(yb, torch.bfloat16), _t(x32), _t(d32, torch.bfloat16), 1e-6,
        block_rows=24, d_master=_t(d32), inner_iter=inner)
    assert xt.dtype == dt.dtype == torch.float32
    assert rel_err(xt.numpy(), xj) < 1e-5
    assert rel_err(dt.numpy(), dj) < 1e-5


def test_twin_needs_no_padding():
    """The port takes ragged M, N and K as they are; the JAX kernel needs
    them padded, and zero padding is a fixed point of MU, so the two
    agree on the unpadded block."""
    m, n, k = 50, 200, 100
    y, x, d = _arrs(3, m, n, k)
    pad = lambda a, r, c: np.pad(a, ((0, r - a.shape[0]), (0, c - a.shape[1])))
    xj, dj = pallas_mu.mu_update_dense(
        jnp.asarray(pad(y, 56, 256)), jnp.asarray(pad(x, 56, 128)),
        jnp.asarray(pad(d, 128, 256)), 1e-15, block_rows=8, interpret=True)
    xt, dt = cuda_mu.mu_update_dense(_t(y), _t(x), _t(d), 1e-15)
    assert rel_err(xt.numpy(), np.asarray(xj)[:m, :k]) < 1e-6
    assert rel_err(dt.numpy(), np.asarray(dj)[:k, :n]) < 1e-6


def test_stats_outputs_and_dtypes():
    y, x, d = _arrs(4, 40, 30, 6)
    xn, numd, gram = cuda_mu.mu_stats_dense(_t(y, torch.bfloat16),
                                            _t(x, torch.float32),
                                            _t(d, torch.bfloat16), 1e-6)
    assert xn.shape == (40, 6) and xn.dtype == torch.float32
    assert numd.shape == (6, 30) and numd.dtype == torch.float32
    assert gram.shape == (6, 6) and gram.dtype == torch.float32
    xc = xn.to(torch.bfloat16).float()
    np.testing.assert_allclose(gram.numpy(), (xc.T @ xc).numpy(), rtol=1e-5)


@pytest.mark.parametrize("rows", [8, 16, 40, 1000])
def test_twin_chunking_is_invisible(rows):
    """The twin's row chunk only bounds its f32 temporaries."""
    y, x, d = _arrs(5, 40, 30, 6)
    ref = cuda_mu.mu_stats_dense_plain(_t(y), _t(x), _t(d), 1e-12,
                                       block_rows=40)
    got = cuda_mu.mu_stats_dense_plain(_t(y), _t(x), _t(d), 1e-12,
                                       block_rows=rows)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_cpu_wrapper_is_the_twin_and_does_not_count():
    y, x, d = _arrs(6, 20, 16, 4)
    before = cuda_mu.mu_stats_dense.launches
    got = cuda_mu.mu_stats_dense(_t(y), _t(x), _t(d), 1e-12)
    ref = cuda_mu.mu_stats_dense_plain(_t(y), _t(x), _t(d), 1e-12)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert cuda_mu.mu_stats_dense.launches == before


def test_wrapper_refuses_devices_without_kernel():
    y = torch.empty((4, 4), device="meta")
    with pytest.raises(texc.DecompError):
        cuda_mu.mu_stats_dense(y, torch.empty((4, 2), device="meta"),
                               torch.empty((2, 4), device="meta"), 1e-6)


@pytest.mark.parametrize("ydt,xdt,ddt_,k,exc", [
    (torch.float64, torch.float64, torch.float64, 4, texc.DtypeError),
    (torch.bfloat16, torch.float64, torch.bfloat16, 4, texc.DtypeError),
    (torch.float32, torch.bfloat16, torch.float32, 4, texc.DtypeError),
    (torch.bfloat16, torch.float32, torch.float32, 4, texc.DtypeError),
    (torch.float32, torch.float32, torch.float32, 129, texc.ShapeError),
])
def test_kernel_argument_checks(ydt, xdt, ddt_, k, exc):
    """What the CUDA kernel does not take is refused before any launch
    (checked here on CPU tensors; the checks do not look at the device
    type)."""
    y = torch.zeros((16, 8), dtype=ydt)
    with pytest.raises(exc):
        cuda_mu._check_kernel_args(y, torch.zeros((16, k), dtype=xdt),
                                   torch.zeros((k, 8), dtype=ddt_), 1, 256)


def test_kernel_argument_checks_shape_and_layout():
    y = torch.zeros((16, 8))
    with pytest.raises(texc.ShapeError):
        cuda_mu._check_kernel_args(y, torch.zeros((15, 4)),
                                   torch.zeros((4, 8)), 1, 256)
    with pytest.raises(texc.DecompError):
        cuda_mu._check_kernel_args(y, torch.zeros((4, 16)).T,
                                   torch.zeros((4, 8)), 1, 256)
    cuda_mu._check_kernel_args(y, torch.zeros((16, 4)), torch.zeros((4, 8)),
                               1, 256)


@pytest.mark.parametrize("bad", [0, 4, 12, -8, 8.0, True, "16"])
def test_validate_block_rows(bad):
    with pytest.raises(texc.DecompError):
        cuda_mu.validate_block_rows(bad)


@pytest.mark.parametrize("m,rows", [(1000, 256), (65536, 512),
                                    (1 << 20, 8192), (1048577, 8224)])
def test_default_block_rows(m, rows):
    assert cuda_mu.default_block_rows(m) == rows


def _planted(seed=1, m=60, n=40, k=5):
    y, *_ = planted_nmf(seed=seed, n_samples=m, n_channels=n, rank=k)
    rng = np.random.default_rng(seed + 100)
    return y, rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n))


@pytest.mark.parametrize("check_every,inner", [(1, 1), (4, 1), (1, 3)])
def test_solve_composition_matches_jax_f64(check_every, inner):
    y, x0, d0 = _planted()
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, tol=1e-5, maxiter=3000,
                              use_pallas=False, check_every=check_every,
                              inner_iter=inner)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), tol=1e-5,
                                    maxiter=3000, use_kernel=False,
                                    check_every=check_every,
                                    inner_iter=inner)
    assert bool(rj.converged) and rt.converged
    assert rt.niter == int(rj.niter)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-10
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10


def test_solve_objective_curve_matches_jax():
    y, x0, d0 = _planted(seed=2)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, tol=1e-3, maxiter=200,
                              use_pallas=False, record_objective=True)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), tol=1e-3,
                                    maxiter=200, use_kernel=False,
                                    record_objective=True)
    oj, ot = np.asarray(rj.objective), rt.objective.numpy()
    assert ot.shape == (200,) and ot.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(ot), np.isnan(oj))
    np.testing.assert_allclose(ot[:rt.niter], oj[:rt.niter], rtol=1e-10)
    assert np.all(np.diff(ot[:rt.niter]) <= 0)  # MU never increases it


def test_solve_kernel_path_matches_jax_pallas():
    """f32 through the kernel path (the twin on CPU) against the Pallas
    kernel in interpret mode, 15 fixed iterations (tolerance as in
    tests/test_pallas.py)."""
    y, *_ = planted_nmf(seed=5, n_samples=70, n_channels=50, rank=4)
    y = y.astype(np.float32)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(0.1, 1.0, (70, 4)).astype(np.float32)
    d0 = rng.uniform(0.1, 1.0, (4, 50)).astype(np.float32)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=15,
                              use_pallas=True, pallas_block_rows=16,
                              _pallas_interpret=True)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), tol=0.0,
                                    maxiter=15, use_kernel=True,
                                    kernel_block_rows=16)
    assert rt.niter == 15 and not rt.converged
    assert rt.x.shape == (70, 4) and rt.d.shape == (4, 50)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_mixed_matches_jax(use_kernel):
    """bf16 data with f32 factors, on both of the port's paths, against
    the JAX composition path in the same mode."""
    y, x0, d0 = _planted(seed=3, m=48, n=40, k=4)
    yb = _bf16_np(y)
    x0, d0 = x0.astype(np.float32), d0.astype(np.float32)
    rj = decomp_tpu.nmf.solve(jnp.asarray(yb, jnp.bfloat16), d0, x=x0,
                              tol=0.0, maxiter=15, use_pallas=False,
                              eps=1e-6, precision="default",
                              factor_dtype=jnp.float32)
    rt = decomp_tpu_torch.nmf.solve(_t(yb, torch.bfloat16), _t(d0),
                                    x=_t(x0), tol=0.0, maxiter=15, eps=1e-6,
                                    precision="default",
                                    factor_dtype=torch.float32,
                                    use_kernel=use_kernel)
    assert rt.x.dtype == rt.d.dtype == torch.float32
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_state_carries_from_jax_to_port():
    """10 JAX iterations, handed over through utils.convert, then 10 port
    iterations equal 20 JAX iterations."""
    y, x0, d0 = _planted(seed=4)
    r10 = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=10,
                               use_pallas=False)
    r20 = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=20,
                               use_pallas=False)
    warm = convert.from_numpy(r10, "cpu")
    rt = decomp_tpu_torch.nmf.solve(_t(y), warm.d, x=warm.x, tol=0.0,
                                    maxiter=10, use_kernel=False)
    assert rel_err(rt.x.numpy(), r20.x) < 1e-10
    assert rel_err(rt.d.numpy(), r20.d) < 1e-10
    back = convert.to_numpy(rt)
    assert rel_err(back.d, r20.d) < 1e-10


def test_auto_is_the_composition_on_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel path taken on CPU under 'auto'")

    monkeypatch.setattr(cuda_mu, "mu_stats_dense", boom)
    y, x0, d0 = _planted(seed=6)
    res = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), tol=0.0,
                                     maxiter=3)
    assert res.niter == 3


def test_kernel_and_composition_paths_agree():
    y, x0, d0 = _planted(seed=8)
    kw = dict(x=_t(x0), tol=0.0, maxiter=20, inner_iter=2)
    a = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), use_kernel=True, **kw)
    b = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), use_kernel=False, **kw)
    assert rel_err(a.x.numpy(), b.x.numpy()) < 1e-6
    assert rel_err(a.d.numpy(), b.d.numpy()) < 1e-6


def test_seeded_init_is_reproducible_and_nonnegative():
    y, *_ = _planted(seed=9)
    yt = _t(y)
    a = decomp_tpu_torch.nmf.solve(yt, rank=5, tol=0.0, maxiter=1)
    b = decomp_tpu_torch.nmf.solve(yt, rank=5, tol=0.0, maxiter=1)
    c = decomp_tpu_torch.nmf.solve(yt, rank=5, tol=0.0, maxiter=1,
                                   random_seed=1)
    assert torch.equal(a.d, b.d) and not torch.equal(a.d, c.d)
    gen = torch.Generator().manual_seed(0)
    d0, x0 = tnmf._init_factors(gen, yt, None, None, 5)
    assert bool((d0 >= 0).all()) and bool((x0 >= 0).all())
    # scale = sqrt(2 mean(y) / rank) with uniform draws: E[x@d] = mean(y)/2,
    # as in decomp_tpu's _init_factors.
    assert float((x0 @ d0).mean()) == pytest.approx(float(yt.mean()) / 2,
                                                    rel=0.3)


def test_init_mean_accumulates_wide_for_bf16():
    y = torch.full((64, 32), 0.75, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    d0, x0 = tnmf._init_factors(gen, y, None, None, 4, torch.float32)
    assert d0.dtype == x0.dtype == torch.float32
    assert d0.shape == (4, 32) and x0.shape == (64, 4)


def test_planted_solve_converges():
    """The verify recipe at CPU size: a planted rank-5 problem converges
    and a warm restart stops at once."""
    y, *_ = planted_nmf(seed=11, n_samples=80, n_channels=60, rank=5)
    yt = _t(y.astype(np.float32))
    res = decomp_tpu_torch.nmf.solve(yt, rank=5, tol=1e-4, maxiter=4000)
    assert res.converged
    err = float(torch.linalg.norm(yt - res.x @ res.d) / torch.linalg.norm(yt))
    assert err < 2e-2
    warm = decomp_tpu_torch.nmf.solve(yt, res.d, x=res.x, tol=1e-4,
                                      maxiter=4000)
    assert warm.niter <= 3


def _bad_calls():
    y = np.abs(np.random.default_rng(0).normal(size=(6, 5)))
    d = np.ones((3, 5))
    return y, d


@pytest.mark.parametrize("kw", [
    dict(method="bogus"),
    dict(d="d", rank=2),
    dict(rank=2, inner_iter=0),
    dict(rank=2, inner_iter=1.5),
    dict(),                              # neither d nor rank
    dict(rank=2, stop="bogus"),
    dict(rank=2, factor_dtype="f16"),
    dict(d="d", x="xbad"),
])
def test_errors_match_jax_types(kw):
    y, d = _bad_calls()
    jkw = {k: (d if v == "d" else np.ones((5, 3)) if v == "xbad" else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in jkw.items()}
    if kw.get("factor_dtype") == "f16":
        jkw["factor_dtype"], tkw["factor_dtype"] = jnp.float16, torch.float16
    with pytest.raises(Exception) as ej:
        decomp_tpu.nmf.solve(y, **jkw)
    with pytest.raises(Exception) as et:
        decomp_tpu_torch.nmf.solve(_t(y), **tkw)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert isinstance(et.value, texc.DecompError)


@pytest.mark.parametrize("y,exc", [
    (np.ones(5), "ShapeError"),
    (np.ones((3, 4), np.int64), "DtypeError"),
    (np.ones((3, 4), np.complex128), "DtypeError"),
])
def test_bad_data_raises_like_jax(y, exc):
    with pytest.raises(Exception) as ej:
        decomp_tpu.nmf.solve(y, rank=2)
    with pytest.raises(Exception) as et:
        decomp_tpu_torch.nmf.solve(_t(y), rank=2)
    assert type(ej.value).__name__ == type(et.value).__name__ == exc


def test_factors_on_another_device_are_refused():
    y, d = _bad_calls()
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        decomp_tpu_torch.nmf.solve(_t(y), torch.ones((3, 5), device="meta"))
