"""Masked MU-NMF, held-out stopping and ``masked_completion`` in the
PyTorch port against ``decomp_tpu``.

The same numpy inputs, made from a seed, go through both packages: the
masked Pallas kernel (interpret mode on CPU) against the port's
``mu_stats_masked`` (its plain twin on CPU), and ``solve`` end to end on
both paths. Seeded draws differ between the packages (``jax.random`` vs
``torch.Generator``), so parity tests pass ``x`` and ``d`` in, and the
held-out tests pass ``decomp_tpu``'s validation reserve to the port's
private ``_solve``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu.models.nmf import _HELDOUT_SALT
from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_nmf, random_mask, rel_err
from test_torch_nmf import _bf16_np, _t


def _masked_arrs(seed, m, n, k):
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    return (rng.uniform(0.1, 1, (m, n)) * mask, mask,
            rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n)))


# f64: the Pallas kernel forms x_new and its statistics in f32 even for
# f64 data (pallas_mu.py:247-250), and the twin mirrors those casts, so
# both agree to f32 summation order: 1e-6 relative.
@pytest.mark.parametrize("m,jax_rows,port_rows", [
    (64, 32, 32),
    (64, 16, 24),      # ragged last chunk on the port side
    (72, 8, 16),       # M not a multiple of the port's chunk
    (72, 24, None),
])
def test_twin_matches_pallas_f64(m, jax_rows, port_rows):
    my, mask, x, d = _masked_arrs(m, m, 256, 128)
    xj, dj = pallas_mu.mu_update_masked(
        jnp.asarray(my), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(d),
        1e-15, block_rows=jax_rows, interpret=True)
    xt, dt = cuda_mu.mu_update_masked(_t(my), _t(mask), _t(x), _t(d), 1e-15,
                                      block_rows=port_rows)
    assert xt.dtype == dt.dtype == torch.float64
    assert rel_err(xt.numpy(), xj) < 1e-6
    assert rel_err(dt.numpy(), dj) < 1e-6


# Mixed mode: bf16 my, mask and d, f32 x and d_master. The same bf16
# operand quantisation and f32 sums in another order: x_new (f32) to 1e-5
# relative (Frobenius). The statistics and d_new take cdt(x_new), where an
# ulp-level difference can flip one bf16 rounding (2^-8 of one entry,
# ~2e-5 on a statistic at this shape; see test_torch_kl.py), so 1e-4.
@pytest.mark.parametrize("seed", [11, 12])
def test_twin_matches_pallas_mixed(seed):
    my, mask, x, d = _masked_arrs(seed, 72, 256, 128)
    myb, x32, d32 = _bf16_np(my), x.astype(np.float32), d.astype(np.float32)
    db = _bf16_np(d32)
    jargs = (jnp.asarray(myb, jnp.bfloat16), jnp.asarray(mask, jnp.bfloat16),
             jnp.asarray(x32), jnp.asarray(db, jnp.bfloat16), 1e-6)
    targs = (_t(myb, torch.bfloat16), _t(mask, torch.bfloat16), _t(x32),
             _t(db, torch.bfloat16), 1e-6)
    sj = pallas_mu.mu_stats_masked(*jargs, block_rows=24, interpret=True)
    st = cuda_mu.mu_stats_masked(*targs, block_rows=16)
    for a, b, limit in zip(st, sj, (1e-5, 1e-4, 1e-4)):
        assert a.dtype == torch.float32
        assert rel_err(a.numpy(), b) < limit
    xj, dj = pallas_mu.mu_update_masked(*jargs, block_rows=24, interpret=True,
                                        d_master=jnp.asarray(d32))
    xt, dt = cuda_mu.mu_update_masked(*targs, block_rows=16,
                                      d_master=_t(d32))
    assert dt.dtype == torch.float32
    assert rel_err(xt.numpy(), xj) < 1e-5
    assert rel_err(dt.numpy(), dj) < 1e-4


@pytest.mark.parametrize("name", ["mu_update_masked", "kl_update_masked",
                                  "kl_update_dense"])
def test_twin_needs_no_padding(name):
    """The port takes ragged M, N and K as they are; the JAX kernels need
    them padded, and zero padding is a fixed point of the MU and KL
    updates, so the two agree on the unpadded block."""
    m, n, k = 50, 200, 100
    my, mask, x, d = _masked_arrs(3, m, n, k)
    pad = lambda a, r, c: np.pad(a, ((0, r - a.shape[0]), (0, c - a.shape[1])))
    masked = name != "kl_update_dense"
    jargs = [jnp.asarray(pad(my, 56, 256))]
    targs = [_t(my)]
    if masked:
        jargs.append(jnp.asarray(pad(mask, 56, 256)))
        targs.append(_t(mask))
    jargs += [jnp.asarray(pad(x, 56, 128)), jnp.asarray(pad(d, 128, 256))]
    targs += [_t(x), _t(d)]
    xj, dj = getattr(pallas_mu, name)(*jargs, 1e-15, block_rows=8,
                                      interpret=True)
    xt, dt = getattr(cuda_mu, name)(*targs, 1e-15)
    assert rel_err(xt.numpy(), np.asarray(xj)[:m, :k]) < 1e-6
    assert rel_err(dt.numpy(), np.asarray(dj)[:k, :n]) < 1e-6


@pytest.mark.parametrize("rows", [8, 16, 40, 1000])
def test_twin_chunking_is_invisible(rows):
    """The twin's row chunk only bounds its f32 temporaries."""
    my, mask, x, d = (_t(a) for a in _masked_arrs(5, 40, 30, 6))
    ref = cuda_mu.mu_stats_masked_plain(my, mask, x, d, 1e-12, block_rows=40)
    got = cuda_mu.mu_stats_masked_plain(my, mask, x, d, 1e-12,
                                        block_rows=rows)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


_WRAPPERS = [
    ("mu_stats_masked", True), ("kl_stats_dense", False),
    ("kl_stats_masked", True),
]


@pytest.mark.parametrize("name,masked", _WRAPPERS)
def test_cpu_wrapper_is_the_twin_and_does_not_count(name, masked):
    my, mask, x, d = (_t(a) for a in _masked_arrs(6, 20, 16, 4))
    args = (my, mask, x, d) if masked else (my, x, d)
    wrapper = getattr(cuda_mu, name)
    before = wrapper.launches
    got = wrapper(*args, 1e-12)
    ref = getattr(cuda_mu, f"{name}_plain")(*args, 1e-12)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert wrapper.launches == before


@pytest.mark.parametrize("name,masked", _WRAPPERS)
def test_wrapper_refuses_devices_without_kernel(name, masked):
    meta = lambda *s: torch.empty(s, device="meta")
    args = ((meta(4, 4), meta(4, 4), meta(4, 2), meta(2, 4)) if masked
            else (meta(4, 4), meta(4, 2), meta(2, 4)))
    with pytest.raises(texc.DecompError):
        getattr(cuda_mu, name)(*args, 1e-6)


@pytest.mark.parametrize("mdt,mshape,xdt,wide_x,exc", [
    (torch.float32, (16, 8), torch.float32, True, texc.DtypeError),
    (torch.bfloat16, (16, 4), torch.float32, True, texc.ShapeError),
    (torch.bfloat16, (16, 8), torch.float32, False, texc.DtypeError),
    (torch.bfloat16, (16, 8), torch.float64, True, texc.DtypeError),
])
def test_masked_kernel_argument_checks(mdt, mshape, xdt, wide_x, exc):
    """The masked kernels take the mask in the data's dtype and shape; the
    KL kernels take x only in the data's dtype (checked on CPU tensors;
    the checks do not look at the device type)."""
    y = torch.zeros((16, 8), dtype=torch.bfloat16)
    with pytest.raises(exc):
        cuda_mu._check_kernel_args(
            y, torch.zeros((16, 4), dtype=xdt),
            torch.zeros((4, 8), dtype=torch.bfloat16), 1, 256,
            mask=torch.zeros(mshape, dtype=mdt), wide_x=wide_x)


def test_masked_kernel_argument_checks_pass():
    y = torch.zeros((16, 8), dtype=torch.bfloat16)
    cuda_mu._check_kernel_args(y, torch.zeros((16, 4)),
                               torch.zeros((4, 8), dtype=torch.bfloat16), 1,
                               256, mask=torch.zeros_like(y))


def _problem(seed=1, m=60, n=40, k=5, noise=0.01):
    """Planted data with junk at the missing entries, a 30% missing mask
    and seeded initial factors."""
    y, *_ = planted_nmf(seed=seed, n_samples=m, n_channels=n, rank=k,
                        noise=noise)
    mask = random_mask(seed + 50, y.shape)
    y = np.where(mask > 0, y, 7.0)
    rng = np.random.default_rng(seed + 100)
    return y, mask, rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n))


@pytest.mark.parametrize("check_every", [1, 3])
def test_solve_composition_matches_jax_f64(check_every):
    y, mask, x0, d0 = _problem()
    kw = dict(tol=1e-4, maxiter=3000, check_every=check_every)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, use_pallas=False, **kw)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask),
                                    use_kernel=False, **kw)
    assert bool(rj.converged) and rt.converged
    assert rt.niter == int(rj.niter)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-10
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10


def test_solve_objective_curve_matches_jax():
    y, mask, x0, d0 = _problem(seed=2)
    kw = dict(tol=1e-3, maxiter=200, record_objective=True)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, use_pallas=False, **kw)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask),
                                    use_kernel=False, **kw)
    oj, ot = np.asarray(rj.objective), rt.objective.numpy()
    assert rt.niter == int(rj.niter)
    np.testing.assert_array_equal(np.isnan(ot), np.isnan(oj))
    np.testing.assert_allclose(ot[:rt.niter], oj[:rt.niter], rtol=1e-10)
    assert np.all(np.diff(ot[:rt.niter]) <= 0)  # MU never increases it


def test_solve_kernel_path_matches_jax_pallas():
    """f32 through the kernel path (the twin on CPU) against the masked
    Pallas kernel in interpret mode, 15 fixed iterations: 1e-4 (as
    tests/test_pallas.py)."""
    y, mask, x0, d0 = (a.astype(np.float32)
                       for a in _problem(seed=5, m=70, n=50, k=4))
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, tol=0.0, maxiter=15,
                              use_pallas=True, pallas_block_rows=16,
                              _pallas_interpret=True)
    rt = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask),
                                    tol=0.0, maxiter=15, use_kernel=True,
                                    kernel_block_rows=16)
    assert rt.niter == 15 and not rt.converged
    assert rt.x.shape == (70, 4) and rt.d.shape == (4, 50)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_mixed_matches_jax(use_kernel):
    """bf16 data and mask with f32 factors, on both of the port's paths,
    against the JAX composition path in the same mode: 1e-4."""
    y, mask, x0, d0 = _problem(seed=3, m=48, n=40, k=4)
    yb = _bf16_np(y)
    x0, d0 = x0.astype(np.float32), d0.astype(np.float32)
    rj = decomp_tpu.nmf.solve(jnp.asarray(yb, jnp.bfloat16), d0, x=x0,
                              mask=mask, tol=0.0, maxiter=15,
                              use_pallas=False, eps=1e-6,
                              precision="default", factor_dtype=jnp.float32)
    rt = decomp_tpu_torch.nmf.solve(_t(yb, torch.bfloat16), _t(d0),
                                    x=_t(x0), mask=_t(mask), tol=0.0,
                                    maxiter=15, eps=1e-6,
                                    precision="default",
                                    factor_dtype=torch.float32,
                                    use_kernel=use_kernel)
    assert rt.x.dtype == rt.d.dtype == torch.float32
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_bool_mask_is_cast_to_y_dtype():
    y, mask, x0, d0 = _problem(seed=4)
    kw = dict(tol=0.0, maxiter=5, use_kernel=False)
    a = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask),
                                   **kw)
    b = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0),
                                   mask=_t(mask) > 0, **kw)
    assert torch.equal(a.d, b.d)


def _jax_reserve(y, mask, frac, seed):
    """decomp_tpu's held-out reserve (models/nmf.py:349-352)."""
    kv = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                            _HELDOUT_SALT)
    return np.asarray((jax.random.uniform(kv, y.shape) < frac)
                      .astype(y.dtype) * mask)


def _heldout_problem(seed=21):
    y, mask, x0, d0 = _problem(seed=seed, m=300, n=60, k=4, noise=0.05)
    return y, mask, x0, d0, _jax_reserve(y, mask, 0.05, seed)


@pytest.mark.parametrize("method,tol,check_every", [
    ("mu", 1e-3, 25),
    ("mu", 1e-3, 10),
    ("mu", 0.0, 25),      # stops when the validation error rises
    ("kl-mu", 1e-3, 25),
])
def test_heldout_matches_jax_with_its_reserve(method, tol, check_every):
    """stop='heldout' (f64, composition path) with decomp_tpu's reserve
    passed in: equal niter and converged, heldout_rel_err within 1e-10
    relative."""
    y, mask, x0, d0, val = _heldout_problem()
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, tol=tol, maxiter=3000,
                              method=method, stop="heldout", random_seed=21,
                              check_every=check_every, use_pallas=False)
    rt = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val), rank=4,
                     method=method, tol=tol, maxiter=3000,
                     check_every=check_every)
    assert bool(rj.converged) and int(rj.niter) < 3000
    assert rt.niter == int(rj.niter)
    assert rt.converged == bool(rj.converged)
    ej = float(np.asarray(rj.aux["heldout_rel_err"]))
    assert abs(float(rt.aux["heldout_rel_err"]) - ej) <= 1e-10 * ej
    assert rel_err(rt.d.numpy(), rj.d) < 1e-10


def test_heldout_kernel_path_matches_composition():
    """The held-out machinery is the same on the kernel path (the twin on
    CPU): the same stop and a close validation error."""
    y, mask, x0, d0, val = _heldout_problem()
    kw = dict(rank=4, tol=1e-3, maxiter=3000, check_every=25)
    a = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val),
                    use_kernel=True, **kw)
    b = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val),
                    use_kernel=False, **kw)
    assert a.converged and a.niter == b.niter
    ea, eb = float(a.aux["heldout_rel_err"]), float(b.aux["heldout_rel_err"])
    assert abs(ea - eb) < 1e-5 * eb


def test_heldout_solve_draws_its_own_reserve():
    y, mask, x0, d0 = _problem(seed=22, m=300, n=60, k=4, noise=0.05)
    res = decomp_tpu_torch.nmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask),
                                     tol=1e-3, maxiter=3000, stop="heldout",
                                     random_seed=3)
    assert res.converged and res.niter % 25 == 0
    assert 0 < float(res.aux["heldout_rel_err"]) < 0.2


@pytest.mark.parametrize("seed", [0, 7])
def test_salted_reserve(seed):
    """The port's reserve: about heldout_frac of the observed entries,
    inside the mask (so disjoint from the train mask) and the same for the
    same seed. It stays non-empty under a mask drawn from the same seed,
    which an unsalted draw would reuse uniform for uniform."""
    gen = torch.Generator().manual_seed(seed)
    mask = (torch.rand((512, 256), generator=gen) >= 0.3).double()
    val = tnmf._heldout_reserve(mask, 0.05, seed)
    frac = float(val.sum() / mask.sum())
    assert 0.03 < frac < 0.07, frac
    assert bool(((val == 0) | (val == 1)).all())
    assert float((val * (mask - val)).sum()) == 0.0
    assert bool((val <= mask).all())
    assert torch.equal(val, tnmf._heldout_reserve(mask, 0.05, seed))
    assert not torch.equal(val, tnmf._heldout_reserve(mask, 0.05, seed + 1))
    unsalted = torch.rand((512, 256),
                          generator=torch.Generator().manual_seed(seed))
    assert float(((unsalted < 0.05).double() * mask).sum()) == 0.0


def _completion_problem(seed=84, m=300, n=60, k=4):
    rng = np.random.default_rng(seed)
    ytrue = (rng.uniform(0, 1, (m, k)) @ rng.uniform(0, 1, (k, n))
             + 0.02 * rng.normal(size=(m, n)))
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    return ytrue, mask


def test_masked_completion_is_heldout_solve_then_refit():
    ytrue, mask = _completion_problem()
    ym, m = _t(ytrue * mask), _t(mask)
    res = tnmf.masked_completion(ym, m, rank=4, tol=1e-3, maxiter=2000,
                                 refit=40, random_seed=3)
    a = tnmf.solve(ym, rank=4, mask=m, tol=1e-3, maxiter=2000,
                   stop="heldout", random_seed=3)
    b = tnmf.solve(ym, a.d, x=a.x, mask=m, tol=0.0, maxiter=40,
                   random_seed=3)
    assert torch.equal(res.x, b.x) and torch.equal(res.d, b.d)
    assert res.niter == a.niter + 40 and res.converged == a.converged
    assert torch.equal(res.aux["heldout_rel_err"],
                       a.aux["heldout_rel_err"])
    plain = tnmf.masked_completion(ym, m, rank=4, tol=1e-3, maxiter=2000,
                                   random_seed=3)
    assert torch.equal(plain.d, a.d) and plain.niter == a.niter
    miss = mask == 0
    recon = (res.x @ res.d).numpy()
    err = (np.linalg.norm(recon[miss] - ytrue[miss])
           / np.linalg.norm(ytrue[miss]))
    assert err < 0.1


def test_masked_completion_mixed_and_auto():
    """mixed=True runs bf16 data with f32 factors; 'auto' keeps a CPU
    tensor's f32 (mixed is for CUDA f32 data)."""
    ytrue, mask = _completion_problem(m=120, n=40)
    ym = _t(ytrue * mask, torch.float32)
    m = _t(mask, torch.float32)
    mixed = tnmf.masked_completion(ym, m, rank=4, maxiter=60, mixed=True)
    assert mixed.x.dtype == mixed.d.dtype == torch.float32
    a = tnmf.masked_completion(ym, m, rank=4, maxiter=60)
    b = tnmf.masked_completion(ym, m, rank=4, maxiter=60, mixed=False)
    assert torch.equal(a.d, b.d)
    assert not torch.equal(a.d, mixed.d)


def _bad():
    rng = np.random.default_rng(0)
    y = rng.uniform(0.1, 1, (16, 8)).astype(np.float32)
    return y, (rng.random((16, 8)) > 0.3).astype(np.float32)


# Every check of decomp_tpu/models/nmf.py:252-292 that the port keeps,
# with use_pallas=True on the JAX side where the port says use_kernel=True.
@pytest.mark.parametrize("kw", [
    dict(use_kernel=True, method="kl-mu", factor_dtype="wide"),
    dict(use_kernel=True, method="kl-mu", inner_iter=2),
    dict(use_kernel=True, mask="m", inner_iter=2),
    dict(method="hals", mask="m"),
    dict(method="hals", minibatch=4),
    dict(stop="nope", mask="m"),
    dict(stop="heldout"),
    dict(stop="heldout", mask="m", method="hals"),
    dict(stop="heldout", mask="m", minibatch=4),
    dict(stop="heldout", mask="m", record_objective=True),
    dict(stop="heldout", mask="m", heldout_frac=1.5),
    dict(stop="heldout", mask="m", heldout_frac=0.0),
    dict(mask="bad_shape"),
])
def test_errors_match_jax_types(kw):
    y, mask = _bad()
    values = {"m": mask, "bad_shape": mask[:, :5], "wide": None}
    jkw, tkw = {}, {}
    for k, v in kw.items():
        jv = values.get(v, v) if isinstance(v, str) else v
        jkw["use_pallas" if k == "use_kernel" else k] = jv
        tkw[k] = _t(jv) if isinstance(jv, np.ndarray) else jv
    if kw.get("factor_dtype") == "wide":
        jkw["factor_dtype"], tkw["factor_dtype"] = jnp.float64, torch.float64
    with pytest.raises(Exception) as ej:
        decomp_tpu.nmf.solve(y, rank=2, **jkw)
    with pytest.raises(Exception) as et:
        decomp_tpu_torch.nmf.solve(_t(y), rank=2, **tkw)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert isinstance(et.value, texc.DecompError)


def test_mask_on_another_device_is_refused():
    y, _ = _bad()
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        decomp_tpu_torch.nmf.solve(_t(y), rank=2,
                                   mask=torch.ones((16, 8), device="meta"))
