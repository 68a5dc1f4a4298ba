"""Dictionary learning in the PyTorch port against ``decomp_tpu``:
``dictionary_learning.solve`` end to end (unmasked, masked, complex,
objective curve, stopping), its kernel routes on the CPU (the twins of
``ops.cuda_dl`` and ``ops.cuda_lasso``) against the Pallas routes in
interpret mode, the minibatch and held-out variants with ``decomp_tpu``'s
draws passed in, a JAX result carried into the port, the errors, and the
rule that an entry point runs on the card unless asked for the CPU. The
same numpy inputs, made from a seed, go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu.models.nmf import _HELDOUT_SALT
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso
from decomp_tpu_torch.utils import convert
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_patches, random_mask, rel_err

ALPHA = 0.05
jdl = decomp_tpu.dictionary_learning


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _init(d_true, seed, scale=0.3):
    """A unit-norm perturbation of the planted atoms."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=d_true.shape)
    if np.iscomplexobj(d_true):
        noise = noise + 1j * rng.normal(size=d_true.shape)
    d0 = d_true + scale * noise
    return d0 / np.sqrt(np.sum(np.abs(d0) ** 2, axis=1, keepdims=True))


def _problem(seed, masked=False, complex_=False, n_samples=120,
             n_channels=32, n_atoms=10):
    y, d_true, _ = planted_patches(seed=seed, n_samples=n_samples,
                                   n_channels=n_channels, n_atoms=n_atoms,
                                   complex_=complex_)
    mask = random_mask(seed + 1, y.shape) if masked else None
    if masked:
        y = y * mask
    return y, mask, _init(d_true, seed + 2)


def _same_run(rt, rj, tol):
    """d and x within ``tol`` relative, the same niter and converged."""
    assert rel_err(_np(rt.d), rj.d) < tol
    assert rel_err(_np(rt.x), rj.x) < tol
    assert rt.niter == int(rj.niter)
    assert rt.converged == bool(rj.converged)


# f64 (and complex128) composition paths: d and x to 1e-10 with equal
# niter, the objective curve to 1e-9 relative, as the lasso and NMF parity
# tests hold theirs.
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("complex_", [False, True])
def test_solve_matches_jax(masked, complex_):
    y, mask, d0 = _problem(1, masked, complex_)
    kw = dict(tol=0.0, maxiter=10, lasso_iter=8, record_objective=True)
    rj = jdl.solve(y, d0, ALPHA, mask=mask, complex_split=False, **kw)
    rt = tdl.solve(_t(y), _t(d0), ALPHA,
                   mask=None if mask is None else _t(mask), **kw)
    assert rt.d.dtype == (torch.complex128 if complex_ else torch.float64)
    _same_run(rt, rj, 1e-10)
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-9)
    assert rt.objective[-1] < rt.objective[0]
    np.testing.assert_allclose(np.linalg.norm(_np(rt.d), axis=1), 1.0,
                               rtol=1e-10)


@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd"])
def test_lasso_methods_and_per_atom_alpha_match_jax(method):
    y, _, d0 = _problem(2)
    alpha = np.linspace(0.02, 0.08, d0.shape[0])
    kw = dict(tol=0.0, maxiter=6, lasso_iter=6, lasso_method=method)
    rj = jdl.solve(y, d0, alpha, **kw)
    rt = tdl.solve(_t(y), _t(d0), _t(alpha), **kw)
    _same_run(rt, rj, 1e-10)


# tol > 0: the rel-change stop fires at the same outer iteration.
@pytest.mark.parametrize("masked", [False, True])
def test_tol_stops_where_jax_stops(masked):
    y, mask, d0 = _problem(3, masked)
    kw = dict(tol=1e-4, maxiter=300, lasso_iter=10)
    rj = jdl.solve(y, d0, ALPHA, mask=mask, **kw)
    rt = tdl.solve(_t(y), _t(d0), ALPHA,
                   mask=None if mask is None else _t(mask), **kw)
    assert rt.converged and rt.niter < 300
    _same_run(rt, rj, 1e-9)


def _f32_problem(seed, m, n, k):
    rng = np.random.default_rng(seed)
    d_true = rng.normal(size=(k, n))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    xt = rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.1)
    y = (xt @ d_true + 0.01 * rng.normal(size=(m, n))).astype(np.float32)
    d0 = rng.normal(size=(k, n)).astype(np.float32)
    return y, d0


def _jax_batches(seed, maxiter, minibatch, m):
    """decomp_tpu's minibatch rows (dictionary_learning.py:425-430)."""
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, it), (minibatch,), 0, m))
        for it in range(maxiter)])


# The BCD sweep kernel's route (on the CPU, _bcd_kernel=True runs its twin)
# against decomp_tpu's Pallas sweep in interpret mode, f32: 1e-5 relative,
# the limit tests/test_pallas.py:391 holds the Pallas route to the jnp one
# (measured <= 5.2e-7).
@pytest.mark.parametrize("minibatch", [None, 64])
def test_bcd_kernel_route_matches_pallas(minibatch):
    y, d0 = _f32_problem(81, 256, 40, 16)
    kw = dict(tol=0.0, maxiter=6, lasso_iter=4)
    rj = jdl.solve(y, d0, ALPHA, minibatch=minibatch, random_seed=1,
                   _bcd_pallas="interpret", **kw)
    before = cuda_dl.bcd_sweep.launches
    if minibatch is None:
        rt = tdl.solve(_t(y), _t(d0), ALPHA, _bcd_kernel=True, **kw)
    else:
        idx = _t(_jax_batches(1, 6, minibatch, 256))
        rt = tdl._solve(_t(y), _t(d0), None, None, None,
                        torch.tensor(ALPHA, dtype=torch.float32),
                        lasso_tol=1e-6, forget=0.9, lasso_method="fista",
                        minibatch=minibatch, record_objective=False,
                        bcd_kernel=True, batch_idx=idx, **kw)
    assert cuda_dl.bcd_sweep.launches == before     # CPU: the twin ran
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


# The masked kernels' route (use_kernel=True: the masked_grad_rows and
# masked_grad_dict twins) against decomp_tpu's Pallas route in interpret
# mode, f32, at shapes the Pallas route needs no padding for (K = N = 128;
# padded atoms would change its power iterations' start vector): 1e-5
# relative after 4 outer iterations (measured 2.6e-7).
def test_masked_kernel_route_matches_pallas():
    y, d0 = _f32_problem(15, 96, 128, 128)
    mask = random_mask(16, y.shape).astype(np.float32)
    y = y * mask
    kw = dict(tol=0.0, maxiter=4, lasso_iter=5, record_objective=True)
    rj = jdl.solve(y, d0, ALPHA, mask=mask, use_pallas=True,
                   pallas_block_rows=16, _pallas_interpret=True, **kw)
    before = (cuda_dl.masked_grad_dict.launches,
              cuda_lasso.masked_grad_rows.launches)
    rt = tdl.solve(_t(y), _t(d0), ALPHA, mask=_t(mask), use_kernel=True, **kw)
    assert (cuda_dl.masked_grad_dict.launches,
            cuda_lasso.masked_grad_rows.launches) == before
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-5)


# Unmasked use_kernel=True: the inner coding through the whole-solve kernel
# (its twin here), per-row stopping at lasso_tol, or its fixed-budget mode
# at lasso_tol = 0, against decomp_tpu's Pallas route in interpret mode
# (tests/test_dictionary_learning.py:183 and :206's setups, cut to 256
# rows), f32: 5e-5 relative (measured <= 5.1e-6). As in decomp_tpu, the
# route gives the composition's result (measured: the same bits).
@pytest.mark.parametrize("lasso_tol,maxiter,lasso_iter",
                         [(1e-6, 15, 10), (0.0, 12, 8)])
def test_whole_kernel_inner_coding_matches_pallas(lasso_tol, maxiter,
                                                  lasso_iter):
    y, d0 = _f32_problem(70, 256, 64, 128)
    kw = dict(maxiter=maxiter, lasso_iter=lasso_iter, lasso_tol=lasso_tol)
    rj = jdl.solve(y, d0, 0.05, use_pallas=True, _pallas_interpret=True, **kw)
    before = cuda_lasso.solve_rows.launches
    rt = tdl.solve(_t(y), _t(d0), 0.05, use_kernel=True, **kw)
    assert cuda_lasso.solve_rows.launches == before
    assert rel_err(rt.d.numpy(), rj.d) < 5e-5
    assert rel_err(rt.x.numpy(), rj.x) < 5e-5
    ref = tdl.solve(_t(y), _t(d0), 0.05, use_kernel=False, **kw)
    assert rel_err(rt.d.numpy(), ref.d.numpy()) < 1e-6


# Minibatch (online) dictionary learning, f64, with decomp_tpu's batches
# passed to the private _solve: 1e-10.
@pytest.mark.parametrize("masked", [False, True])
def test_minibatch_matches_jax_with_its_batches(masked):
    y, mask, d0 = _problem(10, masked, n_samples=200)
    kw = dict(tol=0.0, maxiter=25, lasso_iter=6)
    rj = jdl.solve(y, d0, ALPHA, mask=mask, minibatch=48, random_seed=12,
                   record_objective=True, **kw)
    idx = _t(_jax_batches(12, 25, 48, 200))
    rt = tdl._solve(_t(y), _t(d0), None, None if mask is None else _t(mask),
                    None, torch.tensor(ALPHA, dtype=torch.float64),
                    lasso_tol=1e-6, forget=0.9, lasso_method="fista",
                    minibatch=48, record_objective=True, batch_idx=idx, **kw)
    _same_run(rt, rj, 1e-10)
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-9)


def test_minibatch_draws_its_own_batches():
    y, _, d0 = _problem(11, n_samples=200)
    kw = dict(tol=0.0, maxiter=40, lasso_iter=6, minibatch=48,
              record_objective=True)
    a = tdl.solve(_t(y), _t(d0), ALPHA, random_seed=3, **kw)
    b = tdl.solve(_t(y), _t(d0), ALPHA, random_seed=3, **kw)
    c = tdl.solve(_t(y), _t(d0), ALPHA, random_seed=4, **kw)
    assert torch.equal(a.d, b.d) and not torch.equal(a.d, c.d)
    assert a.objective[-1] < 0.5 * a.objective[0]


def _jax_reserve(y, mask, frac, seed):
    """decomp_tpu's held-out reserve (dictionary_learning.py:259-264)."""
    kv = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                            _HELDOUT_SALT)
    return np.asarray((jax.random.uniform(kv, y.shape) < frac)
                      .astype(y.dtype) * mask)


def _heldout_problem(seed=72):
    rng = np.random.default_rng(seed)
    m, ch, k = 400, 24, 8
    d_true = rng.normal(size=(k, ch))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    xt = rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.3)
    ytrue = xt @ d_true + 0.01 * rng.normal(size=(m, ch))
    mask = (rng.random((m, ch)) >= 0.3).astype(np.float64)
    return ytrue * mask, mask, rng.normal(size=(k, ch))


# stop='heldout' (f64) with decomp_tpu's reserve passed in: equal niter and
# converged, heldout_rel_err within 1e-10 relative; tol = inf is the
# warm-up floor case (tests/test_dictionary_learning.py:298): with
# maxiter = 6 the floor clamps to 5 and the check after it converges. The
# masked kernels' route (their twins, f32) within 1e-5 (measured 1.7e-7).
@pytest.mark.parametrize("tol,maxiter,use_kernel", [
    (1e-3, 300, False), (np.inf, 6, False), (0.0, 40, False),
    (1e-3, 300, True)])
def test_heldout_matches_jax_with_its_reserve(tol, maxiter, use_kernel):
    y, mask, d0 = _heldout_problem()
    if use_kernel:
        y, mask, d0 = (v.astype(np.float32) for v in (y, mask, d0))
    kw = dict(tol=tol, maxiter=maxiter, lasso_iter=6)
    rj = jdl.solve(y, d0, 0.02, mask=mask, stop="heldout", random_seed=5,
                   **kw)
    val = _jax_reserve(y, mask, 0.05, 5)
    rt = tdl._solve(_t(y), _t(d0), None, _t(mask), _t(val),
                    torch.tensor(0.02, dtype=_t(y).dtype), lasso_tol=1e-6,
                    forget=0.9, lasso_method="fista", minibatch=None,
                    record_objective=False,
                    kernel="masked" if use_kernel else None, **kw)
    assert rt.niter == int(rj.niter) and rt.converged == bool(rj.converged)
    ej = float(np.asarray(rj.aux["heldout_rel_err"]))
    limit = 1e-5 if use_kernel else 1e-10
    assert abs(float(rt.aux["heldout_rel_err"]) - ej) <= limit * ej
    assert rel_err(rt.d.numpy(), rj.d) < limit
    if tol == 1e-3:
        assert rt.converged and rt.niter < maxiter


def test_heldout_solve_draws_its_own_reserve():
    y, mask, d0 = _heldout_problem(73)
    kw = dict(tol=1e-3, maxiter=300, lasso_iter=6)
    res = tdl.solve(_t(y), _t(d0), 0.02, mask=_t(mask), stop="heldout",
                    random_seed=3, **kw)
    val = tnmf._heldout_reserve(_t(mask), 0.05, 3)
    ref = tdl._solve(_t(y), _t(d0), None, _t(mask), val,
                     torch.tensor(0.02, dtype=torch.float64), lasso_tol=1e-6,
                     forget=0.9, lasso_method="fista", minibatch=None,
                     record_objective=False, **kw)
    assert res.converged and res.niter == ref.niter
    assert torch.equal(res.d, ref.d)
    assert 0 < float(res.aux["heldout_rel_err"]) < 0.3


def test_jax_result_carries_into_the_port():
    """A JAX solve's result, handed over through ``convert.from_numpy``,
    warm-starts the port, whose next 5 outer iterations equal JAX's own
    continuation (f64: 1e-10)."""
    y, mask, d0 = _problem(30, masked=True)
    kw = dict(tol=0.0, lasso_iter=8, mask=mask)
    first = jdl.solve(y, d0, ALPHA, maxiter=5, **kw)
    rest_j = jdl.solve(y, first.d, ALPHA, x=first.x, maxiter=5, **kw)
    carried = convert.from_numpy(first, "cpu")
    assert isinstance(carried, decomp_tpu_torch.DictionaryLearningResult)
    rest_t = tdl.solve(_t(y), carried.d, ALPHA, x=carried.x, maxiter=5,
                       **{**kw, "mask": _t(mask)})
    _same_run(rest_t, rest_j, 1e-10)


# decomp_tpu's validation cases, with use_pallas on the JAX side where the
# port says use_kernel and _bcd_pallas where it says _bcd_kernel; the same
# exception type on both sides.
@pytest.mark.parametrize("kw", [
    dict(lasso_method="cd"),
    dict(lasso_method="bogus"),
    dict(minibatch=0),
    dict(minibatch=10_000),
    dict(stop="heldout"),
    dict(stop="bogus"),
    dict(stop="heldout", mask="ones", heldout_frac=1.5),
    dict(stop="heldout", mask="ones", minibatch=8),
    dict(d="dT"),
    dict(x="bad_x"),
    dict(mask="bad_shape"),
    dict(alpha=-1.0),
    dict(use_kernel=True, minibatch=8),
    dict(use_kernel=True, complex_=True),
    dict(use_kernel=True),                                   # f64
    dict(use_kernel=True, f32=True, precision="default"),
    dict(use_kernel=True, f32=True, alpha="atoms"),
    dict(_bcd_kernel=True, mask="ones", f32=True),
    dict(_bcd_kernel=True),                                  # f64
    dict(_bcd_kernel=True, complex_=True),
    dict(_bcd_kernel="bogus"),
])
def test_errors_match_jax_types(kw):
    kw = dict(kw)
    y, _, d0 = _problem(17, complex_=kw.pop("complex_", False))
    if kw.pop("f32", False):
        y, d0 = y.astype(np.float32), d0.astype(np.float32)
    m, k = y.shape[0], d0.shape[0]
    values = {"dT": d0.T, "bad_x": np.ones((m + 1, k)), "ones": np.ones(
        y.shape), "bad_shape": np.ones((m, 3)), "atoms": np.full(k, 0.05)}
    args = {n: values[v] if n in ("d", "x", "mask", "alpha")
            and isinstance(v, str) else v for n, v in kw.items()}
    d_ = args.pop("d", d0)
    alpha = args.pop("alpha", ALPHA)
    rename = {"use_kernel": "use_pallas", "_bcd_kernel": "_bcd_pallas"}
    jkw = {rename.get(n, n): v for n, v in args.items()}
    with pytest.raises(Exception) as ej:
        jdl.solve(y, d_, alpha, maxiter=2, complex_split=False, **jkw)
    with pytest.raises(Exception) as et:
        tdl.solve(y, d_, alpha, maxiter=2, device="cpu", **args)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert isinstance(et.value, ValueError)


def test_port_refusals():
    y, _, d0 = _problem(19)
    with pytest.raises(texc.DecompError, match="Do not port"):
        tdl.solve_split((y, 0 * y), (d0, 0 * d0), ALPHA)
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        tdl.solve(_t(y), _t(d0), ALPHA, kernel_block_rows=16)
    y32, d32 = _t(y.astype(np.float32)), _t(d0.astype(np.float32))
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        tdl.solve(y32, d32, ALPHA, use_kernel=True, kernel_block_rows=8)
    with pytest.raises(texc.DecompError, match="precision"):
        tdl.solve(_t(y), _t(d0), ALPHA, precision="bogus")
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        tdl.solve(_t(y), torch.ones(d0.shape, device="meta"), ALPHA)


def test_bcd_mode_and_kernel_block_rows():
    y = torch.zeros((4, 8))
    assert tdl._bcd_mode(None, "auto", y, 4, 8) is False     # CPU: no card
    assert tdl._bcd_mode(True, False, y, 4, 8) is True
    assert tdl._bcd_mode(False, True, y, 4, 8) is False
    assert tdl._bcd_mode(None, False, y, 4, 8) is False
    y32, d32 = _f32_problem(5, 48, 24, 16)
    kw = dict(tol=0.0, maxiter=3, lasso_iter=4, use_kernel=True)
    r16 = tdl.solve(_t(y32), _t(d32), ALPHA, kernel_block_rows=16, **kw)
    r32 = tdl.solve(_t(y32), _t(d32), ALPHA, kernel_block_rows=32, **kw)
    assert torch.equal(r16.d, r32.d) and torch.equal(r16.x, r32.x)


# An entry point runs on the card unless the caller asks for the CPU. The
# tests make "no card" certain by hiding any that the machine has.
def test_host_input_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, mask, d0 = _problem(20, masked=True)
    kw = dict(tol=0.0, maxiter=2, lasso_iter=3, mask=mask)
    with pytest.raises(texc.DecompError, match="no CUDA device"):
        tdl.solve(y, d0, ALPHA, **kw)
    res = tdl.solve(y, d0, ALPHA, device="cpu", **kw)
    assert res.d.device.type == "cpu" and res.x.device.type == "cpu"
    cpu = tdl.solve(_t(y), d0, ALPHA, **kw)       # a CPU tensor is a request
    assert torch.equal(cpu.d, res.d)
