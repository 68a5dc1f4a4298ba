"""Out-of-core dictionary learning in the PyTorch port against
``decomp_tpu``: ``dictionary_learning.solve_streaming`` on the host-array
path (unmasked, masked, complex, record_objective, held-out stopping) and
in loader mode (``jit_loader=True``: ragged tails, ``check_every``), the
kernel routes its chunks take (the twins on the CPU), the refusals and the
device rule. The same numpy inputs, made from a seed, go through both
packages; the held-out tests pass ``decomp_tpu``'s per-chunk reserves to
the private ``_chunk_reserve`` hook."""

import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_patches, random_mask, rel_err
from test_torch_nmf_streaming import _jax_reserve, _loaders, _np, _same

ALPHA = 0.05
tdl = decomp_tpu_torch.dictionary_learning
jdl = decomp_tpu.dictionary_learning


def _problem(seed, m=90, ch=24, k=8, masked=False, complex_=False,
             dtype=np.float64):
    y, d_true, _ = planted_patches(seed=seed, n_samples=m, n_channels=ch,
                                   n_atoms=k, complex_=complex_)
    rng = np.random.default_rng(seed + 1)
    d0 = d_true + 0.3 * rng.normal(size=d_true.shape)
    mask = random_mask(seed + 2, y.shape) if masked else None
    if masked:
        y = y * mask
        mask = mask.astype(dtype)
    return y.astype(dtype if not complex_ else y.dtype), mask, d0


# The host-array path at the inner lasso's full budget (lasso_tol=0), f64
# and complex128: d and x to 1e-10 with equal niter, the objective curve to
# 1e-10 relative (measured <= 6.5e-16); the port's streamed run also equals
# its own in-core solve from the same start (1e-10; measured <= 6.5e-16).
@pytest.mark.parametrize("masked,complex_", [(False, False), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("method", ["fista", "ista"])
def test_host_path_matches_jax(masked, complex_, method):
    y, mask, d0 = _problem(57, masked=masked, complex_=complex_)
    kw = dict(mask=mask, tol=0.0, maxiter=8, lasso_iter=5, lasso_tol=0.0,
              chunk_rows=17, lasso_method=method, record_objective=True)
    rj = jdl.solve_streaming(y, d0, ALPHA, **kw)
    rt = tdl.solve_streaming(y, d0, ALPHA, device="cpu", **kw)
    assert isinstance(rt.x, np.ndarray) and rt.x.dtype == y.dtype
    _same(rt, rj, 1e-10)
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-10)
    core = tdl.solve(torch.from_numpy(y), torch.from_numpy(d0), ALPHA,
                     mask=None if mask is None else torch.from_numpy(mask),
                     tol=0.0, maxiter=8, lasso_iter=5, lasso_tol=0.0,
                     lasso_method=method)
    assert rel_err(_np(rt.d), core.d.numpy()) < 1e-10
    assert rel_err(rt.x, core.x.numpy()) < 1e-10


# An inner tolerance is tested per chunk, as in decomp_tpu; a rel-change
# tol stops both on the same outer iteration (f64, 1e-10).
def test_inner_tol_and_stop_match_jax():
    y, _, d0 = _problem(70, m=120)
    kw = dict(tol=1e-3, maxiter=60, lasso_iter=20, lasso_tol=1e-4,
              chunk_rows=50)
    rj = jdl.solve_streaming(y, d0, ALPHA, **kw)
    seen = []
    rt = tdl.solve_streaming(y, d0, ALPHA, device="cpu",
                             callback=lambda it, diff: seen.append(it), **kw)
    assert rt.converged and seen == list(range(1, rt.niter + 1))
    _same(rt, rj, 1e-10)


# Loader mode against decomp_tpu's fused DL epoch, f64, with a ragged tail
# (509 rows in chunks of 64): d and x to 1e-10 (measured <= 5.2e-16); the
# port's loader mode also equals its host-array path (1e-12; measured 0)
# and returns x on the device without the padding.
@pytest.mark.parametrize("masked", [False, True])
def test_loader_mode_matches_jax(masked):
    m, ch, k, chunk = 509, 24, 6, 64
    y, mask, d0 = _problem(105, m=m, ch=ch, k=k, masked=masked)
    (yj, yt), (mj, mt) = _loaders(y, chunk, mask)
    kw = dict(tol=0.0, maxiter=6, lasso_iter=6, lasso_tol=0.0,
              chunk_rows=chunk, n_samples=m, n_channels=ch, jit_loader=True,
              record_objective=True)
    rj = jdl.solve_streaming(yj, d0, ALPHA, mask=mj, dtype=np.float64, **kw)
    rt = tdl.solve_streaming(yt, d0, ALPHA, mask=mt, dtype=torch.float64,
                             device="cpu", **kw)
    assert isinstance(rt.x, torch.Tensor) and rt.x.shape == (m, k)
    _same(rt, rj, 1e-10)
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-10)
    host = tdl.solve_streaming(y, d0, ALPHA, mask=mask, tol=0.0, maxiter=6,
                               lasso_iter=6, lasso_tol=0.0, chunk_rows=chunk,
                               device="cpu")
    assert rel_err(_np(rt.d), host.d.numpy()) < 1e-12
    assert rel_err(_np(rt.x), host.x) < 1e-12


# check_every in loader mode: the stop lands on a check epoch, the
# callback fires on check epochs only, and niter equals decomp_tpu's.
def test_loader_check_every_matches_jax():
    m, ch, k, chunk = 256, 24, 6, 64
    y, _, d0 = _problem(71, m=m, ch=ch, k=k)
    (yj, yt), _ = _loaders(y, chunk)
    kw = dict(tol=1e-3, maxiter=200, lasso_iter=6, lasso_tol=0.0,
              chunk_rows=chunk, n_samples=m, n_channels=ch, jit_loader=True,
              check_every=4)
    rj = jdl.solve_streaming(yj, d0, ALPHA, dtype=np.float64, **kw)
    calls = []
    rt = tdl.solve_streaming(yt, d0, ALPHA, dtype=torch.float64,
                             device="cpu",
                             callback=lambda it, diff: calls.append(it), **kw)
    assert rt.converged and rt.niter % 4 == 0
    assert calls == list(range(4, rt.niter + 1, 4))
    _same(rt, rj, 1e-10)


# stop='heldout' fed decomp_tpu's per-chunk reserves: both paths stop on
# the same iteration as decomp_tpu with d and x to 1e-10 and the reported
# validation error to 1e-6 relative (f64; measured <= 3.4e-16 and 0).
@pytest.mark.parametrize("loader_mode", [False, True])
def test_heldout_stop_matches_jax(loader_mode):
    rng = np.random.default_rng(104)
    m, ch, k, chunk = 320, 24, 6, 64
    d_true = rng.normal(size=(k, ch))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    xt = rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.3)
    ytrue = xt @ d_true + 0.01 * rng.normal(size=(m, ch))
    mask = (rng.random((m, ch)) >= 0.3).astype(np.float64)
    d0 = rng.normal(size=(k, ch))
    kw = dict(tol=1e-2, maxiter=200, lasso_iter=8, chunk_rows=chunk,
              stop="heldout", check_every=4, random_seed=5)
    ym = ytrue * mask
    if loader_mode:
        (yj, yt), (mj, mt) = _loaders(ym, chunk, mask)
        kw.update(n_samples=m, n_channels=ch, jit_loader=True)
        rj = jdl.solve_streaming(yj, d0, 0.02, mask=mj, dtype=np.float64,
                                 **kw)
        rt = tdl.solve_streaming(yt, d0, 0.02, mask=mt, dtype=torch.float64,
                                 device="cpu",
                                 _chunk_reserve=_jax_reserve(5, 0.05), **kw)
    else:
        rj = jdl.solve_streaming(ym, d0, 0.02, mask=mask, **kw)
        rt = tdl.solve_streaming(ym, d0, 0.02, mask=mask, device="cpu",
                                 _chunk_reserve=_jax_reserve(5, 0.05), **kw)
    assert rt.converged and rt.niter < 200
    _same(rt, rj, 1e-10)
    np.testing.assert_allclose(float(rt.aux["heldout_rel_err"]),
                               float(rj.aux["heldout_rel_err"]), rtol=1e-6)


# The kernel routes on the CPU (their twins): with a mask and
# use_kernel=True each chunk's inner gradient is masked_grad_rows and its
# dictionary gradient masked_grad_dict, on a 0/1 chunk mask packed into
# bits; unmasked, _bcd_kernel=True sweeps once per outer iteration through
# bcd_sweep, and use_kernel=True codes each chunk with solve_rows. The
# twins sum in f32 as the kernels do: against decomp_tpu's compositions on
# f32 data, 1e-5 (measured <= 2.8e-7).
@pytest.mark.parametrize("loader_mode", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_routes_match_jax(masked, loader_mode, monkeypatch):
    m, ch, k, chunk = 200, 32, 8, 64
    y, mask, d0 = _problem(80, m=m, ch=ch, k=k, masked=masked,
                           dtype=np.float32)
    d0 = d0.astype(np.float32)
    calls = {"rows": [], "dict": [], "bcd": 0, "solve_rows": 0}
    grad_rows = cuda_lasso.masked_grad_rows
    grad_dict = cuda_dl.masked_grad_dict
    bcd, solve_rows = cuda_dl.bcd_sweep, cuda_lasso.solve_rows
    monkeypatch.setattr(cuda_lasso, "masked_grad_rows", lambda my, mk, *a, **
                        k_: calls["rows"].append(mk.dtype) or grad_rows(
                            my, mk, *a, **k_))
    monkeypatch.setattr(cuda_dl, "masked_grad_dict", lambda my, mk, *a:
                        calls["dict"].append(mk.dtype) or grad_dict(my, mk,
                                                                    *a))

    def count(name, fn):
        def wrapped(*a, **k_):
            calls[name] += 1
            return fn(*a, **k_)
        return wrapped

    monkeypatch.setattr(cuda_dl, "bcd_sweep", count("bcd", bcd))
    monkeypatch.setattr(cuda_lasso, "solve_rows",
                        count("solve_rows", solve_rows))
    kw = dict(tol=0.0, maxiter=4, lasso_iter=5, lasso_tol=0.0,
              chunk_rows=chunk)
    rj = jdl.solve_streaming(y, d0, ALPHA, mask=mask, **kw)
    tkw = dict(kw, device="cpu", use_kernel=True)
    if not masked:
        tkw["_bcd_kernel"] = True
    first, tmask = y, mask
    if loader_mode:
        (_, first), (_, tmask) = _loaders(y, chunk, mask)
        tkw.update(jit_loader=True, n_samples=m, n_channels=ch,
                   dtype=torch.float32)
    rt = tdl.solve_streaming(first, d0, ALPHA, mask=tmask, **tkw)
    n_chunks = -(-m // chunk)
    if masked:
        assert calls["dict"] == [torch.int32] * (4 * n_chunks)
        assert calls["rows"] == [torch.int32] * (4 * n_chunks * 5)
        assert calls["bcd"] == calls["solve_rows"] == 0
    else:
        assert calls["bcd"] == 4 and calls["solve_rows"] == 4 * n_chunks
        assert not calls["rows"] and not calls["dict"]
    assert rel_err(_np(rt.d), rj.d) < 1e-5
    assert rel_err(_np(rt.x), rj.x) < 1e-5


def test_refusals_raise_like_jax():
    """The same exception types as decomp_tpu's for the same mistakes."""
    y, mask, d0 = _problem(81, m=64, masked=True)
    load = (lambda lo, hi: y[lo:hi])
    lkw = dict(jit_loader=True, n_samples=64, n_channels=24)
    cases = [
        ((load, d0, ALPHA), {}),                          # no jit_loader
        ((y, d0, ALPHA), dict(jit_loader=True)),
        ((y, d0, ALPHA), dict(stop="heldout")),           # no mask
        ((y, d0, ALPHA), dict(mask=mask, stop="nope")),
        ((y, d0, ALPHA), dict(mask=mask, stop="heldout",
                              record_objective=True)),
        ((y, d0, ALPHA), dict(lasso_method="cd")),
        ((y, d0, ALPHA), dict(chunk_rows=0)),
        ((y, d0[:, :5], ALPHA), {}),
        ((y, d0, -1.0), {}),
        ((load, d0, ALPHA), dict(lkw, chunk_rows=128, dtype=np.float64)),
        ((load, d0, np.full(8, ALPHA)), dict(lkw, chunk_rows=32,
                                             dtype=np.float64)),
        ((load, d0, ALPHA), dict(lkw, chunk_rows=32, dtype=np.complex128)),
        ((load, d0, ALPHA), dict(lkw, chunk_rows=32, dtype=np.float64,
                                 mask=mask)),
        ((load, d0, ALPHA), dict(lkw, chunk_rows=32, dtype=np.float64,
                                 stop="heldout")),
    ]
    tdt = {np.float64: torch.float64, np.complex128: torch.complex128}
    for args, kw in cases:
        with pytest.raises(Exception) as ej:
            jdl.solve_streaming(*args, maxiter=2, **kw)
        tkw = dict(kw)
        if "dtype" in tkw:
            tkw["dtype"] = tdt[tkw["dtype"]]
        with pytest.raises(Exception) as et:
            tdl.solve_streaming(*args, maxiter=2, device="cpu", **tkw)
        assert type(et.value).__name__ == type(ej.value).__name__, (kw,
                                                                    et.value)


def test_device_rule(monkeypatch):
    y, _, d0 = _problem(82, m=40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(texc.DecompError, match="no CUDA device"):
        tdl.solve_streaming(y, d0, ALPHA, maxiter=2)
    with pytest.raises(texc.DecompError, match="no CUDA device"):
        tdl.solve_streaming(lambda lo, hi: y[lo:hi], d0, ALPHA, maxiter=2,
                            jit_loader=True, n_samples=40, n_channels=24,
                            dtype=torch.float64, chunk_rows=20)
    res = tdl.solve_streaming(y, d0, ALPHA, maxiter=2, device="cpu")
    assert res.d.device.type == "cpu" and isinstance(res.x, np.ndarray)
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        tdl.solve_streaming(y, torch.ones(d0.shape, device="meta"), ALPHA,
                            maxiter=2, device="cpu")

