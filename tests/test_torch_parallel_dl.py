"""Sharded dictionary learning of the PyTorch port (``decomp_tpu_torch.
parallel.dictionary_learning``) on gloo worlds of CPU ranks, against the
port's one-process solve and ``decomp_tpu.parallel.dictionary_learning`` on
a JAX mesh of the same shape.

Each rank codes its rows; the dictionary update runs on every rank from the
all-reduced statistics, so d must hold the same bits on every rank.
Tolerances: f64, 1e-10 relative (the inner lasso's stopping sums and the
statistics differ in order only); the f32 kernels' twins (the BCD sweep,
the masked gradients) 1e-5 against the one-process kernel path."""

import numpy as np
import pytest
import torch

import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from problems import planted_patches, random_mask, rel_err
from torch_parallel_ranks import assemble, worlds  # noqa: F401

ROW4 = ((4,), ("rows",))
SLICE = ((2, 2), ("slice", "rows"))


def _problem(seed=25, masked=False, complex_=False, dtype=np.float64):
    y, d_true, _ = planted_patches(seed=seed, n_samples=96, n_channels=16,
                                   n_atoms=8, complex_=complex_)
    rng = np.random.default_rng(seed + 2)
    noise = rng.normal(size=d_true.shape)
    if complex_:
        noise = noise + 1j * rng.normal(size=d_true.shape)
    d0 = d_true + 0.3 * noise
    mask = random_mask(seed + 1, y.shape) if masked else None
    if mask is not None:
        y = y * mask
        mask = mask.astype(dtype)
    return dict(y=y.astype(dtype) if not complex_ else y,
                d=d0.astype(dtype) if not complex_ else d0, alpha=0.05,
                mask=mask)


def _single(arrays, **kw):
    return dt.dictionary_learning.solve(
        torch.as_tensor(arrays["y"]), torch.as_tensor(arrays["d"]),
        arrays["alpha"], device="cpu",
        mask=None if arrays["mask"] is None else torch.as_tensor(
            arrays["mask"]), **kw)


def _jax(arrays, spec, axis, **kw):
    import jax
    from decomp_tpu import parallel as jpar

    mesh = jpar.make_mesh(*spec, devices=jax.devices()[:4])
    return jpar.dictionary_learning.solve(
        arrays["y"], arrays["d"], arrays["alpha"], mask=arrays["mask"],
        mesh=mesh, axis=axis, **kw)


def _check(outs, ref, tol):
    assert all(o["d_same"] for o in outs)
    assert {o["niter"] for o in outs} == {int(ref.niter)}
    assert rel_err(outs[0]["d"], np.asarray(ref.d)) < tol
    assert rel_err(assemble(outs), np.asarray(ref.x)) < tol


@pytest.mark.parametrize("spec,axis", [(ROW4, "rows"),
                                       (SLICE, ("slice", "rows"))])
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_matches_single_and_jax(worlds, spec, axis, masked):
    arrays = _problem(masked=masked)
    kw = dict(tol=0.0, maxiter=10, lasso_iter=8)
    outs = worlds(4).run(ranks.dl, spec, axis, arrays, kw)
    _check(outs, _single(arrays, **kw), 1e-10)
    _check(outs, _jax(arrays, spec, axis, **kw), 1e-10)


def test_converges_with_record_objective(worlds):
    """A tol > 0 run stops on the one-process outer iteration; the
    objective curve is the global one."""
    arrays = _problem(seed=31, masked=True)
    kw = dict(tol=1e-3, maxiter=200, lasso_iter=5, record_objective=True)
    outs = worlds(2).run(ranks.dl, ((2,), ("rows",)), "rows", arrays, kw)
    ref = _single(arrays, **kw)
    assert ref.converged and ref.niter < 200
    _check(outs, ref, 1e-9)
    done = ref.niter   # the curve is NaN past the last iteration
    assert rel_err(outs[1]["objective"][:done],
                   ref.objective.numpy()[:done]) < 1e-10


def test_bcd_kernel_twin(worlds):
    """The BCD sweep's wrapper (its twin here) on the summed statistics on
    every rank, f32."""
    arrays = _problem(seed=28, dtype=np.float32)
    kw = dict(tol=0.0, maxiter=6, lasso_iter=4, _bcd_kernel=True)
    outs = worlds(4).run(ranks.dl, ROW4, "rows", arrays, kw)
    _check(outs, _single(arrays, **kw), 1e-5)
    _check(outs, _jax(arrays, ROW4, "rows", tol=0.0, maxiter=6,
                      lasso_iter=4), 1e-4)


@pytest.mark.parametrize("inner", ["masked", "whole"])
def test_kernel_twins(worlds, inner):
    """use_kernel=True: masked, the inner gradient (masked_grad_rows) and
    the dictionary gradient (masked_grad_dict) on each rank's rows, the
    0/1 mask packed where every rank's block is 0/1; unmasked, the inner
    coding in one whole-solve call per rank and outer iteration."""
    arrays = _problem(seed=34, masked=inner == "masked", dtype=np.float32)
    kw = dict(tol=0.0, maxiter=6, lasso_iter=5, use_kernel=True)
    outs = worlds(4).run(ranks.dl, ROW4, "rows", arrays, kw)
    _check(outs, _single(arrays, **kw), 1e-5)


def test_complex(worlds):
    arrays = _problem(seed=28, complex_=True)
    kw = dict(tol=0.0, maxiter=8, lasso_iter=6)
    outs = worlds(4).run(ranks.dl, ROW4, "rows", arrays, kw)
    assert outs[0]["d"].dtype == np.complex128
    _check(outs, _single(arrays, **kw), 1e-10)
    _check(outs, _jax(arrays, ROW4, "rows", **kw), 1e-10)
