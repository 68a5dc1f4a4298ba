"""Sharded batch lasso over ``torch.distributed`` (counterpart of
``decomp_tpu.parallel.lasso``).

Each row of ``y`` is an independent problem sharing the dictionary ``a``,
so the sample axis splits without traffic: ``a`` and its Gram are the same
on every rank, each rank iterates on its own rows, and the only collective
is the all-reduce of the scalars of the global stopping rule (and of the
objective), through ``models.lasso.build_solver(reduce_sum=)``. The
whole-solve kernel path (unmasked, per-problem stopping) runs no
collective at all: each rank makes one ``cuda_lasso.solve_rows`` launch on
its rows.
"""

import torch

from decomp_tpu_torch.models import lasso as _lasso
from decomp_tpu_torch.parallel import mesh as _mesh
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError


def solve(
    y,
    a,
    alpha,
    x=None,
    *,
    mesh,
    axis="rows",
    tol=1e-5,
    maxiter: int = 1000,
    method: str = "fista",
    mask=None,
    lipschitz=None,
    record_objective: bool = False,
    precision: str = "highest",
    check_every: int = 1,
    per_problem: bool = False,
    use_kernel="auto",
    kernel_block_rows=None,
):
    """Row-sharded ``decomp_tpu_torch.lasso.solve`` over ``mesh[axis]``
    (one dim name or a tuple of them). Every rank of the process group
    calls it with its own rows of ``y`` (2-D), ``mask``, ``x`` and a
    per-sample ``alpha`` (2-D), and the same ``a``, scalar or per-feature
    ``alpha`` and ``lipschitz``; every rank's blocks have the same shapes.
    Methods and paths as in the one-process solver: masked, the gradient
    kernel ``cuda_lasso.masked_grad_rows`` on each rank's rows (a 0/1 mask
    packs only where every rank's block is 0/1); unmasked with
    ``per_problem``, the whole-solve kernel on each rank's rows, with no
    collective. Host arrays go to the rank's device.

    Returns the rank's rows of ``x``; ``niter`` and ``converged`` are
    global (the same on every rank), or with ``per_problem`` the rank's
    rows of the per-row counts. An invalid argument raises ``DecompError``
    on every rank.
    """
    _mesh.require_process_group()
    prep, err = None, None
    try:
        prep = _prepare(y, a, alpha, x, mesh, axis, method, mask, lipschitz,
                        record_objective, precision, per_problem, use_kernel,
                        kernel_block_rows)
    except ValueError as e:
        err = e
    _mesh.agree(err, None if prep is None else prep["signature"])
    y, a, alpha, x, mask, lip, mode = (
        prep[k] for k in ("y", "a", "alpha", "x", "mask", "lip", "mode"))
    if mode == "whole":
        return _lasso._solve_whole(
            y, a, alpha, x, lip, float(tol), None, None, None, None,
            method=method, maxiter=int(maxiter),
            hi_lo=precision == "high", block_rows=kernel_block_rows,
            fixed=_lasso._static_nonpositive(tol))
    red = _mesh.reducer(mesh, axis)
    kernel_mask = None
    if mode == "masked":
        kernel_mask = _lasso._kernel_mask(mask, y, use_kernel == "auto", red)
        if kernel_mask is None:
            mode = None
    return _lasso._solve(
        y, a, alpha, x, mask, lip, float(tol), method=method,
        maxiter=int(maxiter), record_objective=bool(record_objective),
        check_every=int(check_every), per_problem=bool(per_problem),
        use_kernel=mode == "masked", kernel_mask=kernel_mask,
        reduce_sum=red)


def _prepare(y, a, alpha, x, mesh, axis, method, mask, lipschitz,
             record_objective, precision, per_problem, use_kernel,
             kernel_block_rows):
    """``solve``'s checks on this rank's arguments (those of
    ``lasso.solve``), placing them on the rank's device; returns what the
    solve needs and the ``signature`` every rank must share."""
    if method not in _lasso._METHODS:
        raise DecompError(f"method must be one of {_lasso._METHODS}, got "
                          f"{method!r}")
    if per_problem and method == "cd":
        raise DecompError("per_problem convergence does not support "
                          "method 'cd'")
    if precision not in _lasso._PRECISIONS:
        raise DecompError(f"precision must be one of {_lasso._PRECISIONS}, "
                          f"got {precision!r}")
    dev = _mesh.placement(mesh, y)
    _mesh.validate_axis(mesh, axis, "axis")
    y = _device.on_device("y", y, dev)
    a = _device.on_device("a", a, dev)
    assertion.assert_inexact("y", y)
    assertion.assert_ndim("y", y, 2)
    assertion.assert_ndim("a", a, 2)
    assertion.assert_axis_size("a", a, 1, y.shape[1], "n_channels")
    dtype = torch.promote_types(y.dtype, a.dtype)
    y, a = y.to(dtype), a.to(dtype)
    rdt = real_dtype(dtype)
    n_features = a.shape[0]
    if x is not None:
        x = _device.on_device("x", x, dev, dtype)
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, y.shape[0], "n_samples (block)")
        assertion.assert_axis_size("x", x, 1, n_features, "n_features")
    if mask is not None:
        mask = _device.on_device("mask", mask, dev)
        assertion.assert_same_shape("mask", mask, "y", y)
        mask = mask.to(rdt)
        if method == "cd":
            raise DecompError("method 'cd' does not support mask; use "
                              "'parallel_cd' or 'fista'")
    assertion.assert_nonnegative("alpha", alpha)
    alpha = _device.on_device("alpha", alpha, dev, rdt)
    if method == "cd" and alpha.dim() != 0:
        raise DecompError("method 'cd' requires a scalar alpha")
    if alpha.dim() == 2:
        assertion.assert_axis_size("alpha", alpha, 0, y.shape[0],
                                   "n_samples (block)")
    lip = (None if lipschitz is None
           else _device.on_device("lipschitz", lipschitz, dev, rdt))
    mode = _lasso._kernel_mode(use_kernel, y, mask, method, dtype, n_features,
                               per_problem, record_objective, precision,
                               alpha)
    if kernel_block_rows is not None and mode != "whole":
        raise DecompError("kernel_block_rows sets the stripe height of the "
                          "whole-solve kernel, which this call does not run")
    signature = tuple((tuple(t.shape), str(t.dtype)) if t is not None
                      else None for t in (y, a, x, mask, alpha))
    return dict(y=y, a=a, alpha=alpha, x=x, mask=mask, lip=lip, mode=mode,
                signature=signature)
