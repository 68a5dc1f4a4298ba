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

``solve_streaming`` solves a batch larger than the ranks' memory: chunk
by chunk from a global host array, each chunk split over the ranks and
solved by ``solve``, then put together on every rank by one all-reduce of
a chunk-sized buffer that is zero outside the rank's rows.
"""

import numpy as np
import torch

from decomp_tpu_torch.models import lasso as _lasso
from decomp_tpu_torch.models import lasso_streaming as _lasso_streaming
from decomp_tpu_torch.ops.spectral import lipschitz_gram
from decomp_tpu_torch.parallel import mesh as _mesh
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.result import LassoResult


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
) -> LassoResult:
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


def solve_streaming(
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
    chunk_rows: int = 65536,
    precision: str = "highest",
    per_problem: bool = False,
    use_kernel="auto",
) -> LassoResult:
    """Out-of-core sharded batch lasso (``decomp_tpu.parallel.lasso
    .solve_streaming``). Every rank of the process group calls it with the
    same global host ``y`` (ndarray or memmap), ``a``, ``mask``, ``x`` and
    ``alpha`` (scalar, per feature, or 2-D per sample). The rows stream in
    ``chunk_rows`` blocks (a multiple of the extent of ``mesh[axis]``); a
    ragged last block is zero-padded to one. Each rank solves its slice of
    the block through ``solve`` with one Lipschitz constant for every block
    (``ops.spectral.lipschitz_gram`` of ``a``): with ``per_problem`` and no
    mask, one whole-solve kernel launch a block and no collective in the
    solve. The block's x (and, with ``per_problem``, its per-row counts)
    is then summed over the ranks from buffers that are zero outside each
    rank's rows, which is exact.

    Returns on every rank the whole ``x`` as a host numpy array; ``niter``
    is the largest block's count and ``converged`` whether every block
    converged, or with ``per_problem`` host arrays of shape (n_samples,).
    An invalid argument raises ``DecompError`` on every rank.
    """
    dev = _mesh.placement(mesh, None)
    _mesh.require_process_group()

    def prepare():
        y_, a_, alpha_rows, x_, mask_, chunk = (
            _lasso_streaming.checked_arrays(y, a, alpha, x, mask,
                                            chunk_rows))
        n_dev = _mesh.validate_axis(mesh, axis, "axis")
        if chunk % n_dev:
            raise DecompError(
                f"chunk_rows={chunk} must divide evenly over "
                f"mesh[{axis!r}]={n_dev} (each chunk row-shards)")
        return y_, a_, alpha_rows, x_, mask_, chunk, n_dev

    y, a, alpha_rows, x, mask, chunk_rows, n_dev = _mesh.checked(prepare)
    index = _mesh.axis_index(mesh, axis)
    red = _mesh.reducer(mesh, axis)
    dtype = np.result_type(y.dtype, a.dtype)
    a_dev = torch.as_tensor(a.astype(dtype), device=dev)
    # One Lipschitz estimate for every chunk, as the full batch computes it.
    lip = lipschitz_gram(a_dev)
    n, f = y.shape[0], a.shape[0]
    out = np.empty((n, f), dtype=dtype)
    niter_max, all_converged = 0, True
    if per_problem:
        niter_rows = np.zeros((n,), np.int32)
        conv_rows = np.zeros((n,), bool)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        per = -(-(hi - lo) // n_dev)    # the rank's rows of the padded block
        r0 = lo + index * per

        def rows(v):
            """The rank's rows of ``v``, zero-padded past the block."""
            part = np.asarray(v[min(r0, hi):min(r0 + per, hi)])
            return np.concatenate([part, np.zeros(
                (per - part.shape[0],) + part.shape[1:], part.dtype)])

        res = solve(
            rows(y), a_dev, alpha if alpha_rows is None else rows(alpha_rows),
            None if x is None else rows(x), mesh=mesh, axis=axis, tol=tol,
            maxiter=maxiter, method=method,
            mask=None if mask is None else rows(mask), lipschitz=lip,
            precision=precision, per_problem=per_problem,
            use_kernel=use_kernel)
        block = _gathered(red, res.x, index, per, n_dev)
        out[lo:hi] = block[:hi - lo].cpu().numpy()
        if per_problem:
            counts = torch.stack([res.niter.to(torch.int32),
                                  res.converged.to(torch.int32)], 1)
            counts = _gathered(red, counts, index, per, n_dev).cpu().numpy()
            niter_rows[lo:hi] = counts[:hi - lo, 0]
            conv_rows[lo:hi] = counts[:hi - lo, 1] != 0
        else:
            niter_max = max(niter_max, int(res.niter))
            all_converged = all_converged and bool(res.converged)
    empty = torch.zeros((0,), dtype=torch.float32)
    if per_problem:
        return LassoResult(x=out, niter=niter_rows, converged=conv_rows,
                           objective=empty)
    return LassoResult(x=out, niter=niter_max, converged=all_converged,
                       objective=empty)


def _gathered(red, part, index, per, n_dev):
    """The ranks' ``part`` blocks of ``per`` rows stacked in rank order, on
    every rank: a zero buffer holding the rank's own rows, summed over the
    ranks (complex parts as their real pairs)."""
    buf = part.new_zeros((n_dev * per,) + tuple(part.shape[1:]))
    buf[index * per:(index + 1) * per] = part
    if buf.is_complex():
        return torch.view_as_complex(red(torch.view_as_real(buf)))
    return red(buf)


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
