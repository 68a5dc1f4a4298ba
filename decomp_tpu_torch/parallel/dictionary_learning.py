"""Sharded dictionary learning over ``torch.distributed`` (counterpart of
``decomp_tpu.parallel.dictionary_learning``).

The sample axis is split over the ranks: each rank sparse-codes its own
rows (the dictionary and its Gram are the same everywhere, so the inner
lasso is row-local except for its all-reduced stopping scalars), and the
dictionary update runs on every rank from the all-reduced K x K and K x N
statistics: A = sum x^H x and B = sum x^H y into ``cuda_dl.bcd_sweep``
without a mask, the summed masked gradient (``cuda_dl.masked_grad_dict``
on each rank's rows) with one. d is then the same on every rank. Full
batch only, as in ``decomp_tpu``: the online variant is a one-process
feature.

``solve_streaming`` is the out-of-core form: each rank streams its rows in
chunks from a loader (``models.dl_streaming``'s loader mode on the rank's
share of the grid), and the statistics are all-reduced once an epoch.
Unlike the in-core solve, each chunk's inner lasso stops on its own chunk
alone, as in ``decomp_tpu``'s sharded epoch (a summed inner stop would
change what one process computes).
"""

import torch

from decomp_tpu_torch.models import dictionary_learning as _dl
from decomp_tpu_torch.models import dl_streaming as _dls
from decomp_tpu_torch.models import lasso as _lasso
from decomp_tpu_torch.models import nmf as _nmf
from decomp_tpu_torch.ops import cuda_lasso
from decomp_tpu_torch.parallel import mesh as _mesh
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.result import DictionaryLearningResult


def solve(
    y,
    d,
    alpha,
    x=None,
    *,
    mesh,
    axis="rows",
    tol=1e-4,
    maxiter: int = 100,
    lasso_method: str = "fista",
    lasso_iter: int = 10,
    lasso_tol=1e-6,
    mask=None,
    record_objective: bool = False,
    precision: str = "highest",
    use_kernel="auto",
    kernel_block_rows=None,
    _bcd_kernel=None,
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    random_seed: int = 0,
    _val=None,
) -> DictionaryLearningResult:
    """Row-sharded ``decomp_tpu_torch.dictionary_learning.solve`` over
    ``mesh[axis]`` (one dim name or a tuple of them), full batch: the same
    contract and kernel routes on each rank's rows. Every rank of the
    process group calls it with its own rows of ``y``, ``mask`` and ``x``
    and the same ``d`` and ``alpha``; every rank's blocks have the same
    shapes. Host arrays go to the rank's device.

    stop='heldout' reserves the entries of ``nmf.solve``'s global draw on
    the whole matrix (each rank replays the generator up to its last row),
    sums the validation error over the ranks, and stops on the same outer
    iteration as the one-process solve. ``_val``: private, the rank's rows
    of a given global reserve instead of the seeded draw.

    Returns the rank's rows of ``x`` and the dictionary ``d``, the same on
    every rank; ``niter``, ``converged``, ``objective`` and
    ``aux['heldout_rel_err']`` are global. An invalid argument raises
    ``DecompError`` on every rank.
    """
    _mesh.require_process_group()
    prep, err = None, None
    try:
        prep = _prepare(y, d, alpha, x, mesh, axis, lasso_method, mask,
                        precision, use_kernel, kernel_block_rows,
                        _bcd_kernel, stop, heldout_frac, _val)
    except ValueError as e:
        err = e
    _mesh.agree(err, None if prep is None else prep["signature"])
    y, d, alpha, x, mask, val = (
        prep[k] for k in ("y", "d", "alpha", "x", "mask", "val"))
    if stop == "heldout" and val is None:
        m_loc = y.shape[0]
        n_rows = _mesh.validate_axis(mesh, axis)
        val = _nmf._heldout_block(
            mask, float(heldout_frac), int(random_seed),
            (m_loc * n_rows, y.shape[1]), _mesh.axis_index(mesh, axis) * m_loc)
    return _dl._solve(
        y, d, x, mask, val, alpha, tol=float(tol), lasso_tol=float(lasso_tol),
        forget=0.0, maxiter=int(maxiter), lasso_method=lasso_method,
        lasso_iter=int(lasso_iter), minibatch=None,
        record_objective=bool(record_objective), kernel=prep["mode"],
        auto=use_kernel == "auto", hi_lo=precision == "high",
        block_rows=kernel_block_rows, bcd_kernel=prep["bcd"],
        random_seed=int(random_seed), reduce_sum=_mesh.reducer(mesh, axis))


def solve_streaming(
    y,
    d,
    alpha,
    x=None,
    *,
    mesh,
    row_axis="rows",
    tol=1e-4,
    maxiter: int = 100,
    lasso_method: str = "fista",
    lasso_iter: int = 10,
    lasso_tol=1e-6,
    mask=None,
    chunk_rows: int = 65536,
    precision: str = "highest",
    callback=None,
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    check_every: int = 5,
    random_seed: int = 0,
    n_samples=None,
    n_channels=None,
    dtype=None,
    record_objective: bool = False,
    use_kernel="auto",
    _bcd_kernel=None,
    _chunk_reserve=None,
) -> DictionaryLearningResult:
    """Sharded out-of-core dictionary learning over ``mesh[row_axis]`` (one
    dim name or a tuple): every rank of the process group calls it with the
    same arguments and streams its own rows in chunks through
    ``dictionary_learning.solve_streaming``'s loader mode.

    ``y`` is a loader ``(lo, hi) -> rows`` taking GLOBAL row offsets, with
    ``n_samples``, ``n_channels`` and ``dtype`` (a real ``torch.dtype``);
    ``mask`` likewise; ``alpha`` a scalar. The grid, ragged tails, padding
    ranks and the held-out reserve keyed by the global offset are those of
    ``parallel.nmf.solve_streaming``. ``x``: the global warm start
    (``n_samples`` rows; a host array, or a tensor on the host or on the
    rank's device). Other parameters as in the one-process loader mode,
    including ``use_kernel`` and ``_bcd_kernel`` for the chunk routes and
    the private ``_chunk_reserve``.

    Returns the rank's rows of ``x`` inside the data and ``d``, the same
    bits on every rank; ``niter``, ``converged``, ``objective`` and
    ``aux['heldout_rel_err']`` are global. An invalid argument raises
    ``DecompError`` on every rank.
    """
    dev = _mesh.placement(mesh, None)
    _mesh.require_process_group()

    def prepare():
        if not callable(y):
            raise DecompError("the sharded streaming DL solver requires a "
                              "callable y loader taking global row offsets")
        shards = (_mesh.validate_axis(mesh, row_axis, "row_axis"),
                  _mesh.axis_index(mesh, row_axis))
        return _dls._fused_prepare(
            y, d, alpha, x, lasso_method=lasso_method, lasso_iter=lasso_iter,
            lasso_tol=lasso_tol, mask_loader=mask, chunk_rows=chunk_rows,
            precision=precision, stop=stop, heldout_frac=heldout_frac,
            n_samples=n_samples, n_channels=n_channels, dtype=dtype,
            record_objective=record_objective, use_kernel=use_kernel,
            bcd_kernel=_bcd_kernel, device=dev, shards=shards)

    return _dls._fused_run(
        _mesh.checked(prepare), tol=tol, maxiter=maxiter, callback=callback,
        check_every=check_every, random_seed=random_seed,
        heldout_frac=heldout_frac, reserve=_chunk_reserve,
        reduce_sum=_mesh.reducer(mesh, row_axis))


def _prepare(y, d, alpha, x, mesh, axis, lasso_method, mask, precision,
             use_kernel, kernel_block_rows, bcd_kernel, stop, heldout_frac,
             val):
    """``solve``'s checks on this rank's arguments (those of
    ``dictionary_learning.solve``), placing them on the rank's device;
    returns what the solve needs and the ``signature`` every rank must
    share."""
    if precision not in _lasso._PRECISIONS:
        raise DecompError(f"precision must be one of {_lasso._PRECISIONS}, "
                          f"got {precision!r}")
    dev = _mesh.placement(mesh, y)
    _mesh.validate_axis(mesh, axis, "axis")
    y = _device.on_device("y", y, dev)
    d = _device.on_device("d", d, dev)
    assertion.assert_inexact("y", y)
    assertion.assert_ndim("y", y, 2)
    assertion.assert_ndim("d", d, 2)
    assertion.assert_axis_size("d", d, 1, y.shape[1], "n_channels")
    dtype = torch.promote_types(y.dtype, d.dtype)
    y, d = y.to(dtype), d.to(dtype)
    rdt = real_dtype(dtype)
    n_atoms = d.shape[0]
    if x is not None:
        x = _device.on_device("x", x, dev, dtype)
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, y.shape[0], "n_samples (block)")
        assertion.assert_axis_size("x", x, 1, n_atoms, "n_atoms")
    if mask is not None:
        mask = _device.on_device("mask", mask, dev)
        assertion.assert_same_shape("mask", mask, "y", y)
        mask = mask.to(rdt)
    _dl._validate_lasso_method(lasso_method)
    assertion.assert_nonnegative("alpha", alpha)
    alpha = _device.on_device("alpha", alpha, dev, rdt)
    mode = _dl._kernel_mode(use_kernel, y, mask, dtype, n_atoms, None,
                            precision, alpha)
    if kernel_block_rows is not None:
        if mode != "whole":
            raise DecompError("kernel_block_rows sets the stripe height of "
                              "the whole-solve kernel, which this call does "
                              "not run")
        cuda_lasso.stripe_rows(kernel_block_rows, n_atoms)
    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', got "
                          f"{stop!r}")
    if stop == "heldout":
        if mask is None:
            raise DecompError("stop='heldout' requires a mask")
        if dtype.is_complex:
            raise DecompError("stop='heldout' supports real dtypes only")
        if not 0.0 < float(heldout_frac) < 1.0:
            raise DecompError("heldout_frac must be in (0, 1)")
        if val is not None:
            val = _device.on_device("_val", val, dev, mask.dtype)
            assertion.assert_same_shape("_val", val, "y", y)
    else:
        val = None
    bcd = _dl._bcd_mode(bcd_kernel, use_kernel, y, n_atoms, y.shape[1],
                        masked=mask is not None)
    signature = tuple((tuple(t.shape), str(t.dtype)) if t is not None
                      else None for t in (y, d, x, mask, alpha, val))
    return dict(y=y, d=d, alpha=alpha, x=x, mask=mask, val=val, mode=mode,
                bcd=bcd, signature=signature)
