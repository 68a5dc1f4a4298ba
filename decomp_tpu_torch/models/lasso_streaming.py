"""Out-of-core batch lasso: more problems than device memory (counterpart
of ``decomp_tpu.models.lasso_streaming``).

Rows of ``y`` are independent problems sharing the dictionary, so a batch
larger than device memory streams exactly: the Lipschitz constant is
computed once, from ``a`` alone, and each host row chunk is copied to the
device and solved with it, so every chunk runs the iteration the
full-batch solver would. Convergence is per chunk.
"""

import numpy as np
import torch

from decomp_tpu_torch.models import lasso as _lasso
from decomp_tpu_torch.ops.spectral import lipschitz_gram
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.result import LassoResult


def checked_arrays(y, a, alpha, x, mask, chunk_rows):
    """The streamers' checks of their host arrays (one process and
    sharded): ``(y, a, alpha_rows, x, mask, chunk_rows)`` as numpy (a
    memmap stays one), ``alpha_rows`` a 2-D per-sample alpha, else None."""
    y = np.asarray(y)
    a_np = np.asarray(a)
    assertion.assert_ndim("y", y, 2)
    assertion.assert_ndim("a", a_np, 2)
    assertion.assert_axis_size("a", a_np, 1, y.shape[1], "n_channels")
    if mask is not None:
        mask = np.asarray(mask)
        assertion.assert_same_shape("mask", mask, "y", y)
    if x is not None:
        x = np.asarray(x)
        assertion.assert_axis_size("x", x, 0, y.shape[0], "n_samples")
        assertion.assert_axis_size("x", x, 1, a_np.shape[0], "n_features")
    chunk_rows = int(chunk_rows)
    if chunk_rows < 1:
        raise DecompError("chunk_rows must be >= 1")
    # Per-sample (2-D) alpha weights are row-shaped like y and are sliced
    # per chunk; scalar and per-feature alpha are shared.
    alpha_np = np.asarray(alpha)
    alpha_rows = None
    if alpha_np.ndim == 2:
        if alpha_np.shape[0] != y.shape[0]:
            raise DecompError(
                f"2-D alpha must have n_samples={y.shape[0]} rows, got "
                f"{alpha_np.shape}")
        alpha_rows = alpha_np
    return y, a_np, alpha_rows, x, mask, chunk_rows


def solve_streaming(
    y,
    a,
    alpha,
    x=None,
    *,
    tol=1e-5,
    maxiter: int = 1000,
    method: str = "fista",
    mask=None,
    chunk_rows: int = 65536,
    precision: str = "highest",
    per_problem: bool = False,
    device=None,
) -> LassoResult:
    """Out-of-core ``lasso.solve`` over host-resident ``y``.

    Parameters as in ``lasso.solve`` except that ``y``, ``x`` and ``mask``
    are host arrays (ndarray / memmap) streamed to ``device`` (default the
    CUDA device; see ``utils.device``) in ``chunk_rows`` row blocks; the
    returned ``x`` is a host numpy array. ``niter`` is the largest chunk
    iteration count and ``converged`` is True only if every chunk
    converged; with ``per_problem=True`` both are host arrays of shape
    (n_samples,), as in the in-core per-problem solve. Each chunk takes
    ``lasso.solve``'s ``use_kernel='auto'`` route, which packs a 0/1 mask
    into bits once per chunk where the masked kernel reads bits.
    """
    y, a_np, alpha_rows, x, mask, chunk_rows = checked_arrays(
        y, a, alpha, x, mask, chunk_rows)
    dev = _device.resolve(None, device)
    dtype = np.result_type(y.dtype, a_np.dtype)
    a_dev = torch.as_tensor(a_np.astype(dtype), device=dev)
    # One Lipschitz estimate for every chunk, as the full batch computes it.
    lip = lipschitz_gram(a_dev)

    n = y.shape[0]
    out = np.empty((n, a_np.shape[0]), dtype=dtype)
    niter_max, all_converged = 0, True
    if per_problem:
        niter_rows = np.zeros((n,), np.int32)
        conv_rows = np.zeros((n,), bool)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        res = _lasso.solve(
            torch.as_tensor(y[lo:hi], device=dev), a_dev,
            alpha if alpha_rows is None else alpha_rows[lo:hi],
            None if x is None else x[lo:hi],
            tol=tol, maxiter=maxiter, method=method,
            mask=None if mask is None else mask[lo:hi],
            lipschitz=lip, precision=precision, per_problem=per_problem)
        out[lo:hi] = res.x.cpu().numpy()
        if per_problem:
            niter_rows[lo:hi] = res.niter.cpu().numpy()
            conv_rows[lo:hi] = res.converged.cpu().numpy()
        else:
            niter_max = max(niter_max, int(res.niter))
            all_converged = all_converged and bool(res.converged)

    empty = torch.zeros((0,), dtype=torch.float32)
    if per_problem:
        return LassoResult(x=out, niter=niter_rows, converged=conv_rows,
                           objective=empty)
    return LassoResult(x=out, niter=niter_max, converged=all_converged,
                       objective=empty)
