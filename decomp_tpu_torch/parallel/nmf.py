"""Sharded NMF over ``torch.distributed`` (counterpart of
``decomp_tpu.parallel.nmf``).

A tall ``y`` (e.g. 1M x 10k, rank 128) is split by rows over the ranks of
``row_axis`` and, optionally, by columns over those of ``col_axis``. Each
rank holds its (row, col) block of ``y`` and ``mask``, its rows of ``x``
and its column block of ``d``, and runs the one-process iteration
(``models.nmf._solve``) on them; per update the only traffic is the
all-reduce of the K-sized statistics:

    x update: sum over cols of my_loc d_loc^T (M_loc, K), d_loc d_loc^T (K, K)
    d update: sum over rows of x_loc^T my_loc (K, N_loc), x_loc^T x_loc (K, K)

while the O(M N K) products stay on each rank. With a row axis only, each
rank runs the ``ops.cuda_mu`` kernel of its method on its rows and the
statistics are summed between the kernel and the d epilogue. The stopping
quantity is all-reduced, so every rank leaves the loop on the same
iteration.
"""

from typing import Optional

import numpy as np
import torch

from decomp_tpu_torch.models import nmf as _nmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.parallel import mesh as _mesh
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import acc_dtype, real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.result import NMFResult


def solve(
    y,
    d=None,
    *,
    rank: Optional[int] = None,
    x=None,
    mesh,
    row_axis="rows",
    col_axis=None,
    tol=1e-4,
    maxiter: int = 1000,
    method: str = "mu",
    mask=None,
    random_seed: int = 0,
    eps: float = 1e-15,
    record_objective: bool = False,
    precision: str = "highest",
    factor_dtype=None,
    use_kernel="auto",
    kernel_block_rows: Optional[int] = None,
    check_every: int = 1,
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    _val=None,
) -> NMFResult:
    """Sharded ``y ≈ x @ d`` with nonnegative factors: the contract of
    ``decomp_tpu_torch.nmf.solve`` (full batch: methods 'mu', 'kl-mu' and
    'hals', masked or not, ``factor_dtype``, held-out stopping), computed
    SPMD over ``mesh``. Every rank of the process group calls it with its
    own blocks: ``y`` and ``mask`` its (row, col) block, ``x`` its rows,
    ``d`` its column block (the same on every rank of a column). Every
    rank's blocks have the same shapes; the global matrix is
    (rows x extent of ``row_axis``, columns x extent of ``col_axis``).
    Host arrays go to the rank's device (``parallel.mesh.local_device``);
    a tensor must be on it. ``row_axis`` and ``col_axis`` may each be a
    tuple of mesh dims (hierarchical sharding; see ``parallel.mesh``).

    Returns the rank's blocks of ``x`` and ``d``; ``niter``, ``converged``,
    ``objective`` and ``aux['heldout_rel_err']`` are global and the same on
    every rank. An invalid argument raises ``DecompError`` on every rank.

    use_kernel : True / False / 'auto', as in ``nmf.solve``: the kernel of
        the method on each rank's rows, with the statistics summed over
        the row axis before the d epilogue. Row sharding only: with a
        column axis the x update needs a reduction in mid-iteration, so
        the composition runs ('auto') or the call is refused (True).
    random_seed : seed of the random init, where ``d`` or ``x`` is None:
        each rank draws its blocks from a generator whose seed folds in its
        column coordinate (d, the same across a column) or its row
        coordinate (x), scaled by the all-reduced mean of the observed
        data; and (salted) of the held-out reserve, which is the global
        draw of ``nmf.solve`` on the whole matrix, whatever the number of
        ranks (each rank replays the generator up to its last row).
    stop : 'rel_change' or 'heldout' (requires a mask; ``check_every``
        defaults to 25), with the validation error summed over every rank.
    _val : private: the rank's block of a given global validation reserve
        (0/1, inside ``mask``) instead of the seeded draw.
    """
    _mesh.require_process_group()
    prep, err = None, None
    try:
        prep = _prepare(y, d, rank, x, mesh, row_axis, col_axis, method,
                        mask, precision, factor_dtype, use_kernel,
                        kernel_block_rows, stop, heldout_frac, check_every,
                        record_objective, _val)
    except ValueError as e:
        err = e
    _mesh.agree(err, None if prep is None else prep["signature"])
    y, d, x, mask, val = (prep[k] for k in ("y", "d", "x", "mask", "val"))
    m_loc, n_loc = y.shape
    n_rows, n_cols = prep["n_rows"], prep["n_cols"]
    shape = (m_loc * n_rows, n_loc * n_cols)
    row_i = _mesh.axis_index(mesh, row_axis)
    col_i = 0 if col_axis is None else _mesh.axis_index(mesh, col_axis)
    red_r = _mesh.reducer(mesh, row_axis)
    red_c = None if col_axis is None else _mesh.reducer(mesh, col_axis)

    def red_all(t):
        t = red_r(t)
        return t if red_c is None else red_c(t)

    if prep["stop"] == "heldout" and val is None:
        val = _nmf._heldout_block(mask, float(heldout_frac), int(random_seed),
                                  shape, row_i * m_loc, col_i * n_loc)
    rank = prep["rank"]
    fdt = prep["fdt"]

    def init(my, d_, x_):
        # Scale from the observed data's global mean, as nmf.solve's init.
        rdt = real_dtype(my.dtype)
        total = red_all(torch.sum(my, dtype=acc_dtype(rdt)).reshape(1))[0]
        mean = torch.clamp(total / (shape[0] * shape[1]),
                           min=torch.finfo(rdt).tiny)
        scale = torch.sqrt(2.0 * mean / rank).to(fdt)
        if d_ is None:
            d_ = scale * torch.rand((rank, n_loc), generator=_generator(
                random_seed, 0, col_i, my.device), dtype=fdt,
                device=my.device)
        if x_ is None:
            x_ = scale * torch.rand((m_loc, rank), generator=_generator(
                random_seed, 1, row_i, my.device), dtype=fdt,
                device=my.device)
        return d_, x_

    return _nmf._solve(
        y, d, x, mask, val, rank=rank, method=method, tol=float(tol),
        eps=float(eps), maxiter=int(maxiter),
        record_objective=bool(record_objective),
        factor_dtype=prep["factor_dtype"], use_kernel=prep["use_kernel"],
        kernel_block_rows=kernel_block_rows,
        check_every=prep["check_every"], random_seed=int(random_seed),
        reduce_rows=red_r, reduce_cols=red_c, init=init)


def _generator(seed, what, coord, device):
    """A generator on ``device`` seeded with ``seed`` folded with the
    draw's tag (0 for d, 1 for x) and the rank's coordinate."""
    folded = np.random.SeedSequence(
        [int(seed) % 2 ** 64, what, coord]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(folded))


def _prepare(y, d, rank, x, mesh, row_axis, col_axis, method, mask,
             precision, factor_dtype, use_kernel, kernel_block_rows, stop,
             heldout_frac, check_every, record_objective, val):
    """``solve``'s checks on this rank's arguments, which place them on the
    rank's device; returns what the solve needs and the ``signature`` of
    the blocks that every rank must share."""
    if method not in _nmf._METHODS:
        raise DecompError(f"method must be one of {_nmf._METHODS}, got "
                          f"{method!r}")
    if precision not in _nmf._PRECISIONS:
        raise DecompError(f"precision must be one of {_nmf._PRECISIONS}, "
                          f"got {precision!r}")
    dev = _mesh.placement(mesh, y)
    y = _device.on_device("y", y, dev)
    assertion.assert_ndim("y", y, 2)
    assertion.assert_inexact("y", y)
    assertion.assert_real("y", y)
    n_rows = _mesh.validate_axis(mesh, row_axis, "row_axis")
    n_cols = (1 if col_axis is None
              else _mesh.validate_axis(mesh, col_axis, "col_axis"))
    if col_axis is not None and (set(_mesh.axis_tuple(row_axis))
                                 & set(_mesh.axis_tuple(col_axis))):
        raise DecompError(f"row_axis {row_axis!r} and col_axis {col_axis!r} "
                          "share a mesh axis")
    m_loc, n_loc = y.shape

    factor_dtype = _nmf._checked_factor_dtype(factor_dtype, y, method)
    fdt = y.dtype if factor_dtype is None else factor_dtype

    if d is None and rank is None:
        raise DecompError("provide an initial dictionary `d` or a `rank`")
    if d is not None:
        d = _device.on_device("d", d, dev, fdt)
        assertion.assert_ndim("d", d, 2)
        assertion.assert_axis_size("d", d, 1, n_loc, "n_channels (block)")
        if rank is not None and d.shape[0] != rank:
            raise DecompError(
                f"rank={rank} inconsistent with d.shape[0]={d.shape[0]}")
        rank = d.shape[0]
    rank = int(rank)
    if x is not None:
        x = _device.on_device("x", x, dev, fdt)
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, m_loc, "n_samples (block)")
        assertion.assert_axis_size("x", x, 1, rank, "rank")
    if mask is not None:
        mask = _device.on_device("mask", mask, dev)
        assertion.assert_same_shape("mask", mask, "y", y)
        mask = mask.to(y.dtype)
    if method == "hals" and mask is not None:
        raise DecompError("method 'hals' does not support mask; use 'mu'")
    cuda_mu.validate_block_rows(kernel_block_rows)

    if use_kernel == "auto":
        # nmf.solve's gate on the rank's block, row sharding only.
        use_kernel = (col_axis is None
                      and y.is_cuda
                      and method in ("mu", "kl-mu")
                      and y.dtype in (torch.bfloat16, torch.float32)
                      and (method == "mu" or factor_dtype is None)
                      and fdt in (y.dtype, torch.float32)
                      and _nmf._auto_rank(method, y.shape[1], rank, y.dtype,
                                          mask is not None, fdt))
    use_kernel = bool(use_kernel)
    if use_kernel and col_axis is not None:
        raise DecompError("use_kernel=True requires col_axis=None (row-only "
                          "sharding): with a column axis the x update needs "
                          "a reduction in mid-iteration, which the kernels "
                          "do not take")
    if use_kernel and method not in ("mu", "kl-mu"):
        raise DecompError("use_kernel=True supports methods 'mu'/'kl-mu'")
    if use_kernel and method != "mu" and factor_dtype is not None:
        raise DecompError(f"use_kernel=True with method={method!r} does not "
                          "support factor_dtype")
    if use_kernel:
        cuda_mu.check_rank(method, y.shape[1], rank, y.dtype,
                           mask is not None)

    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', got "
                          f"{stop!r}")
    if stop == "heldout":
        check_every = _nmf._heldout_check_every(
            mask, method, record_objective, heldout_frac, check_every)
        if val is not None:
            val = _device.on_device("_val", val, dev, mask.dtype)
            assertion.assert_same_shape("_val", val, "y", y)
    else:
        val = None
    signature = tuple((tuple(t.shape), str(t.dtype)) if t is not None
                      else None for t in (y, d, x, mask, val)) + (rank,)
    return dict(y=y, d=d, x=x, mask=mask, val=val, rank=rank, fdt=fdt,
                factor_dtype=factor_dtype, use_kernel=use_kernel,
                n_rows=n_rows, n_cols=n_cols, stop=stop,
                check_every=int(check_every), signature=signature)



# The sharded out-of-core solver, as decomp_tpu re-exports it here
# (decomp_tpu/parallel/nmf.py:501).
from decomp_tpu_torch.parallel.nmf_streaming import (  # noqa: E402,F401
    solve_streaming)
