"""Non-negative matrix factorisation by multiplicative updates (counterpart
of ``decomp_tpu.models.nmf``; dense ``method='mu'`` so far).

    y ≈ x @ d,  x >= 0, d >= 0
    x <- x * (y @ d.T) / (x @ (d @ d.T) + eps)
    d <- d * (x.T @ y) / ((x.T @ x) @ d + eps)

Full batch, with ``inner_iter`` x refinements per d update and the
mixed-precision mode (``factor_dtype``: e.g. bf16 data, f32 factors). Two
paths run the same update: the kernel path (``use_kernel``), whose x
update and d statistics are one call of ``ops.cuda_mu.mu_stats_dense``
(a CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor), and the
composition path of plain torch products.

Everything runs on ``y``'s device; tensors on another device are refused,
never moved. Not ported yet, and refused with ``DecompError``: ``mask``,
methods other than ``'mu'``, ``minibatch``, ``stop='heldout'``,
``masked_completion`` and ``solve_streaming``.
"""

from typing import Optional

import torch

from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.ops.loop import run_iterations
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils.dtypes import acc_dtype, real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.normalize import l2_norm
from decomp_tpu_torch.utils.result import NMFResult

_METHODS = ("mu", "kl-mu", "hals")
_PRECISIONS = ("default", "high", "highest", "bfloat16", "tensorfloat32",
               "float32", "fastest")
# Rows per chunk where a product upcasts compute-dtype data: bounds the
# f32 temporaries to a chunk instead of all of y.
_CHUNK_ROWS = 8192


def _not_ported(what, item):
    return DecompError(f"{what} is not ported to decomp_tpu_torch yet "
                       f"(ROADMAP Queue 1 #{item}); use decomp_tpu")


def _validate_inner_iter(inner_iter):
    """inner_iter must be a positive integer (0 would skip every x
    update)."""
    import numpy as np

    if (not isinstance(inner_iter, (int, np.integer))
            or isinstance(inner_iter, bool) or int(inner_iter) < 1):
        raise DecompError(
            f"inner_iter must be a positive integer, got {inner_iter!r}")
    return int(inner_iter)


def _on_device(name, t, dtype, device):
    t = torch.as_tensor(t)
    if t.device != device:
        raise DecompError(f"{name} is on {t.device} but y is on {device}; "
                          "move it explicitly")
    return t.to(dtype)


def solve(
    y,
    d=None,
    *,
    rank: Optional[int] = None,
    x=None,
    tol=1e-4,
    maxiter: int = 1000,
    method: str = "mu",
    mask=None,
    minibatch: Optional[int] = None,
    inner_iter: int = 1,
    random_seed: int = 0,
    eps: float = 1e-15,
    record_objective: bool = False,
    precision: str = "highest",
    factor_dtype=None,
    use_kernel="auto",
    kernel_block_rows: Optional[int] = None,
    check_every: int = 1,
    verbose: bool = False,
    stop: str = "rel_change",
) -> NMFResult:
    """Factorise ``y ≈ x @ d`` with nonnegative factors.

    Parameters
    ----------
    y : (n_samples, n_channels) real tensor (bf16, f32 or f64).
    d : (rank, n_channels) initial dictionary (warm start). One of ``d``
        or ``rank`` is required.
    rank : target rank for random initialisation when ``d`` is None.
    x : (n_samples, rank) initial activations (warm start).
    tol : relative change of ``d`` below which iteration stops (0 = run
        all ``maxiter`` iterations, with no host read per iteration).
    method : 'mu' (Lee-Seung multiplicative updates, L2 loss). 'kl-mu'
        and 'hals' are not ported yet.
    mask, minibatch, stop='heldout' : not ported yet; raise DecompError.
    inner_iter : x updates per d update; the extra refinements reuse the
        y @ d.T numerator (accelerated MU).
    random_seed : seed of the initial factors, drawn from
        ``torch.Generator(device=y.device).manual_seed(random_seed)``.
        The draw cannot reproduce ``jax.random``'s bits, so a seeded
        trajectory differs from ``decomp_tpu``'s: pass ``x`` and ``d`` to
        compare the two.
    eps : additive denominator guard of the multiplicative updates.
    record_objective : record 0.5*||y - x@d||^2 per iteration.
    precision : accepted for ``decomp_tpu`` compatibility and without
        effect: f32 products here are always full f32 (never TF32), and
        bf16 products always sum in f32.
    factor_dtype : store x and d in this wider dtype while y and every
        product's operands stay in y's dtype (bf16 data, f32 factors is
        the converging high-throughput operating point).
    use_kernel : True / False / 'auto'. The kernel path computes the x
        update and the d statistics in one ``mu_stats_dense`` call: on a
        CUDA tensor the hand-written kernel, on a CPU tensor its plain
        twin. 'auto' engages it for a CUDA ``y`` of dtype bf16 or f32 with
        factors in y's dtype or f32 and rank <= 128, and is False on CPU.
    kernel_block_rows : rows per partial of the kernel's statistics pass
        (on CPU, rows per chunk of the twin); a positive multiple of 8.
    check_every : evaluate the stopping rule every this many iterations.
    verbose : print the iteration index and diff at every check.

    Returns
    -------
    NMFResult(x, d, niter, converged, objective)
    """
    if method not in _METHODS:
        raise DecompError(f"method must be one of {_METHODS}, got {method!r}")
    if method != "mu":
        raise _not_ported(f"method={method!r}", 3)
    if mask is not None:
        raise _not_ported("mask", 3)
    if minibatch is not None:
        raise _not_ported("minibatch", 3)
    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', "
                          f"got {stop!r}")
    if stop == "heldout":
        raise _not_ported("stop='heldout'", 3)
    if precision not in _PRECISIONS:
        raise DecompError(f"precision must be one of {_PRECISIONS}, "
                          f"got {precision!r}")
    y = torch.as_tensor(y)
    assertion.assert_ndim("y", y, 2)
    assertion.assert_inexact("y", y)
    assertion.assert_real("y", y)
    n_samples, n_channels = y.shape

    if factor_dtype is not None:
        if not isinstance(factor_dtype, torch.dtype):
            raise DecompError("factor_dtype must be a torch.dtype, got "
                              f"{factor_dtype!r}")
        if factor_dtype == y.dtype:
            factor_dtype = None  # no-op request
    if factor_dtype is not None:
        if not factor_dtype.is_floating_point:
            raise DecompError("factor_dtype must be a float dtype")
        if torch.finfo(factor_dtype).bits < torch.finfo(y.dtype).bits:
            raise DecompError(
                "factor_dtype must be at least as wide as y's dtype "
                f"(got {factor_dtype} factors for {y.dtype} data)")
    fdt = y.dtype if factor_dtype is None else factor_dtype

    if d is None and rank is None:
        raise DecompError("provide an initial dictionary `d` or a `rank`")
    if d is not None:
        d = _on_device("d", d, fdt, y.device)
        assertion.assert_ndim("d", d, 2)
        assertion.assert_axis_size("d", d, 1, n_channels, "n_channels")
        if rank is not None and d.shape[0] != rank:
            raise DecompError(
                f"rank={rank} inconsistent with d.shape[0]={d.shape[0]}")
        rank = d.shape[0]
    if x is not None:
        x = _on_device("x", x, fdt, y.device)
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, n_samples, "n_samples")
        assertion.assert_axis_size("x", x, 1, rank, "rank")
    inner_iter = _validate_inner_iter(inner_iter)
    cuda_mu.validate_block_rows(kernel_block_rows)

    if use_kernel == "auto":
        use_kernel = (y.is_cuda
                      and y.dtype in (torch.bfloat16, torch.float32)
                      and fdt in (y.dtype, torch.float32)
                      and rank <= cuda_mu.KERNEL_MAX_RANK)
    return _solve(
        y, d, x, rank=int(rank), tol=float(tol), eps=float(eps),
        maxiter=int(maxiter), inner_iter=inner_iter,
        record_objective=bool(record_objective), factor_dtype=factor_dtype,
        use_kernel=bool(use_kernel), kernel_block_rows=kernel_block_rows,
        check_every=int(check_every), verbose=bool(verbose),
        random_seed=int(random_seed))


def _solve(y, d, x, *, rank, tol, eps, maxiter, inner_iter,
           record_objective, factor_dtype, use_kernel, kernel_block_rows,
           check_every, verbose, random_seed):
    rdt = real_dtype(y.dtype)
    # eps guards f32 (or wider) denominators in mixed mode; it is rounded
    # to that dtype as the JAX package rounds it.
    eps_t = torch.tensor(eps, dtype=real_dtype(factor_dtype)
                         if factor_dtype is not None else rdt)
    if d is None or x is None:
        gen = torch.Generator(device=y.device).manual_seed(random_seed)
        d, x = _init_factors(gen, y, d, x, rank, factor_dtype)
    acc = acc_dtype(rdt)
    tiny = torch.finfo(acc).tiny

    def diff_fn(old, new):
        d_old = old[1].to(acc)
        d_new = new[1].to(acc)
        return l2_norm(d_new - d_old) / torch.clamp(l2_norm(d_old), min=tiny)

    def objective(state):
        return 0.5 * _sq_resid(y, state[0], state[1], acc)

    if use_kernel:
        cdt = y.dtype
        eps_k = float(eps_t)

        def step(state, it):
            x_, d_ = state
            return cuda_mu.mu_update_dense(
                y, x_, d_.to(cdt), eps_k, block_rows=kernel_block_rows,
                d_master=d_, inner_iter=inner_iter)
    else:
        if factor_dtype is not None:
            upd_x, upd_d = _update_x_mixed, _update_d_mixed
        else:
            upd_x, upd_d = _update_x, _update_d

        def step(state, it):
            x_, d_ = state
            for _ in range(inner_iter):
                x_ = upd_x(y, x_, d_, eps_t)
            return (x_, upd_d(y, x_, d_, eps_t))

    res = run_iterations(
        step, (x, d), tol=tol, maxiter=maxiter, diff_fn=diff_fn,
        objective_fn=objective, record_objective=record_objective,
        check_every=check_every, verbose=verbose)
    return NMFResult(x=res.state[0], d=res.state[1], niter=res.niter,
                     converged=res.converged, objective=res.objective)


def masked_completion(*args, **kwargs):
    """Not ported yet: masked MU and held-out stopping come first."""
    raise _not_ported("masked_completion", 3)


def solve_streaming(*args, **kwargs):
    """Not ported yet: one H100 holds the config-5 matrix in-core."""
    raise _not_ported("solve_streaming", 7)


def _sq_resid(y, x, d, acc):
    """||y - x@d||^2 in ``acc``, one row chunk at a time (no M x N
    temporary in ``acc``)."""
    total = torch.zeros((), dtype=acc, device=y.device)
    for s in range(0, y.shape[0], _CHUNK_ROWS):
        r = y[s:s + _CHUNK_ROWS].to(acc) - (x[s:s + _CHUNK_ROWS] @ d).to(acc)
        total = total + torch.sum(r * r)
    return total


def _update_x(my, x, d, eps):
    """One multiplicative x update, all in the factors' dtype."""
    return x * (my @ d.T) / (x @ (d @ d.T) + eps)


def _update_d(my, x, d, eps):
    """One multiplicative d update, all in the factors' dtype."""
    return d * (x.T @ my) / ((x.T @ x) @ d + eps)


def _rows_dot(a, b):
    """``a @ b`` with compute-dtype operands summed in f32 (the products of
    bf16 operands are exact in f32), one row chunk of ``a`` at a time."""
    w = torch.promote_types(a.dtype, torch.float32)
    bw = b.to(w)
    return torch.cat([(a[s:s + _CHUNK_ROWS].to(w) @ bw).to(torch.float32)
                      for s in range(0, a.shape[0], _CHUNK_ROWS)])


def _tdot(a, b):
    """``a.T @ b`` like ``_rows_dot``, summed over row chunks in f32."""
    w = torch.promote_types(a.dtype, torch.float32)
    out = None
    for s in range(0, a.shape[0], _CHUNK_ROWS):
        part = (a[s:s + _CHUNK_ROWS].to(w).T
                @ b[s:s + _CHUNK_ROWS].to(w)).to(torch.float32)
        out = part if out is None else out + part
    return out


def _update_x_mixed(my, x, d, eps):
    """Mixed-precision x update (factor_dtype mode): x and d are stored
    wide, every product takes compute-dtype (= my.dtype) operands and sums
    in f32, d d^T is cast to the compute dtype at use."""
    cdt = my.dtype
    db = d.to(cdt)
    num = _rows_dot(my, db.T)
    ddt = cuda_mu.gram_rows(db)
    den = _rows_dot(x.to(cdt), ddt.to(cdt))
    return x * num / (den + eps)


def _update_d_mixed(my, x, d, eps):
    """Mixed-precision d update; the K x K @ K x N epilogue is full f32."""
    cdt = my.dtype
    xb = x.to(cdt)
    num = _tdot(xb, my)
    den = _tdot(xb, xb) @ d.to(torch.float32)
    return d * num / (den + eps)


def _init_factors(gen, y, d, x, rank, factor_dtype=None):
    """Random nonnegative init scaled so x @ d matches y's magnitude. The
    mean of y accumulates in >= f32 without an f32 copy of y."""
    fdt = y.dtype if factor_dtype is None else factor_dtype
    rdt = real_dtype(y.dtype)
    mean_y = torch.clamp(torch.mean(y, dtype=acc_dtype(rdt)),
                         min=torch.finfo(rdt).tiny)
    scale = torch.sqrt(2.0 * mean_y / rank).to(fdt)
    if d is None:
        d = scale * torch.rand((rank, y.shape[1]), generator=gen, dtype=fdt,
                               device=y.device)
    if x is None:
        x = scale * torch.rand((y.shape[0], rank), generator=gen, dtype=fdt,
                               device=y.device)
    return d, x
