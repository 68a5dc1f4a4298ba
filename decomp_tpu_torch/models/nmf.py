"""Non-negative matrix factorisation (counterpart of
``decomp_tpu.models.nmf``).

    y ≈ x @ d,  x >= 0, d >= 0
    x <- x * (y @ d.T) / (x @ (d @ d.T) + eps)
    d <- d * (x.T @ y) / ((x.T @ x) @ d + eps)

Masked variant (mask == 1 observed, 0 missing): ``y`` becomes ``my = mask *
y`` and every reconstruction ``x @ d`` becomes ``mask * (x @ d)``.
``method='kl-mu'`` runs the Lee-Seung updates of the generalised KL
divergence instead, and ``method='hals'`` hierarchical alternating least
squares (exact per-component updates of the L2 loss, unmasked full batch
only): a host loop over the K components, each a matrix-vector product
and a few elementwise passes, on x held column-major during its sweep.
Full batch, with ``inner_iter`` x refinements per d update, the
mixed-precision mode (``factor_dtype``: e.g. bf16 data, f32 factors) and
held-out stopping (``stop='heldout'``; the ``masked_completion`` preset);
or online (``minibatch``: 'mu' and 'kl-mu', masked or not, d updated from
statistics that decay by ``forget``). Two paths run the full-batch MU and
KL updates: the kernel path (``use_kernel``), whose x update and d
statistics are one call of an ``ops.cuda_mu`` kernel (``mu_stats_dense``,
``mu_stats_masked``, ``kl_stats_dense`` or ``kl_stats_masked``: the CUDA
kernel on a CUDA tensor, its plain twin on a CPU tensor), and the
composition path of plain torch products. HALS and the minibatch variant
are compositions, as in ``decomp_tpu``.

Entry points run on the card unless the caller asks for the CPU: a tensor
``y`` stays on its device, host arrays go to ``device=`` or, by default,
the CUDA device, and with no CUDA device and no ``device`` they raise
(``utils.device``). The companions follow ``y``; a tensor on another device
is refused, never moved. Out of core, ``solve_streaming`` and
``masked_completion_streaming`` (``models.nmf_streaming``) stream row chunks
of host arrays or loaders through the device. ``masked_completion(mesh=...)``
runs the sharded solve of ``parallel.nmf``, which runs ``_solve`` on each
rank's block with the reduction hooks of the updates below.
"""

import functools
from typing import Optional

import torch

from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.ops.loop import run_iterations
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import acc_dtype, real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.normalize import l2_norm
from decomp_tpu_torch.utils.result import NMFResult

# Salt of the held-out reserve's seed (ascii 'held', as decomp_tpu's
# _HELDOUT_SALT): a mask the caller draws from manual_seed(random_seed)
# must not reuse the reserve's uniforms, or a mask u >= 0.3 makes the
# u < 0.05 reserve exactly empty.
_HELDOUT_SALT = 0x68656C64
_METHODS = ("mu", "kl-mu", "hals")
_PRECISIONS = ("default", "high", "highest", "bfloat16", "tensorfloat32",
               "float32", "fastest")
# Rows per chunk where a product upcasts compute-dtype data or a sum runs
# over all of y: bounds the temporaries to a chunk instead of all of y.
_CHUNK_ROWS = 8192
# Where 'auto' sends MU and KL-MU above rank 128 to csrc/mu_wide.cu (inside
# the TPU kernels' gate, cuda_mu.rank_fits): the (method, data, factor)
# dtypes and the widths N from which the card measured one solver
# iteration on the wide route no slower than on the composition (PERF.md
# §6 rows 1-4; in turns on an H100 at rank 256, tools/mu_wide_turns.py and
# tools/kl_wide_turns.py, and at the gates' corners). MU: bf16 data with
# f32 factors (factor_dtype): 0.08-0.41x at every N from 64 to 4,096 and
# at every corner, dense or masked: the mixed
# composition upcasts each product's operands. f32: 0.56-0.95x from N =
# 256 to 4,096 and at the corners at N = 1,024; at N = 64 and 128
# 0.99-1.32x (0.71x only at the dense corner, K = 10,624), where the
# route's 7-9 launches outweigh the products. Masked f32 on the six
# launches of its merged passes: 0.44-0.66x from N = 256, 0.71-1.02x
# at N = 64 and 128, 0.97x on bits and 1.01x on weights at N = 128's
# corner; the key holds no mask, and dense stays above 1x there, so the
# rule stays. bf16 data with bf16 factors: 1.1-3.7x, so the composition
# (plain bf16 products) stays.
# KL-MU (the KL kernels take no factor_dtype): f32 0.55-0.82x from N =
# 256 to 1,024 and at the KL gate's corners there, dense, on a 0/1 mask
# and on weights; at N = 64 1.19-1.21x, at N = 128 0.91-0.95x at K = 256
# but 1.21-1.42x at the corner (K = 4,480 / 3,456). bf16: 1.27-3.63x
# (cuBLAS's bf16 products; once 0.90x, where the composition's two turns
# read 1.59 and 0.61 ms), so bf16 stays on the composition.
_AUTO_WIDE_RANK_MIN_N = {("mu", torch.bfloat16, torch.float32): 1,
                         ("mu", torch.float32, torch.float32): 256,
                         ("kl-mu", torch.float32, torch.float32): 256}


def _auto_rank(method, n, rank, dtype, masked, fdt):
    """Whether ``use_kernel='auto'`` takes the kernels of ``method`` at
    ``rank`` with N columns of ``dtype`` data and ``fdt`` factors: always up
    to ``cuda_mu.KERNEL_MAX_RANK`` (the fused kernels); above it the wide
    route (``csrc/mu_wide.cu``) inside the gate
    (``cuda_mu.kernel_takes_rank``) for the (method, data, factor) dtypes
    of ``_AUTO_WIDE_RANK_MIN_N`` at N at least its value. ``use_kernel=True``
    takes every rank ``kernel_takes_rank`` takes. The sharded solve and
    loader mode decide through the same two."""
    if cuda_mu.rank_route(rank) == "fused":
        return rank >= 1
    min_n = _AUTO_WIDE_RANK_MIN_N.get((method, dtype, fdt))
    return (min_n is not None and n >= min_n
            and cuda_mu.kernel_takes_rank(method, n, rank, dtype, masked))


def _identity(t):
    """The sum over one rank: a one-process solve's reduction hook."""
    return t


def _validate_inner_iter(inner_iter):
    """inner_iter must be a positive integer (0 would skip every x
    update)."""
    import numpy as np

    if (not isinstance(inner_iter, (int, np.integer))
            or isinstance(inner_iter, bool) or int(inner_iter) < 1):
        raise DecompError(
            f"inner_iter must be a positive integer, got {inner_iter!r}")
    return int(inner_iter)


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
    forget: float = 0.9,
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
    heldout_frac: float = 0.05,
    device=None,
) -> NMFResult:
    """Factorise ``y ≈ x @ d`` with nonnegative factors.

    Parameters
    ----------
    y : (n_samples, n_channels) real tensor (bf16, f32 or f64). Missing
        entries may hold any finite value if ``mask`` marks them 0.
    d : (rank, n_channels) initial dictionary (warm start). One of ``d``
        or ``rank`` is required.
    rank : target rank for random initialisation when ``d`` is None.
    x : (n_samples, rank) initial activations (warm start).
    tol : relative change of ``d`` below which iteration stops (0 = run
        all ``maxiter`` iterations, with no host read per iteration).
    method : 'mu' (Lee-Seung multiplicative updates, L2 loss), 'kl-mu'
        (Lee-Seung updates of the generalised KL divergence) or 'hals'
        (hierarchical alternating least squares, L2 loss: exact
        per-component updates, unmasked full batch only; a component
        whose Gram diagonal is not above eps times the Gram's trace
        keeps its value).
    mask : (n_samples, n_channels) 1/0 or bool tensor on y's device;
        1 = observed. Cast to y's dtype.
    minibatch : if set ('mu' and 'kl-mu'), each iteration draws this many
        rows with replacement, refreshes their x with ``inner_iter``
        updates, writes them back, and updates d from K x N statistics
        that decay by ``forget`` and gain the batch's.
    inner_iter : x updates per d update; for dense 'mu' the extra
        refinements reuse the y @ d.T numerator (accelerated MU); for
        'hals' x sweeps per d sweep.
    forget : decay of the minibatch statistics per iteration.
    random_seed : seed of the initial factors and then of the minibatch
        rows, drawn in turn from one
        ``torch.Generator(device=y.device).manual_seed(random_seed)``,
        and (salted) of the held-out reserve. The draws cannot reproduce
        ``jax.random``'s bits, so a seeded trajectory differs from
        ``decomp_tpu``'s: pass ``x`` and ``d`` to compare the two.
    eps : additive denominator guard of the multiplicative updates.
    record_objective : record the objective per iteration: 0.5 *
        ||mask * (y - x@d)||^2 for 'mu' and 'hals', the KL divergence for
        'kl-mu'.
    precision : accepted for ``decomp_tpu`` compatibility and without
        effect: f32 products here keep f32 accuracy (never TF32): full f32,
        except masked 'kl-mu' on f32 data with a 0/1 mask on the card,
        whose kernel runs them as bf16x6 limb products on the tensor cores
        (as the TPU's ``Precision.HIGHEST`` does), held to the f32
        kernels' agreement limit with the full-f32 twin. bf16 products
        always sum in f32.
    factor_dtype : store x and d in this wider dtype while y and every
        product's operands stay in y's dtype (bf16 data, f32 factors is
        the converging high-throughput operating point). 'mu' and 'kl-mu'.
    use_kernel : True / False / 'auto'. The kernel path computes the x
        update and the d statistics in one ``ops.cuda_mu`` call: on a
        CUDA tensor the hand-written kernel, on a CPU tensor its plain
        twin. 'auto' engages it for a CUDA ``y`` of dtype bf16 or f32 with
        rank <= 128 (above it, where ``_auto_rank`` says the card measured
        the wide route no slower), factors in y's dtype or f32 ('kl-mu':
        y's dtype only), and ``inner_iter == 1`` unless dense 'mu'; it is
        False on CPU, for 'hals' and with ``minibatch``, which run
        compositions. True takes 'mu' and 'kl-mu' up to the TPU kernels'
        gate (``cuda_mu.kernel_takes_rank``, ``cuda_mu.rank_fits``), and
        raises ``ShapeError`` past it, before any launch.
    kernel_block_rows : rows per partial of the kernel's statistics pass
        (on CPU, rows per chunk of the twin); a positive multiple of 8.
    check_every : evaluate the stopping rule every this many iterations.
    verbose : print the iteration index and diff at every check.
    stop : 'rel_change' (relative change of ``d``) or 'heldout': reserve
        ``heldout_frac`` of the observed entries as a validation set,
        train on the rest, and stop when the validation error's relative
        improvement per check falls below ``tol`` or the error rises.
        Requires a mask; ``check_every`` defaults to 25;
        ``record_objective`` is refused. ``aux["heldout_rel_err"]`` holds
        the final relative validation error.
    heldout_frac : fraction of the observed entries reserved under
        stop='heldout'.
    device : where host-array inputs go (default the CUDA device; see
        ``utils.device``). A tensor ``y`` stays on its device.

    Returns
    -------
    NMFResult(x, d, niter, converged, objective, aux)
    """
    if method not in _METHODS:
        raise DecompError(f"method must be one of {_METHODS}, got {method!r}")
    if precision not in _PRECISIONS:
        raise DecompError(f"precision must be one of {_PRECISIONS}, "
                          f"got {precision!r}")
    y = _device.on_device("y", y, _device.resolve(y, device))
    assertion.assert_ndim("y", y, 2)
    assertion.assert_inexact("y", y)
    assertion.assert_real("y", y)
    n_samples, n_channels = y.shape

    factor_dtype = _checked_factor_dtype(factor_dtype, y, method)
    if factor_dtype is not None and minibatch is not None:
        raise DecompError("factor_dtype is incompatible with minibatch")
    fdt = y.dtype if factor_dtype is None else factor_dtype

    if d is None and rank is None:
        raise DecompError("provide an initial dictionary `d` or a `rank`")
    if d is not None:
        d = _device.on_device("d", d, y.device, fdt)
        assertion.assert_ndim("d", d, 2)
        assertion.assert_axis_size("d", d, 1, n_channels, "n_channels")
        if rank is not None and d.shape[0] != rank:
            raise DecompError(
                f"rank={rank} inconsistent with d.shape[0]={d.shape[0]}")
        rank = d.shape[0]
    if x is not None:
        x = _device.on_device("x", x, y.device, fdt)
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, n_samples, "n_samples")
        assertion.assert_axis_size("x", x, 1, rank, "rank")
    if mask is not None:
        mask = _device.on_device("mask", mask, y.device)
        assertion.assert_same_shape("mask", mask, "y", y)
        mask = mask.to(y.dtype)
    if minibatch is not None:
        minibatch = int(minibatch)
        if not 0 < minibatch <= n_samples:
            raise DecompError(f"minibatch must be in [1, n_samples="
                              f"{n_samples}], got {minibatch}")
    inner_iter = _validate_inner_iter(inner_iter)
    cuda_mu.validate_block_rows(kernel_block_rows)

    if use_kernel == "auto":
        use_kernel = (y.is_cuda
                      and minibatch is None
                      and method in ("mu", "kl-mu")
                      and y.dtype in (torch.bfloat16, torch.float32)
                      and (inner_iter == 1
                           or (method == "mu" and mask is None))
                      and (method == "mu" or factor_dtype is None)
                      and fdt in (y.dtype, torch.float32)
                      and _auto_rank(method, n_channels, rank, y.dtype,
                                     mask is not None, fdt))
    use_kernel = bool(use_kernel)
    if use_kernel and minibatch is not None:
        raise DecompError("use_kernel=True is incompatible with minibatch")
    if use_kernel and method not in ("mu", "kl-mu"):
        raise DecompError("use_kernel=True supports methods 'mu'/'kl-mu' "
                          "(HALS runs its component sweeps as a "
                          "composition, as decomp_tpu does)")
    if use_kernel and method != "mu" and factor_dtype is not None:
        raise DecompError(f"use_kernel=True with method={method!r} does "
                          "not support factor_dtype")
    if use_kernel and inner_iter != 1 and (method != "mu"
                                           or mask is not None):
        raise DecompError("use_kernel=True supports inner_iter > 1 only "
                          "for dense method='mu' (the masked/KL "
                          "denominators need fresh data passes)")
    if use_kernel:
        cuda_mu.check_rank(method, n_channels, rank, y.dtype,
                           mask is not None)
    if method == "hals" and mask is not None:
        raise DecompError("method 'hals' does not support mask; use 'mu'")
    if method == "hals" and minibatch is not None:
        raise DecompError("method 'hals' does not support minibatch; "
                          "use 'mu'")
    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', "
                          f"got {stop!r}")
    val = None
    if stop == "heldout":
        check_every = _heldout_check_every(mask, method, record_objective,
                                           heldout_frac, check_every)
        if minibatch is not None:
            raise DecompError("stop='heldout' is incompatible with "
                              "minibatch")
        val = _heldout_reserve(mask, float(heldout_frac), int(random_seed))
    return _solve(
        y, d, x, mask, val, rank=int(rank), method=method, tol=float(tol),
        eps=float(eps), maxiter=int(maxiter), inner_iter=inner_iter,
        record_objective=bool(record_objective), factor_dtype=factor_dtype,
        use_kernel=use_kernel, kernel_block_rows=kernel_block_rows,
        check_every=int(check_every), verbose=bool(verbose),
        random_seed=int(random_seed), minibatch=minibatch,
        forget=float(forget))


def _checked_factor_dtype(factor_dtype, y, method):
    """``factor_dtype`` after ``solve``'s checks (a float dtype at least as
    wide as y's, for 'mu' and 'kl-mu'); None for y's own dtype."""
    if factor_dtype is None:
        return None
    if not isinstance(factor_dtype, torch.dtype):
        raise DecompError("factor_dtype must be a torch.dtype, got "
                          f"{factor_dtype!r}")
    if factor_dtype == y.dtype:
        return None  # no-op request
    if not factor_dtype.is_floating_point:
        raise DecompError("factor_dtype must be a float dtype")
    if torch.finfo(factor_dtype).bits < torch.finfo(y.dtype).bits:
        raise DecompError(
            "factor_dtype must be at least as wide as y's dtype "
            f"(got {factor_dtype} factors for {y.dtype} data)")
    if method not in ("mu", "kl-mu"):
        raise DecompError("factor_dtype supports methods 'mu' and 'kl-mu' "
                          "only")
    return factor_dtype


def _heldout_check_every(mask, method, record_objective, heldout_frac,
                         check_every):
    """stop='heldout''s checks; returns ``check_every``, 25 unless set
    (each check costs two reconstructions)."""
    if mask is None:
        raise DecompError("stop='heldout' requires a mask (it validates on "
                          "reserved OBSERVED entries)")
    if method not in ("mu", "kl-mu"):
        raise DecompError("stop='heldout' supports methods 'mu'/'kl-mu'")
    if record_objective:
        raise DecompError("stop='heldout' is incompatible with "
                          "record_objective (checks are amortised over "
                          "check_every iterations)")
    if not 0.0 < float(heldout_frac) < 1.0:
        raise DecompError("heldout_frac must be in (0, 1)")
    return 25 if check_every == 1 else check_every


def _heldout_reserve(mask, frac, random_seed):
    """The validation set of stop='heldout': each observed entry with
    probability ``frac``, drawn on the mask's device, in row chunks, from
    a generator seeded with ``random_seed`` salted by ``_HELDOUT_SALT``.
    The salt goes into the low 32 bits, the only ones the CPU generator
    keeps, and the high ones. Returns a 0/1 tensor in the mask's dtype."""
    return _heldout_block(mask, frac, random_seed, mask.shape)


def _heldout_block(mask, frac, random_seed, shape, row0=0, col0=0):
    """The block of ``_heldout_reserve``'s draw on a global matrix of
    ``shape`` whose rows and columns start at ``row0`` and ``col0``, for
    ``mask``, the block of the global mask (a sharded solve's rank): the
    generator replays the global draw chunk by chunk up to the block's
    last row, so the block equals those entries of the global reserve at
    any number of ranks, and never holds more than one full-width row
    chunk beside it."""
    seed = (random_seed ^ (_HELDOUT_SALT * (2 ** 32 + 1))) % 2 ** 64
    gen = torch.Generator(device=mask.device).manual_seed(seed)
    m, n = mask.shape
    val = torch.empty_like(mask)
    for sl in _row_slices(min(row0 + m, shape[0])):
        stop = min(sl.stop, shape[0])
        u = torch.rand((stop - sl.start, shape[1]), generator=gen,
                       device=mask.device)
        lo, hi = max(sl.start, row0), min(stop, row0 + m)
        if lo < hi:
            mine = slice(lo - row0, hi - row0)
            val[mine] = (u[lo - sl.start:hi - sl.start, col0:col0 + n]
                         < frac).to(mask.dtype) * mask[mine]
    return val


def _heldout_split(y, mask, val, reduce=_identity):
    """``(train_mask, hd)`` of stop='heldout': train on the observed
    entries outside the validation set ``val``; ``hd = (yv, val, vnorm)``
    holds the validation data and set in y's dtype (val is 0/1, so val * y
    is exact) and the squared norm of yv in the >= f32 accumulator, summed
    over a sharded solve's ranks by ``reduce``."""
    acc = acc_dtype(real_dtype(y.dtype))
    yv = val * y
    vnorm = torch.clamp(reduce(_row_sum(yv.shape[0], lambda sl: torch.sum(
        yv[sl].to(acc) * yv[sl].to(acc)))), min=torch.finfo(acc).tiny)
    return mask - val, (yv, val, vnorm)


def _solve(y, d, x, mask, val, *, rank, method="mu", tol=1e-4, eps=1e-15,
           maxiter=1000, inner_iter=1, record_objective=False,
           factor_dtype=None, use_kernel=False, kernel_block_rows=None,
           check_every=1, verbose=False, random_seed=0, minibatch=None,
           forget=0.9, batch_idx=None, reduce_rows=None, reduce_cols=None,
           init=None):
    """The solve, after ``solve``'s checks. ``val``: the held-out
    validation set (0/1 in y's dtype, inside ``mask``) under
    stop='heldout', else None; ``solve`` draws it with
    ``_heldout_reserve``, and a parity test may pass ``decomp_tpu``'s.
    ``batch_idx``: the minibatch rows of each iteration, (maxiter,
    minibatch), instead of the seeded draws (a parity test passes
    ``decomp_tpu``'s).

    A sharded solve (``parallel.nmf``, full batch) runs this on its block
    with ``reduce_rows`` / ``reduce_cols``, the sums of a partial
    statistic over the ranks that share its columns / rows, where
    ``decomp_tpu`` applies ``psum_rows`` / ``psum_cols``, and ``init``,
    ``(my, d, x) -> (d, x)``, for the factors it leaves None. Unset, the
    sums are the identity and the result is the one-process solve's."""
    rdt = real_dtype(y.dtype)
    acc = acc_dtype(rdt)
    tiny = torch.finfo(acc).tiny
    # eps guards f32 (or wider) denominators in mixed mode; it is rounded
    # to that dtype as the JAX package rounds it.
    eps_t = torch.tensor(eps, dtype=real_dtype(factor_dtype)
                         if factor_dtype is not None else rdt)
    red_r = reduce_rows or _identity
    red_c = reduce_cols or _identity

    def red_all(t):
        return red_c(red_r(t))

    hd = None
    if val is not None:
        mask, hd = _heldout_split(y, mask, val, red_all)
    my = y if mask is None else mask * y
    # One generator: the initial factors' draws, then the minibatch rows.
    gen = torch.Generator(device=y.device).manual_seed(random_seed)
    if d is None or x is None:
        # The init scale comes from the observed data: junk values at
        # missing entries cannot blow up the starting point.
        d, x = (_init_factors(gen, my, d, x, rank, factor_dtype)
                if init is None else init(my, d, x))

    def norm(v):
        # d's norm: l2_norm's arithmetic, summed over d's column blocks
        return torch.sqrt(red_c(torch.sum(v * v)))

    def diff_fn(old, new):
        d_old = old[1].to(acc)
        d_new = new[1].to(acc)
        return norm(d_new - d_old) / torch.clamp(norm(d_old), min=tiny)

    if method == "kl-mu":
        def objective(state):
            return red_all(_kl_objective(my, state[0], state[1], mask, eps_t))
    else:
        def objective(state):
            return 0.5 * red_all(_sq_resid(my, state[0], state[1], acc, mask))

    init = (x, d)
    if minibatch is not None:
        if batch_idx is not None:
            batch_idx = torch.as_tensor(batch_idx, dtype=torch.int64,
                                        device=y.device)
        step = _minibatch_step(my, mask, method, eps_t, inner_iter,
                               torch.tensor(forget, dtype=rdt), minibatch,
                               gen, batch_idx)
        den0 = (torch.zeros_like(d[:, :1]) if method == "kl-mu"
                and mask is None else torch.zeros_like(d))
        init = (x.clone(), d, torch.zeros_like(d), den0)
    elif method == "hals":
        step = _hals_step(my, inner_iter, red_r, red_c)
    elif use_kernel:
        # The kernels run with a row axis only (parallel.nmf), so the rows'
        # sum is every rank's.
        step = _kernel_step(my, mask, method, float(eps_t), kernel_block_rows,
                            inner_iter, reduce_rows)
    else:
        upd_x, upd_d = _UPDATES[method, factor_dtype is not None]

        def step(state, it):
            x_, d_ = state
            for _ in range(inner_iter):
                x_ = upd_x(my, x_, d_, mask, eps_t, red_c)
            return (x_, upd_d(my, x_, d_, mask, eps_t, red_r))

    val_sqerr, min_iter = None, 0
    if hd is not None:
        # diff is the validation error's relative improvement per check;
        # it goes negative when the error rises, and the loop stops then.
        val_sqerr, diff_fn = _heldout_machinery(hd, y.dtype, red_all)
        # warm-up floor, clamped to the budget so a short run can still
        # report convergence
        min_iter = min(2 * check_every, max(maxiter - check_every, 0))
    res = run_iterations(
        step, init, tol=tol, maxiter=maxiter, diff_fn=diff_fn,
        objective_fn=objective, record_objective=record_objective,
        check_every=check_every, verbose=verbose, min_iter=min_iter,
        diff_nonnegative=hd is None)
    aux = (None if val_sqerr is None
           else {"heldout_rel_err": torch.sqrt(val_sqerr(res.state))})
    # HALS keeps x column-major; the result is row-major as on every path.
    return NMFResult(x=res.state[0].contiguous(), d=res.state[1],
                     niter=res.niter, converged=res.converged,
                     objective=res.objective, aux=aux)


def _hals_step(my, inner_iter, reduce_rows=_identity,
               reduce_cols=_identity):
    """One HALS iteration (``decomp_tpu``'s ``_update_x_hals`` and
    ``_update_d_hals``): A = d d^T and B = my d^T, ``inner_iter`` sweeps
    over x's components, then C = x^T x and E = x^T my and one sweep over
    d's. During the x sweeps x is held column-major, so each component
    x_k is a contiguous row of x^T; A and B depend on d alone and serve
    every x sweep. The state's x is the transposed view of that buffer.
    A sharded solve sums A and B over the column blocks and C and E over
    the row blocks (``reduce_cols``, ``reduce_rows``)."""
    def step(state, it):
        x_, d_ = state
        a = reduce_cols(d_ @ d_.T)          # (K, K)
        bt = reduce_cols(d_ @ my.T)         # (K, M) = (my d^T)^T
        xt = x_.T.clone(memory_format=torch.contiguous_format)
        for _ in range(inner_iter):
            # x_k's update reads column k of A: row k of A^T.
            _hals_sweep(xt, a.T, bt)
        c = reduce_rows(xt @ xt.T)
        e = reduce_rows(xt @ my)
        d_new = d_.clone()
        _hals_sweep(d_new, c, e)
        return (xt.T, d_new)

    return step


def _hals_sweep(rows, g, stats):
    """The sequential component sweep of HALS, in place on ``rows``
    (K, L): for k = 0..K-1,
    rows_k <- max(0, rows_k + (stats_k - rows^T g_k) / g_kk)
    with the rows already updated. A component whose diagonal ``g_kk`` is
    not above ``eps * max(trace(g), tiny)`` keeps its value
    (``decomp_tpu``'s dead-component guard; dividing by a tiny diagonal
    would blow the component up and NaN the next sweep). Five launches a
    component (``addmv`` copies before its product) and no host read: the
    guard's choice is a ``where`` on the device. The per-component views
    come from ``unbind`` up front: the loop's host time sets its pace."""
    rdt = real_dtype(rows.dtype)
    fi = torch.finfo(rdt)
    diag = torch.diagonal(g)
    floor = fi.eps * torch.clamp(torch.trace(g), min=fi.tiny)
    den = torch.maximum(diag, floor)
    live = diag > floor
    mat = rows.T
    for row, s_k, g_k, den_k, live_k in zip(
            rows.unbind(0), stats.unbind(0), g.unbind(0), den.unbind(0),
            live.unbind(0)):
        r = torch.addmv(s_k, mat, g_k, alpha=-1)
        new = torch.addcdiv(row, r, den_k).clamp_min_(0)
        torch.where(live_k, new, row, out=row)


def _minibatch_step(my, mask, method, eps, inner_iter, forget, minibatch,
                    gen, batch_idx):
    """One online iteration (``decomp_tpu/models/nmf.py:440-476``) on the
    state (x, d, num, den): draw ``minibatch`` rows with replacement (or
    take ``batch_idx[it]``), refresh their x with ``inner_iter`` updates,
    write them back, decay the K x N statistics by ``forget`` and add the
    batch's, and set d <- d * num / (den + eps). 'mu' accumulates xb^T yb
    and xb^T (mb * (xb d)); 'kl-mu' xb^T (yb / (xb d + eps)) and the
    (K, 1) column sums of xb or xb^T mb. The state's x is the solve's own
    copy, written in place."""
    upd_x = _UPDATES[method, False][0]
    m = my.shape[0]
    rows = torch.arange(minibatch, device=my.device)

    def step(state, it):
        x_, d_, num, den = state
        idx = (batch_idx[it] if batch_idx is not None
               else torch.randint(0, m, (minibatch,), generator=gen,
                                  device=my.device))
        yb = my[idx]
        mb = None if mask is None else mask[idx]
        xb = x_[idx]
        for _ in range(inner_iter):
            xb = upd_x(yb, xb, d_, mb, eps)
        # A row drawn twice is written from one batch position (its last),
        # so the write-back does not depend on the order of the writes.
        last = torch.full((m,), -1, dtype=rows.dtype, device=my.device)
        last.scatter_reduce_(0, idx, rows, "amax")
        x_.index_copy_(0, idx, xb[last[idx]])
        if method == "mu":
            recon = xb @ d_ if mb is None else mb * (xb @ d_)
            num = forget * num + xb.T @ yb
            den = forget * den + xb.T @ recon
        else:
            r = xb @ d_ + eps
            num = forget * num + xb.T @ (yb / r)
            den = forget * den + (torch.sum(xb, 0)[:, None] if mb is None
                                  else xb.T @ mb)
        return (x_, d_ * num / (den + eps), num, den)

    return step


def _kernel_step(my, mask, method, eps, block_rows, inner_iter, reduce=None):
    """One iteration through the ``ops.cuda_mu`` kernel of the method and
    mask (``decomp_tpu``'s ``_solve_pallas`` dispatch). The MU kernels
    stream the compute-dtype copy of d and update the (possibly wider)
    master in the epilogue; the KL kernels take d in my's dtype.
    ``reduce``: a row-sharded solve's sum over its ranks, of the
    statistics and of the mask's 0/1 verdict."""
    cdt = my.dtype
    if method == "kl-mu" and mask is None:
        def step(state, it):
            return cuda_mu.kl_update_dense(my, state[0], state[1], eps,
                                           block_rows=block_rows,
                                           reduce=reduce)
    elif method == "kl-mu":
        # A 0/1 mask (the training mask under stop='heldout') goes to the
        # kernel as bits, packed once per solve; a weighted mask, or bf16
        # data on the card, stays dense.
        packed = (cuda_mu.pack_mask_agreed(mask, reduce)
                  if cuda_mu.kl_takes_packed(my) else None)
        mask_k = mask if packed is None else packed

        def step(state, it):
            return cuda_mu.kl_update_masked(my, mask_k, state[0], state[1],
                                            eps, block_rows=block_rows,
                                            reduce=reduce)
    elif mask is None:
        def step(state, it):
            x_, d_ = state
            return cuda_mu.mu_update_dense(
                my, x_, d_.to(cdt), eps, block_rows=block_rows, d_master=d_,
                inner_iter=inner_iter, reduce=reduce)
    else:
        # A 0/1 mask goes to the kernel as bits, packed once per solve
        # (under stop='heldout' this is the training mask); a weighted
        # mask stays dense.
        packed = (cuda_mu.pack_mask_agreed(mask, reduce)
                  if cuda_mu.takes_packed(my) else None)
        mask_k = mask if packed is None else packed

        def step(state, it):
            x_, d_ = state
            return cuda_mu.mu_update_masked(
                my, mask_k, x_, d_.to(cdt), eps, block_rows=block_rows,
                d_master=d_, reduce=reduce)
    return step


def _heldout_machinery(hd, compute_dtype, reduce=_identity):
    """(val_sqerr, diff_fn) for stop='heldout'. ``hd`` = (yv, val, vnorm):
    the validation data and set in y's dtype and the squared norm of yv.
    The validation reconstruction takes compute-dtype operands and sums in
    the >= f32 dtype of vnorm, a row chunk at a time; ``reduce`` sums the
    error over a sharded solve's ranks, so that every rank stops on the
    same check."""
    yv, val, vnorm = hd
    acc = vnorm.dtype
    tiny = torch.finfo(acc).tiny

    def val_sqerr(state):
        x_, d_ = state
        dc = d_.to(compute_dtype).to(acc)

        def part(sl):
            recon = x_[sl].to(compute_dtype).to(acc) @ dc
            r = yv[sl].to(acc) - val[sl].to(acc) * recon
            return torch.sum(r * r)

        return reduce(_row_sum(yv.shape[0], part)) / vnorm

    def diff_fn(old, new):
        e_old = val_sqerr(old)
        e_new = val_sqerr(new)
        return (e_old - e_new) / torch.clamp(e_old, min=tiny)

    return val_sqerr, diff_fn


def masked_completion(y, mask, rank=None, d=None, x=None, *, tol=1e-4,
                      maxiter=4000, heldout_frac=0.05, random_seed=0,
                      mixed="auto", refit=0, mesh=None, row_axis="rows",
                      col_axis=None, **kwargs) -> NMFResult:
    """Matrix-completion preset: masked MU-NMF stopped on held-out
    validation error (``solve(stop='heldout')``).

    ``mixed``: 'auto' (a CUDA ``y`` of dtype f32), True, or False. Mixed
    runs bf16 data with f32 factors through the masked kernel (and
    ``precision='default'``); otherwise y's dtype is kept.

    ``refit=N`` follows the held-out-stopped solve with N warm-started
    iterations on ALL observed entries at ``tol=0``; the result keeps the
    held-out solve's ``aux`` and ``converged`` and counts both runs'
    iterations in ``niter``. Host-array inputs go to ``kwargs['device']``,
    by default the CUDA device, as in ``solve``.

    ``mesh``: a sharded solve (``parallel.nmf.solve``; every rank calls
    this with its own block of ``y``, ``mask`` and ``x``, sharded over
    ``row_axis`` and, optionally, ``col_axis``, and ``d``'s column block).
    Host arrays then go to the rank's device.
    """
    if mesh is not None:
        from decomp_tpu_torch.parallel import mesh as _pmesh
        from decomp_tpu_torch.parallel import nmf as _pnmf

        _pmesh.require_process_group()
        solve_fn = functools.partial(_pnmf.solve, mesh=mesh,
                                     row_axis=row_axis, col_axis=col_axis)

        def place():
            if "device" in kwargs:
                raise DecompError("device= does not apply with mesh=: each "
                                  "rank's blocks go to its own device")
            return _device.on_device("y", y, _pmesh.placement(mesh, y))

        y = _pmesh.checked(place)
    else:
        solve_fn = solve
        y = _device.on_device("y", y, _device.resolve(y,
                                                      kwargs.get("device")))
    if mixed == "auto":
        mixed = y.is_cuda and y.dtype == torch.float32
    if mixed:
        y = y.to(torch.bfloat16)
        kwargs.setdefault("factor_dtype", torch.float32)
        kwargs.setdefault("precision", "default")
    res = solve_fn(y, d, rank=rank, x=x, mask=mask, tol=tol, maxiter=maxiter,
                   method="mu", stop="heldout", heldout_frac=heldout_frac,
                   random_seed=random_seed, **kwargs)
    if refit:
        refit_res = solve_fn(y, res.d, x=res.x, mask=mask, tol=0.0,
                             maxiter=int(refit), method="mu",
                             random_seed=random_seed, **kwargs)
        # The polish runs at tol=0, so its own converged flag is vacuously
        # False: the caller gates on the held-out solve's verdict.
        res = refit_res._replace(aux=res.aux, converged=res.converged,
                                 niter=res.niter + refit_res.niter)
    return res


def _row_slices(m):
    return [slice(s, s + _CHUNK_ROWS) for s in range(0, m, _CHUNK_ROWS)]


def _row_sum(m, part):
    """The sum of ``part(rows)`` over the row chunks of an m-row matrix."""
    total = None
    for sl in _row_slices(m):
        p = part(sl)
        total = p if total is None else total + p
    return total


def _sq_resid(my, x, d, acc, mask=None):
    """||my - mask * (x@d)||^2 in ``acc`` (no mask: ||my - x@d||^2), one
    row chunk at a time (no M x N temporary in ``acc``)."""
    def part(sl):
        recon = (x[sl] @ d).to(acc)
        if mask is not None:
            recon = mask[sl].to(acc) * recon
        r = my[sl].to(acc) - recon
        return torch.sum(r * r)

    return _row_sum(my.shape[0], part)


def _kl_objective(my, x, d, mask, eps):
    """Generalised KL divergence D(y || x@d) over the observed entries,
    with the 0 log 0 = 0 convention, one row chunk at a time."""
    def part(sl):
        r = x[sl] @ d + eps
        if mask is not None:
            r = mask[sl] * r
        myc = my[sl]
        ylogy = torch.where(myc > 0, myc * torch.log(myc / (r + eps)), 0.0)
        return torch.sum(ylogy - myc + r)

    return _row_sum(my.shape[0], part)


def _update_x(my, x, d, mask, eps, reduce_cols=_identity):
    """One multiplicative x update, all in the factors' dtype.
    ``reduce_cols``: under column sharding the (M, K) numerator and the K x
    K Gram term are partial sums over the rank's columns, summed over the
    column blocks (``decomp_tpu``'s ``psum_cols``); each x update takes
    it."""
    num = reduce_cols(my @ d.T)
    den = (x @ reduce_cols(d @ d.T) if mask is None
           else reduce_cols((mask * (x @ d)) @ d.T))
    return x * num / (den + eps)


def _update_d(my, x, d, mask, eps, reduce_rows=_identity):
    """One multiplicative d update, all in the factors' dtype.
    ``reduce_rows``: under row sharding the K x N numerator and the K x K
    Gram statistic are partial sums over the rank's rows, summed over the
    row blocks (``psum_rows``); each d update takes it."""
    num = reduce_rows(x.T @ my)
    den = (reduce_rows(x.T @ x) @ d if mask is None
           else reduce_rows(x.T @ (mask * (x @ d))))
    return d * num / (den + eps)


def _rows_dot(a, b):
    """``a @ b`` with compute-dtype operands summed in f32 (the products of
    bf16 operands are exact in f32), one row chunk of ``a`` at a time."""
    w = torch.promote_types(a.dtype, torch.float32)
    bw = b.to(w)
    return torch.cat([(a[sl].to(w) @ bw).to(torch.float32)
                      for sl in _row_slices(a.shape[0])])


def _tdot(a, b):
    """``a.T @ b`` like ``_rows_dot``, summed over row chunks in f32."""
    w = torch.promote_types(a.dtype, torch.float32)
    return _row_sum(a.shape[0], lambda sl: (
        a[sl].to(w).T @ b[sl].to(w)).to(torch.float32))


def _recon_m(mask, xb, db):
    """The masked reconstruction at the mixed mode's quantisation points,
    ``cdt(f32(mask) * (xb @ db))`` with ``cdt = xb.dtype``."""
    return torch.cat([(mask[sl].to(torch.float32) * _rows_dot(xb[sl], db))
                      .to(xb.dtype) for sl in _row_slices(xb.shape[0])])


def _ratio(my, xb, db, eps):
    """The KL ratio at the mixed mode's quantisation points,
    ``cdt(f32(my) / (xb @ db + eps))`` with ``cdt = my.dtype``."""
    return torch.cat([(my[sl].to(torch.float32)
                       / (_rows_dot(xb[sl], db) + eps)).to(my.dtype)
                      for sl in _row_slices(my.shape[0])])


def _update_x_mixed(my, x, d, mask, eps, reduce_cols=_identity):
    """Mixed-precision x update (factor_dtype mode): x and d are stored
    wide, every product takes compute-dtype (= my.dtype) operands and sums
    in f32, d d^T is cast to the compute dtype at use."""
    cdt = my.dtype
    db = d.to(cdt)
    num = reduce_cols(_rows_dot(my, db.T))
    if mask is None:
        den = _rows_dot(x.to(cdt),
                        reduce_cols(cuda_mu.gram_rows(db)).to(cdt))
    else:
        den = reduce_cols(_rows_dot(_recon_m(mask, x.to(cdt), db), db.T))
    return x * num / (den + eps)


def _update_d_mixed(my, x, d, mask, eps, reduce_rows=_identity):
    """Mixed-precision d update; the dense K x K @ K x N epilogue is full
    f32."""
    cdt = my.dtype
    xb = x.to(cdt)
    num = reduce_rows(_tdot(xb, my))
    if mask is None:
        den = reduce_rows(_tdot(xb, xb)) @ d.to(torch.float32)
    else:
        den = reduce_rows(_tdot(xb, _recon_m(mask, xb, d.to(cdt))))
    return d * num / (den + eps)


def _update_x_kl(my, x, d, mask, eps, reduce_cols=_identity):
    """One Lee-Seung KL x update:
    x <- x * ((my / (x@d + eps)) @ d.T) / ((mask or 1) @ d.T + eps)."""
    num = reduce_cols((my / (x @ d + eps)) @ d.T)
    den = reduce_cols(torch.sum(d, 1) if mask is None else mask @ d.T)
    return x * num / (den + eps)


def _update_d_kl(my, x, d, mask, eps, reduce_rows=_identity):
    """One Lee-Seung KL d update:
    d <- d * (x.T @ (my / (x@d + eps))) / (x.T @ (mask or 1) + eps)."""
    num = reduce_rows(x.T @ (my / (x @ d + eps)))
    den = (reduce_rows(torch.sum(x, 0))[:, None] if mask is None
           else reduce_rows(x.T @ mask))
    return d * num / (den + eps)


def _update_x_kl_mixed(my, x, d, mask, eps, reduce_cols=_identity):
    """Mixed-precision KL x update: the ratio is formed in f32 and cast to
    the compute dtype as the next product's operand."""
    cdt = my.dtype
    db = d.to(cdt)
    num = reduce_cols(_rows_dot(_ratio(my, x.to(cdt), db, eps), db.T))
    den = reduce_cols(torch.sum(d.to(torch.float32), 1) if mask is None
                      else _rows_dot(mask, db.T))
    return x * num / (den + eps)


def _update_d_kl_mixed(my, x, d, mask, eps, reduce_rows=_identity):
    """Mixed-precision KL d update; see _update_x_kl_mixed."""
    cdt = my.dtype
    xb = x.to(cdt)
    num = reduce_rows(_tdot(xb, _ratio(my, xb, d.to(cdt), eps)))
    den = (reduce_rows(torch.sum(x.to(torch.float32), 0))[:, None]
           if mask is None else reduce_rows(_tdot(xb, mask)))
    return d * num / (den + eps)


# (method, mixed precision) -> the composition path's (x, d) updates.
_UPDATES = {
    ("mu", False): (_update_x, _update_d),
    ("mu", True): (_update_x_mixed, _update_d_mixed),
    ("kl-mu", False): (_update_x_kl, _update_d_kl),
    ("kl-mu", True): (_update_x_kl_mixed, _update_d_kl_mixed),
}


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


# The out-of-core variants reuse this module's updates, so they are
# imported at its end.
from decomp_tpu_torch.models.nmf_streaming import (  # noqa: E402,F401
    masked_completion_streaming,
    solve_streaming,
)
