"""L1-regularised least squares (lasso) solvers (counterpart of
``decomp_tpu.models.lasso``).

Minimise  0.5 * ||mask * (y - x @ a)||^2 + alpha * ||x||_1  over a batch of
row problems (each row of ``y`` is an independent problem sharing the
dictionary ``a``), for real and complex dtypes.

Methods: 'ista' (proximal gradient, step 1/L, L = lambda_max(a a^H)),
'fista' (Nesterov momentum), 'acc_ista' (FISTA with the row-local adaptive
restart), 'parallel_cd' (the diagonally preconditioned all-coordinates
step) and 'cd' (sequential coordinate descent, a correctness reference).
Two paths run the gradient methods: the composition path of plain torch
products, driven by ``ops.loop.run_iterations``, and the kernel path
(``use_kernel``) of ``ops.cuda_lasso``: the whole per-problem solve of
unmasked rows in one ``solve_rows`` call (real f32, or complex64 through
its complex mode), or the masked gradient in one ``masked_grad_rows`` call
per iteration (the CUDA kernel on a CUDA tensor, its plain twin on a CPU
tensor). ``solve_split`` is a thin wrapper over native complex for callers
that hold (re, im) pairs.

Entry points run on the card unless the caller asks for the CPU: see
``utils.device``.
"""

import numpy as np
import torch

from decomp_tpu_torch.ops import cuda_lasso, cuda_mu
from decomp_tpu_torch.ops.loop import run_iterations
from decomp_tpu_torch.ops.soft_threshold import soft_threshold
from decomp_tpu_torch.ops.spectral import spectral_norm_psd
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.result import LassoResult, SplitComplex

_METHODS = ("ista", "fista", "acc_ista", "cd", "parallel_cd")
_GRAD_METHODS = ("ista", "fista", "acc_ista", "parallel_cd")
_PRECISIONS = ("default", "high", "highest", "bfloat16", "tensorfloat32",
               "float32", "fastest")
# use_kernel='auto' on complex64 data. Measured on an H100 (PERF.md §6):
# the kernel's complex mode beats the composition under 'high' at every
# measured width (64 to 512 complex features), and under 'highest' up to
# 256; at 512 its full-f32 products lose to the composition.
_AUTO_COMPLEX_HIGHEST_MAX_FEATURES = 256
# Above 1,024 reals, up to the TPU kernel's gate, 'auto' takes the wide
# route (csrc/lasso_fista_wide.cu) for f32 and complex64 at both
# precisions: measured on an H100 (PERF.md §6 row 5, tools/
# solve_wide_turns.py; 10,000 problems, acc_ista, tol 1e-4, against the
# composition in turns) 0.359x / 0.515x ('high' / 'highest') at 1,408
# features over N = F / 2, 0.242x / 0.344x at F / 4, 0.404x / 0.576x at
# 1,152; complex64 at 640 features 0.413x / 0.544x at F / 2, 0.286x /
# 0.369x at F / 4; without momentum (ista) at the gate's 1,536 features
# 0.055x / 0.077x. Small batches, where a few clusters run the whole solve:
# 7, 64 and 1,000 problems over 1,152 features 0.082x-0.124x / 0.104x-
# 0.223x, over 640 complex features 0.074x-0.115x / 0.107x-0.177x. No
# batch size measured favours the composition, so the rule has no gate
# by M.


def solve(
    y,
    a,
    alpha,
    x=None,
    *,
    tol=1e-5,
    maxiter: int = 1000,
    method: str = "fista",
    mask=None,
    lipschitz=None,
    record_objective: bool = False,
    precision: str = "highest",
    complex_split="auto",
    check_every: int = 1,
    per_problem: bool = False,
    use_kernel="auto",
    kernel_block_rows=None,
    return_state: bool = False,
    momentum_state=None,
    state=None,
    device=None,
) -> LassoResult:
    """Solve  min_x 0.5*||mask*(y - x@a)||^2 + alpha*||x||_1.

    Parameters
    ----------
    y : (n_channels,) or (n_samples, n_channels), real or complex. Each row
        is an independent problem.
    a : (n_features, n_channels) dictionary, same dtype family as y.
    alpha : nonnegative regularisation weight; scalar or broadcastable to
        the solution shape (per-feature / per-sample weights). 'cd'
        requires a scalar.
    x : optional warm start, shape (..., n_features).
    tol : stop when ||x_new - x_old|| / max(||x_new||, tiny) < tol.
    method : one of 'ista', 'fista', 'acc_ista', 'cd', 'parallel_cd'.
    mask : broadcastable to y; 1 = observed, 0 = missing. Unsupported for
        'cd'.
    lipschitz : optional L >= lambda_max(a @ a^H); skips the power-iteration
        estimate.
    record_objective : record the objective per iteration (extra product).
    precision : the products of the whole-solve kernel: 'highest' (full
        f32, the default) or 'high' (bf16x3 on the tensor cores, the
        ``decomp_tpu`` 'high' split). The composition path's f32 products
        are always full f32 (never TF32), whatever this says.
    complex_split : accepted for ``decomp_tpu`` compatibility. Complex
        inputs always run natively in complex64/complex128 on the
        composition path; ``decomp_tpu``'s split path gives the same answer
        to rounding.
    check_every : evaluate the global stopping rule every this many
        iterations.
    per_problem : every row converges independently: converged rows freeze
        at their own stopping iteration, the loop runs until every row is
        done or maxiter, and ``niter``/``converged`` come back per row
        (n_samples,). Methods ista / fista / acc_ista / parallel_cd.
    use_kernel : True / False / 'auto'. The kernel path: unmasked with
        ``per_problem=True``, the whole solve in one
        ``cuda_lasso.solve_rows`` call (float32, or complex64 through the
        kernel's complex mode, up to the TPU kernel's gate
        ``cuda_lasso.solve_fits``: 1,408 features with momentum, 1,536
        without, 640 complex features; a
        gradient method, scalar or per-feature alpha, no
        ``record_objective``, precision 'highest' or 'high'); masked (real
        data only), the gradient in one
        ``cuda_lasso.masked_grad_rows`` call per iteration, a 0/1 mask
        packed into bits once per solve for f32 data (on the CPU, any
        data). On a CUDA tensor the hand-written kernel runs, on a CPU
        tensor its plain twin. 'auto' takes each kernel on a CUDA tensor
        where the card measured it faster than the composition and its
        contract holds (the masked kernel: bf16 or f32 data with a 0/1 or
        weighted mask at F <= 128, and above it, up to the TPU kernel's
        gate ``cuda_lasso.grad_fits``, f32 data at N >= 256 on the wide
        route, ``_auto_width``; the whole solve by ``_auto_whole_width``:
        f32 and F <= 1024, complex64 under 'high' and F <= 512, or under
        'highest' and F <= 256, and above 1,024 reals inside the gate);
        it is False on the CPU.
    kernel_block_rows : rows per stripe of the whole-solve kernel, 16 or
        32 (32 only at F <= 512; the wide route's clusters hold 16); default
        by F. Results do not depend on it.
    return_state : momentum methods also return ``aux={"z", "t"}``; passing
        them back (``momentum_state=(z, t)`` or ``state=``) with ``x=``
        resumes the exact trajectory.
    momentum_state : optional (z, t) from a previous result's ``aux``;
        requires ``x`` and a momentum method.
    state : optional dict resume form, keys among {"z", "t", "done",
        "niter"}: the momentum pair, and a previous ``per_problem`` result's
        ``converged`` / ``niter`` (resumed done rows never move; ``niter``
        is cumulative).
    device : where host-array inputs go (default the CUDA device; see
        ``utils.device``). A tensor ``y`` stays on its device.

    Returns
    -------
    LassoResult(x, niter, converged, objective, aux). ``x`` has y's leading
    shape + (n_features,); ``niter``/``converged`` are a Python int and
    bool, or per-row (n_samples,) tensors when ``per_problem``.
    """
    if method not in _METHODS:
        raise DecompError(f"method must be one of {_METHODS}, got {method!r}")
    if int(maxiter) < 1:
        raise ValueError(f"maxiter must be >= 1, got {maxiter}")
    if per_problem and method == "cd":
        raise DecompError("per_problem convergence does not support "
                          "method 'cd'")
    if precision not in _PRECISIONS:
        raise DecompError(f"precision must be one of {_PRECISIONS}, "
                          f"got {precision!r}")
    momentum_state, pp_state = _unpack_state(state, momentum_state,
                                             per_problem)
    if momentum_state is not None:
        if method not in ("fista", "acc_ista"):
            raise DecompError("momentum_state applies to momentum methods "
                              "(fista / acc_ista) only")
        if x is None:
            raise DecompError("momentum_state requires the warm start x "
                              "(the FISTA state is (x, z, t))")

    dev = _device.resolve(y, device)
    y = _device.on_device("y", y, dev)
    dev = y.device
    a = _device.on_device("a", a, dev)
    assertion.assert_inexact("y", y)
    assertion.assert_ndim("y", y, (1, 2))
    assertion.assert_ndim("a", a, 2)
    squeeze = y.dim() == 1
    if squeeze:
        y = y[None, :]
    assertion.assert_axis_size("a", a, 1, y.shape[1], "n_channels")
    n_features = a.shape[0]

    dtype = torch.promote_types(y.dtype, a.dtype)
    y = y.to(dtype)
    a = a.to(dtype)
    rdt = real_dtype(dtype)
    if x is not None:
        x = _device.on_device("x", x, dev, dtype)
        if squeeze and x.dim() == 1:
            x = x[None, :]
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, y.shape[0], "n_samples")
        assertion.assert_axis_size("x", x, 1, n_features, "n_features")
    if mask is not None:
        mask = _device.on_device("mask", mask, dev)
        if squeeze and mask.dim() == 1:
            mask = mask[None, :]
        assertion.assert_same_shape("mask", mask, "y", y)
        mask = mask.to(rdt)
        if method == "cd":
            raise DecompError("method 'cd' does not support mask; use "
                              "'parallel_cd' or 'fista'")

    assertion.assert_nonnegative("alpha", alpha)
    alpha = _device.on_device("alpha", alpha, dev, rdt)
    if method == "cd" and alpha.dim() != 0:
        raise DecompError("method 'cd' requires a scalar alpha")
    lip = (None if lipschitz is None
           else _device.on_device("lipschitz", lipschitz, dev, rdt))

    mstate = None
    if momentum_state is not None:
        z0 = _device.on_device("momentum_state z", momentum_state[0], dev,
                               dtype)
        if squeeze and z0.dim() == 1:
            z0 = z0[None, :]
        assertion.assert_ndim("momentum_state z", z0, 2)
        assertion.assert_axis_size("momentum_state z", z0, 0, y.shape[0],
                                   "n_samples")
        assertion.assert_axis_size("momentum_state z", z0, 1, n_features,
                                   "n_features")
        t0 = torch.broadcast_to(
            _device.on_device("momentum_state t", momentum_state[1], dev,
                              rdt), (y.shape[0],))
        mstate = (z0, t0)

    ppstate = None
    if pp_state is not None:
        done0 = _device.on_device("state done", pp_state[0], dev)
        nit0 = _device.on_device("state niter", pp_state[1], dev)
        if squeeze:
            done0 = done0.reshape(-1) if done0.dim() == 0 else done0
            nit0 = nit0.reshape(-1) if nit0.dim() == 0 else nit0
        assertion.assert_ndim("state done", done0, 1)
        assertion.assert_axis_size("state done", done0, 0, y.shape[0],
                                   "n_samples")
        assertion.assert_ndim("state niter", nit0, 1)
        assertion.assert_axis_size("state niter", nit0, 0, y.shape[0],
                                   "n_samples")
        ppstate = (done0.to(torch.bool), nit0.to(torch.int32))

    mode = _kernel_mode(use_kernel, y, mask, method, dtype, n_features,
                        per_problem, record_objective, precision, alpha)
    kernel_mask = None
    if mode == "masked":
        kernel_mask = _kernel_mask(mask, y, use_kernel == "auto")
        if kernel_mask is None:
            mode = None
    if kernel_block_rows is not None and mode != "whole":
        raise DecompError("kernel_block_rows sets the stripe height of the "
                          "whole-solve kernel, which this call does not run")

    if mode == "whole":
        res = _solve_whole(
            y, a, alpha, x, lip, float(tol),
            None if mstate is None else mstate[0],
            None if mstate is None else mstate[1],
            None if ppstate is None else ppstate[0],
            None if ppstate is None else ppstate[1],
            method=method, maxiter=int(maxiter),
            hi_lo=(precision == "high"), block_rows=kernel_block_rows,
            return_state=bool(return_state), fixed=_static_nonpositive(tol))
    else:
        res = _solve(
            y, a, alpha, x, mask, lip, float(tol), method=method,
            maxiter=int(maxiter), record_objective=bool(record_objective),
            check_every=int(check_every), per_problem=bool(per_problem),
            use_kernel=mode == "masked", kernel_mask=kernel_mask,
            return_state=bool(return_state), momentum_state=mstate,
            per_problem_state=ppstate)
    if squeeze:
        res = res._replace(x=res.x[0])
        if per_problem:
            res = res._replace(niter=res.niter[0],
                               converged=res.converged[0])
        if res.aux is not None:
            res = res._replace(aux={"z": res.aux["z"][0],
                                    "t": res.aux["t"][0]})
    return res


def _unpack_state(state, momentum_state, per_problem):
    """(momentum_state, (done, niter) or None) from ``state=``, with
    ``decomp_tpu``'s checks."""
    if state is None:
        return momentum_state, None
    if momentum_state is not None:
        raise DecompError("pass either state= or momentum_state=, not both")
    if not isinstance(state, dict):
        raise DecompError("state must be a dict with keys among "
                          "{'z', 't', 'done', 'niter'}")
    unknown = set(state) - {"z", "t", "done", "niter"}
    if unknown:
        raise DecompError(f"unknown state keys {sorted(unknown)}")
    if ("z" in state) != ("t" in state):
        raise DecompError("state 'z' and 't' come as a pair (a momentum "
                          "result's aux)")
    if ("done" in state) != ("niter" in state):
        raise DecompError("state 'done' and 'niter' come as a pair (a "
                          "per_problem result's converged/niter)")
    if "z" in state:
        momentum_state = (state["z"], state["t"])
    pp_state = None
    if "done" in state:
        if not per_problem:
            raise DecompError("state done/niter resume requires "
                              "per_problem=True")
        pp_state = (state["done"], state["niter"])
    return momentum_state, pp_state


def _kernel_mode(use_kernel, y, mask, method, dtype, n_features, per_problem,
                 record_objective, precision, alpha):
    """'whole', 'masked' or None: which kernel path ``solve`` takes
    (``decomp_tpu``'s ``use_pallas`` routing, ``lasso.py:282-349``)."""
    if use_kernel == "auto":
        if not y.is_cuda or method not in _GRAD_METHODS:
            return None
        if mask is not None:
            ok = (dtype in (torch.bfloat16, torch.float32)
                  and _auto_width(y.shape[1], n_features, dtype))
            return "masked" if ok else None
        ok = (per_problem
              and _auto_whole_width(dtype, n_features, precision, method)
              and not record_objective
              and precision in ("highest", "high")
              and alpha.dim() <= 1)
        return "whole" if ok else None
    if not use_kernel:
        return None
    if method not in _GRAD_METHODS:
        raise DecompError("use_kernel=True requires a gradient method "
                          f"{_GRAD_METHODS}, got {method!r}")
    if dtype.is_complex and mask is not None:
        raise DecompError("use_kernel=True on complex data runs the whole-"
                          "solve kernel, which takes unmasked problems only; "
                          "use_kernel=False runs masked complex data "
                          "natively")
    if mask is not None:
        return "masked"
    # Whole-solve kernel: per-row stopping is intrinsic to its stripe-
    # resident design (independently retiring stripes cannot share a
    # global lock-step criterion).
    if not per_problem:
        raise DecompError(
            "use_kernel=True on unmasked problems runs the whole-solve "
            "kernel, which requires per_problem=True (each stripe of rows "
            "stops on its own; there is no global lock-step criterion). "
            "The unmasked global-criterion gradient is already a single "
            "Gram product.")
    if dtype == torch.complex128:
        raise DecompError("the whole-solve kernel requires complex64 data "
                          "(float32 re and im parts), got complex128")
    if dtype not in (torch.float32, torch.complex64):
        raise DecompError("the whole-solve kernel requires float32 inputs, "
                          f"got {dtype}")
    momentum = method in ("fista", "acc_ista")
    if dtype.is_complex and not cuda_lasso.solve_fits(
            2 * n_features, momentum, precision == "high", group=True):
        edge = cuda_lasso.solve_max_features(momentum, precision == "high",
                                             group=True)
        raise DecompError(
            f"the whole-solve kernel takes at most {edge // 2} complex "
            f"features ({edge} reals, the TPU kernel's gate, "
            f"cuda_lasso.solve_fits), got {n_features}")
    if record_objective:
        raise DecompError("the whole-solve kernel cannot record per-"
                          "iteration objectives (iterations never leave the "
                          "chip); use use_kernel=False for objective curves")
    if precision not in ("highest", "high"):
        raise DecompError("the whole-solve kernel supports precision "
                          "'highest' or 'high' only")
    if alpha.dim() > 1:
        raise DecompError("the whole-solve kernel supports scalar or per-"
                          "feature alpha (per-sample weights take the "
                          "composition path)")
    return "whole"


def _auto_whole_width(dtype, f, precision, method):
    """Whether ``use_kernel='auto'`` takes the whole-solve kernel for F
    features of ``dtype`` data at ``precision``: f32 on the narrow route
    (F <= ``cuda_lasso.SOLVE_MAX_FEATURES``), complex64 there under 'high'
    and under 'highest' up to ``_AUTO_COMPLEX_HIGHEST_MAX_FEATURES``; above
    1,024 reals, inside the TPU kernel's gate (``cuda_lasso.solve_fits``),
    on the wide route (``csrc/lasso_fista_wide.cu``), which the card
    measured faster than the composition at every width, precision, method
    and batch size it was timed at (the turns above). The streamed and sharded solves decide through the same
    ``_kernel_mode``."""
    if dtype == torch.float32:
        reals, narrow_max = f, cuda_lasso.SOLVE_MAX_FEATURES
    elif dtype == torch.complex64:
        reals = 2 * f
        narrow_max = (cuda_lasso.SOLVE_MAX_COMPLEX_FEATURES
                      if precision == "high"
                      else _AUTO_COMPLEX_HIGHEST_MAX_FEATURES)
    else:
        return False
    if cuda_lasso.solve_route(reals) == "narrow":
        return f <= narrow_max
    return cuda_lasso.solve_fits(reals, method in ("fista", "acc_ista"),
                                 precision == "high", group=dtype.is_complex)


def _auto_takes_masked(dtype):
    """Whether ``use_kernel='auto'`` keeps masked data of ``dtype`` on the
    card on the masked-gradient kernels, which it does where the card
    measured them faster than the composition (PERF.md §6; chip_smoke.py
    phases 11 and 15, the masked lasso and masked dictionary learning):
    bf16 and f32 data, whatever the mask's form (a 0/1 mask as bits, a
    weighted one as weights, both on ``csrc/lasso_grad_packed.cu`` and
    ``csrc/grad_dict_packed.cu``)."""
    return dtype in (torch.bfloat16, torch.float32)


# Where 'auto' sends masked solves above 128 features to csrc/grad_wide.cu
# (inside the gate): the data types and the widths N where the card
# measured the wide route faster than the composition (PERF.md §6 rows
# 6-7; in turns, tools/grad_wide_turns.py and its --rule grid, chip_smoke.py
# phases 12, 15b and 15c). f32 at N >= 256: 0.47-0.69x the composition a
# gradient (100,000 x 256 and x 1,024, 20,000 x 1,024, the corner F =
# 1,152 at N = 1,024), 0.71x a masked DL outer iteration with 256 atoms;
# below, the launches' fixed cost outweighs the products: at N = 64
# 1.38-4.33x (config 3's 20,000 x 64 with 256 atoms, and 100,000 rows), at
# N = 128 0.88-2.72x (a win only at F = 10,112). bf16 at 0.87-1.06x at
# 100,000 x 1,024, F = 256, and 1.75-1.95x at its corner (F = 2,432), so
# bf16 keeps the composition.
_AUTO_WIDE_DTYPES = (torch.float32,)
_AUTO_WIDE_MIN_N = 256


def _auto_width(n, f, dtype):
    """Whether ``use_kernel='auto'`` takes the masked-gradient kernels for F
    features (or K atoms) at N columns of ``dtype`` data: always on the
    fused route (F <= ``cuda_lasso.GRAD_MAX_FEATURES``); on the wide route
    (``csrc/grad_wide.cu``) for ``_AUTO_WIDE_DTYPES`` at N >=
    ``_AUTO_WIDE_MIN_N`` inside the TPU kernels' gate
    (``cuda_lasso.grad_fits``). The streamed and sharded solves decide
    through the same ``_kernel_mode``s."""
    if f <= cuda_lasso.GRAD_MAX_FEATURES:
        return True
    return (dtype in _AUTO_WIDE_DTYPES and n >= _AUTO_WIDE_MIN_N
            and cuda_lasso.grad_fits(n, f, dtype.itemsize))


def _kernel_mask(mask, y, auto, reduce=None):
    """The mask the masked-gradient kernel route reads: the bits of a 0/1
    mask (``cuda_mu.pack_mask``: one host read, once per solve) where the
    route takes bits (``cuda_lasso.grad_takes_packed``: f32 or bf16 data
    on the card, any data on the CPU), else the dense mask. Under 'auto'
    (``auto``) None where ``_auto_takes_masked`` sends the solve to the
    composition instead. ``reduce``: a sharded solve's sum over its ranks,
    which packs only where every rank's block is 0/1."""
    if auto and not _auto_takes_masked(y.dtype):
        return None
    packed = (cuda_mu.pack_mask_agreed(mask, reduce)
              if cuda_lasso.grad_takes_packed(y) else None)
    return mask if packed is None else packed


def build_solver(y, a, alpha, x, mask, lipschitz, *, method,
                 per_problem=False, tol=None, use_kernel=False,
                 kernel_mask=None, momentum_init=None, per_problem_init=None,
                 reduce_sum=None):
    """The iteration machinery of one lasso method: ``(step, init, diff_fn,
    obj_fn)`` for ``run_iterations``.

    Every cross-row scalar (the norms of the stopping rule, the objective,
    the count of rows still iterating) goes through ``reduce_sum``: None
    (the identity) for one process, a sum over the ranks for a row-sharded
    solve (``parallel.lasso``), which then stops in lockstep on every rank.

    use_kernel=True with a mask: the gradient is one
    ``cuda_lasso.masked_grad_rows`` call per iteration, reading
    ``kernel_mask`` (``_kernel_mask``'s answer, made once per solve by the
    caller) or, when None, the dense mask; on the card (f32 or bf16 data)
    either goes with a's limbs, split here once.

    per_problem=True (ista / fista / acc_ista / parallel_cd; requires
    ``tol``): every row converges independently. The state carries a
    per-row ``done`` mask and iteration counts; converged rows freeze, so
    each row's output equals stopping that row's own solve at its own
    convergence. ``diff_fn`` then returns the count of unconverged rows,
    and the state ends in ``(..., done, niter_rows)``. The acc_ista restart
    is row-local: each row is its own convex problem.
    """
    dtype = y.dtype
    rdt = real_dtype(dtype)
    ah = a.conj().T
    gram = a @ ah                        # (n_feat, n_feat), Hermitian PSD
    my = y if mask is None else mask * y
    yah = my @ ah                        # (n_samples, n_feat)

    if x is None:
        x = torch.zeros((y.shape[0], a.shape[0]), dtype=dtype,
                        device=y.device)

    if mask is None:
        def grad(x_):
            return x_ @ gram - yah
    elif use_kernel:
        # The masked gradient in one kernel: the M x N reconstruction never
        # reaches device memory.
        mask_k = mask if kernel_mask is None else kernel_mask
        limbs = (cuda_lasso.grad_limbs(a)
                 if a.is_cuda and cuda_lasso.grad_takes_packed(a) else None)

        def grad(x_):
            return cuda_lasso.masked_grad_rows(my, mask_k, x_, a,
                                               a_limbs=limbs)
    else:
        def grad(x_):
            return (mask * (x_ @ a) - my) @ ah

    red = (lambda t: t) if reduce_sum is None else reduce_sum

    def sumsq(v):
        return red(torch.sum(_abs2(v)))

    def objective(x_):
        resid = (my - x_ @ a) if mask is None else (my - mask * (x_ @ a))
        return 0.5 * sumsq(resid) + red(torch.sum(alpha * torch.abs(x_)))

    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=y.device)

    def rel_change(x_old, x_new):
        return torch.sqrt(sumsq(x_new - x_old)) / torch.maximum(
            torch.sqrt(sumsq(x_new)), tiny)

    if per_problem and method not in _GRAD_METHODS:
        raise DecompError(
            f"per_problem convergence is not supported for method "
            f"{method!r} (sequential 'cd' sweeps cannot freeze rows)")
    if per_problem and tol is None:
        raise ValueError("per_problem=True requires tol")

    if method == "cd":
        return _cd_machinery(gram, yah, x, alpha, dtype, rel_change,
                             objective)

    stepsz = _step_size(gram, method, lipschitz)
    thresh = alpha * stepsz

    def prox(v):
        return soft_threshold(v - stepsz * grad(v), thresh)

    momentum = method in ("fista", "acc_ista")
    restart = method == "acc_ista"
    n_rows = y.shape[0]
    ones_t = torch.ones((n_rows,), dtype=rdt, device=y.device)

    def row_real_vdot(u, v):
        return torch.sum((u.conj() * v).real if u.is_complex() else u * v,
                         dim=-1)

    def row_sumsq(v):
        return torch.sum(_abs2(v), dim=-1)

    def momentum_step(x_, z, t):
        """One FISTA step from z with per-row momentum, and the row-local
        adaptive restart (O'Donoghue & Candes) when the momentum direction
        opposes the row's last proximal step."""
        x_new = prox(z)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z_new = x_new + ((t - 1.0) / t_new).to(rdt)[:, None] * (x_new - x_)
        if restart:
            do = row_real_vdot(z - x_new, x_new - x_) > 0
            t_new = torch.where(do, ones_t, t_new)
            z_new = torch.where(do[:, None], x_new, z_new)
        return x_new, z_new, t_new

    if not per_problem:
        if momentum:
            def step(state, it):
                return momentum_step(*state)

            init = ((x, momentum_init[0], momentum_init[1])
                    if momentum_init is not None else (x, x, ones_t))
        else:
            def step(state, it):
                return (prox(state[0]),)

            init = (x,)

        def diff_fn(old, new):
            return rel_change(old[0], new[0])
    else:
        tol_r = torch.tensor(float(tol), dtype=rdt, device=y.device)
        if per_problem_init is not None:
            done0 = per_problem_init[0].to(torch.bool)
            nit0 = per_problem_init[1].to(torch.int32)
        else:
            done0 = torch.zeros((n_rows,), dtype=torch.bool, device=y.device)
            nit0 = torch.zeros((n_rows,), dtype=torch.int32, device=y.device)

        def row_done(x_old, x_cand):
            # Division form, not num < tol * den: for an exactly-zero row
            # den clamps to tiny and tol * tiny is subnormal.
            num = torch.sqrt(row_sumsq(x_cand - x_old))
            den = torch.maximum(torch.sqrt(row_sumsq(x_cand)), tiny)
            return num / den < tol_r

        if momentum:
            def step(state, it):
                x_, z, t, done, nit = state
                x_cand, z_cand, t_cand = momentum_step(x_, z, t)
                keep = done[:, None]
                return (torch.where(keep, x_, x_cand),
                        torch.where(keep, z, z_cand),
                        torch.where(done, t, t_cand),
                        done | row_done(x_, x_cand),
                        nit + (~done).to(torch.int32))

            init = ((x, momentum_init[0], momentum_init[1], done0, nit0)
                    if momentum_init is not None
                    else (x, x, ones_t, done0, nit0))
        else:
            def step(state, it):
                x_, done, nit = state
                x_cand = prox(x_)
                return (torch.where(done[:, None], x_, x_cand),
                        done | row_done(x_, x_cand),
                        nit + (~done).to(torch.int32))

            init = (x, done0, nit0)

        def diff_fn(old, new):
            # The count of rows still iterating; the caller compares it
            # with a fixed 0.5, never the user tol.
            return red(torch.sum((~new[-2]).to(rdt)))

    def obj_fn(state):
        return objective(state[0])

    return step, init, diff_fn, obj_fn


def _step_size(gram, method, lipschitz):
    """The gradient step in gram's real dtype: 1 / L (scalar), or for
    'parallel_cd' the diagonally preconditioned theta / diag(gram) (F,)."""
    rdt = real_dtype(gram.dtype)
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=gram.device)
    if method != "parallel_cd":
        lip = spectral_norm_psd(gram) if lipschitz is None else lipschitz
        return (1.0 / lip).to(rdt)
    diag = torch.maximum(torch.diagonal(gram).real, tiny)
    # theta = 1 / lambda_max(D^-1/2 gram D^-1/2): the largest step for which
    # the diagonal metric D / theta majorises the quadratic.
    scale = 1.0 / torch.sqrt(diag)
    ngram = (scale[:, None] * gram * scale[None, :]).to(gram.dtype)
    theta = (1.0 / spectral_norm_psd(ngram)).to(rdt)
    return (theta / diag).to(rdt)


def _abs2(v):
    """|v|^2 elementwise, in v's real dtype."""
    return (v * v.conj()).real if v.is_complex() else v * v


def _cd_machinery(gram, yah, x, alpha, dtype, rel_change, objective):
    """Cyclic coordinate descent (unmasked, scalar alpha): exact
    per-coordinate minimisation, sequential over features. The state is
    ``(x, c)`` with ``c = x @ gram`` kept by rank-1 updates."""
    rdt = real_dtype(dtype)
    tiny = torch.finfo(rdt).tiny
    diag = torch.clamp(torch.diagonal(gram).real, min=tiny)

    def sweep(state, it):
        x_, c = state[0].clone(), state[1]
        for j in range(gram.shape[0]):
            g_jj = diag[j].to(dtype)
            r = yah[:, j] - c[:, j] + x_[:, j] * g_jj
            xj = soft_threshold(r, alpha) / g_jj
            delta = xj - x_[:, j]
            c = c + delta[:, None] * gram[j][None, :]
            x_[:, j] = xj
        return (x_, c)

    def diff_fn(old, new):
        return rel_change(old[0], new[0])

    return sweep, (x, x @ gram), diff_fn, lambda s: objective(s[0])


def _solve(y, a, alpha, x, mask, lipschitz, tol, *, method, maxiter,
           record_objective, check_every=1, per_problem=False,
           use_kernel=False, kernel_mask=None, return_state=False,
           momentum_state=None, per_problem_state=None, reduce_sum=None):
    """The composition path (and the masked kernel path, reading
    ``kernel_mask`` as ``build_solver`` says) on ``run_iterations``;
    ``reduce_sum`` as in ``build_solver``."""
    step, init, diff_fn, obj_fn = build_solver(
        y, a, alpha, x, mask, lipschitz, method=method,
        per_problem=per_problem, tol=tol, use_kernel=use_kernel,
        kernel_mask=kernel_mask, momentum_init=momentum_state,
        per_problem_init=per_problem_state, reduce_sum=reduce_sum)
    # per_problem's diff_fn is the COUNT of unconverged rows, so the loop
    # threshold is a fixed 0.5 (count == 0), never the user tol: a tol > 1
    # must not stop the loop early.
    res = run_iterations(
        step, init, tol=0.5 if per_problem else tol, maxiter=maxiter,
        diff_fn=diff_fn, objective_fn=obj_fn,
        record_objective=record_objective, check_every=check_every,
        diff_nonnegative=True)
    aux = None
    if return_state and method in ("fista", "acc_ista"):
        aux = {"z": res.state[1], "t": res.state[2]}
    if per_problem:
        return LassoResult(x=res.state[0], niter=res.state[-1],
                           converged=res.state[-2], objective=res.objective,
                           aux=aux)
    return LassoResult(x=res.state[0], niter=res.niter,
                       converged=res.converged, objective=res.objective,
                       aux=aux)


def _static_nonpositive(tol) -> bool:
    """True when ``tol`` is a number <= 0: the whole-solve kernel then runs
    its fixed-budget mode (no row can stop before maxiter), bit-identical
    to its exact mode."""
    try:
        return float(tol) <= 0.0
    except (TypeError, ValueError):
        return False


def _solve_whole(y, a, alpha, x, lipschitz, tol, z0, t0, done0, nit0, *,
                 method, maxiter, hi_lo, block_rows=None, return_state=False,
                 fixed=False):
    """The whole-solve kernel path (unmasked batch, per-problem stopping):
    the Gram ``a a^H``, ``y a^H`` and the step size in full f32 (complex64
    for complex data, whose ``solve_rows`` call runs the kernel's complex
    mode), then the whole batched solve in one ``cuda_lasso.solve_rows``
    call (``decomp_tpu``'s ``_whole_core`` and ``_solve_whole_split``)."""
    f32 = torch.float32
    m, f = y.shape[0], a.shape[0]
    dev = y.device
    ah = a.conj().T
    gram = a @ ah
    yah = y @ ah
    stepsz = _step_size(gram, method, lipschitz)       # scalar or (f,)
    thresh = alpha.to(f32) * stepsz                    # scalar or (f,)

    momentum = method in ("fista", "acc_ista")
    x0 = torch.zeros((m, f), dtype=y.dtype, device=dev) if x is None else x
    z0 = x0 if z0 is None else z0
    t0 = torch.ones((m,), dtype=f32, device=dev) if t0 is None else t0
    done0 = (torch.zeros((m,), dtype=f32, device=dev) if done0 is None
             else done0.to(f32))
    nit0 = (torch.zeros((m,), dtype=torch.int32, device=dev) if nit0 is None
            else nit0)
    x_out, z_out, t_out, done, nit = cuda_lasso.solve_rows(
        yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol,
        momentum=momentum, restart=(method == "acc_ista"), maxiter=maxiter,
        hi_lo=hi_lo, fixed=fixed, block_rows=block_rows)
    aux = None
    if return_state and momentum:
        aux = {"z": z_out, "t": t_out[:, 0]}
    return LassoResult(x=x_out, niter=nit[:, 0], converged=done[:, 0] > 0.5,
                       objective=torch.zeros((0,), dtype=f32, device=dev),
                       aux=aux)


def solve_split(y, a, alpha, x=None, *, tol=1e-5, maxiter: int = 1000,
                method: str = "fista", mask=None, lipschitz=None,
                record_objective: bool = False, precision: str = "highest",
                check_every: int = 1, per_problem: bool = False,
                return_state: bool = False, momentum_state=None, state=None,
                use_kernel="auto", kernel_block_rows=None,
                device=None) -> LassoResult:
    """Complex lasso over explicit (re, im) pairs (``decomp_tpu``'s
    ``solve_split``): a thin wrapper over native complex.

    ``y``, ``a`` (and the optional ``x`` warm start and momentum-state
    ``z``) are ``SplitComplex`` pairs, any object with ``.re`` and ``.im``,
    or ``(re, im)`` tuples of real arrays or tensors. They are joined into
    complex64 (f32 parts) or complex128 (f64 parts) and solved by
    ``solve`` with the same options; ``x`` and ``aux["z"]`` come back as
    ``SplitComplex`` pairs of real tensors. Methods: the gradient family
    (ista / fista / acc_ista / parallel_cd); 2-D inputs only.
    ``use_kernel=True`` runs the whole-solve kernel's complex mode, with
    ``decomp_tpu``'s ``use_pallas`` contract: unmasked, ``per_problem``,
    f32 parts, no ``record_objective``, precision 'highest' or 'high',
    scalar or per-feature alpha.
    """
    if method not in _GRAD_METHODS:
        raise DecompError("solve_split supports the gradient methods "
                          f"(ista / fista / acc_ista / parallel_cd), got "
                          f"{method!r}")
    yc = _join_split("y", y)
    ac = _join_split("a", a)
    assertion.assert_ndim("y", yc, 2)
    assertion.assert_ndim("a", ac, 2)
    xc = None if x is None else _join_split("x", x)
    if momentum_state is not None:
        momentum_state = (_join_split("momentum_state z", momentum_state[0]),
                          momentum_state[1])
    if isinstance(state, dict) and "z" in state:
        state = {**state, "z": _join_split("state z", state["z"])}
    res = solve(yc, ac, alpha, xc, tol=tol, maxiter=maxiter, method=method,
                mask=mask, lipschitz=lipschitz,
                record_objective=record_objective, precision=precision,
                check_every=check_every, per_problem=per_problem,
                use_kernel=use_kernel, kernel_block_rows=kernel_block_rows,
                return_state=return_state, momentum_state=momentum_state,
                state=state, device=device)
    aux = res.aux
    if aux is not None:
        aux = {"z": _split(aux["z"]), "t": aux["t"]}
    return res._replace(x=_split(res.x), aux=aux)


def _join_split(name, v):
    """A (re, im) pair, or an object with ``.re`` and ``.im``, of real
    arrays or tensors as one complex array: a tensor where both parts are
    tensors, else numpy (which ``solve`` places by its device rule)."""
    if hasattr(v, "re") and hasattr(v, "im"):
        re, im = v.re, v.im
    elif isinstance(v, (tuple, list)) and len(v) == 2:
        re, im = v
    else:
        raise DecompError(f"{name} must be a SplitComplex or a (re, im) pair "
                          "of real arrays")
    if isinstance(re, torch.Tensor) and isinstance(im, torch.Tensor):
        if re.is_complex() or im.is_complex():
            raise DecompError(f"{name}'s (re, im) parts must be real")
        assertion.assert_same_shape(f"{name}.im", im, f"{name}.re", re)
        rdt = torch.promote_types(torch.promote_types(re.dtype, im.dtype),
                                  torch.float32)
        return torch.complex(re.to(rdt), _device.on_device(
            f"{name}.im", im, re.device, rdt))
    re, im = np.asarray(re), np.asarray(im)
    if np.iscomplexobj(re) or np.iscomplexobj(im):
        raise DecompError(f"{name}'s (re, im) parts must be real")
    assertion.assert_same_shape(f"{name}.im", im, f"{name}.re", re)
    out = np.empty(re.shape, np.result_type(re, im, np.complex64))
    out.real, out.imag = re, im
    return out


def _split(v):
    """A complex tensor as a ``SplitComplex`` of real tensors."""
    return SplitComplex(v.real.contiguous(), v.imag.contiguous())


# The out-of-core variant (host-streamed row chunks) reuses this module's
# solver, so it is imported at the end.
from decomp_tpu_torch.models.lasso_streaming import (  # noqa: E402,F401
    solve_streaming)
