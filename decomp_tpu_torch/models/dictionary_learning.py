"""Dictionary learning: alternating sparse coding and dictionary updates
(counterpart of ``decomp_tpu.models.dictionary_learning``).

Minimise over (x, d)

    0.5 * ||mask * (y - x @ d)||^2 + alpha * ||x||_1,   ||d_k||_2 = 1

by alternating (i) a lasso sparse-coding step of ``lasso_iter`` inner
iterations, warm-started from the previous codes, and (ii) a dictionary
update: block coordinate descent over the atoms from the statistics A =
x^H x (K, K) and B = x^H y (K, N) without a mask, a projected-gradient step
with a mask; both end on unit-norm atoms. ``minibatch`` runs the online
variant (Mairal et al.): each outer iteration codes a random batch of rows
and updates d from exponentially forgotten statistics.

The kernels of ``ops.cuda_dl`` carry the dictionary updates: ``bcd_sweep``
(the whole sequential sweep in one launch) and ``masked_grad_dict`` (the
masked gradient in one pass over the data). With ``use_kernel`` the inner
coding runs the kernels of ``ops.cuda_lasso``: ``masked_grad_rows`` once per
inner iteration with a mask, the whole fixed-budget ``solve_rows`` without
one. On a CPU tensor each wrapper runs its plain twin.

Entry points run on the card unless the caller asks for the CPU
(``utils.device``). ``solve_streaming`` (``models.dl_streaming``) streams row
chunks of host arrays or loaders through the device. Not ported, and refused
with ``DecompError``: ``solve_split`` (the split-complex machinery is not
ported; complex data runs natively through ``solve``).
"""

from typing import Optional

import torch

from decomp_tpu_torch.models import lasso as _lasso
from decomp_tpu_torch.models import nmf as _nmf
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso
from decomp_tpu_torch.ops.loop import run_iterations
from decomp_tpu_torch.ops.spectral import spectral_norm_psd
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.normalize import l2_norm, l2_normalize
from decomp_tpu_torch.utils.result import DictionaryLearningResult

#: Sparse-coding methods usable inside dictionary learning. 'cd' is
#: excluded: its sequential coordinate sweeps don't batch across the
#: sample axis the way the outer alternation assumes.
_DL_LASSO_METHODS = ("ista", "fista", "acc_ista", "parallel_cd")


def _validate_lasso_method(lasso_method):
    """Reject unsupported sparse-coding methods before any work."""
    if lasso_method == "cd":
        raise DecompError("lasso_method 'cd' is not supported inside "
                          "dictionary learning; use "
                          "'fista'/'parallel_cd'")
    if lasso_method not in _DL_LASSO_METHODS:
        raise DecompError(
            f"lasso_method must be one of {_DL_LASSO_METHODS}, got "
            f"{lasso_method!r}")


def solve(
    y,
    d,
    alpha,
    x=None,
    *,
    tol=1e-4,
    maxiter: int = 100,
    lasso_method: str = "fista",
    lasso_iter: int = 10,
    lasso_tol=1e-6,
    mask=None,
    minibatch: Optional[int] = None,
    forget: float = 0.9,
    random_seed: int = 0,
    record_objective: bool = False,
    precision: str = "highest",
    use_kernel="auto",
    kernel_block_rows=None,
    _bcd_kernel=None,
    complex_split="auto",
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    device=None,
) -> DictionaryLearningResult:
    """Learn a unit-atom dictionary ``d`` and sparse codes ``x`` for ``y``.

    Parameters
    ----------
    y : (n_samples, n_channels), real or complex.
    d : (n_atoms, n_channels) initial dictionary (required; rows are
        renormalised to unit L2 norm before iterating).
    alpha : nonnegative sparse-coding weight (scalar or per atom).
    x : optional warm-start codes (n_samples, n_atoms). A ``decomp_tpu``
        result carries over with ``utils.convert.from_numpy``: pass its
        ``d`` and ``x=``.
    tol : stop when the relative change of ``d`` drops below this.
    lasso_method / lasso_iter / lasso_tol : inner sparse-coding controls
        (any non-'cd' method of ``lasso``); the inner loop stops early when
        its global relative change falls below ``lasso_tol``, which costs
        one host read per inner iteration when ``lasso_tol > 0``.
    mask : (n_samples, n_channels) 1/0 observedness mask.
    minibatch : if set, online variant: each outer iteration sparse-codes a
        random row batch and updates ``d`` from exponentially smoothed
        sufficient statistics (decay ``forget``). The batches are drawn
        from ``torch.Generator(device=y.device).manual_seed(random_seed)``,
        which cannot reproduce ``jax.random``'s draws, so a seeded
        minibatch trajectory differs from ``decomp_tpu``'s.
    random_seed : seed of the minibatch draws and (salted) of the held-out
        reserve, as in ``nmf.solve``.
    record_objective : record the full-data objective each outer iteration.
    precision : the products of the whole-solve inner kernel
        (``use_kernel=True`` without a mask): 'highest' (full f32) or 'high'
        (bf16x3). Every other f32 product is full f32 (never TF32).
    use_kernel : True / False / 'auto'. With a mask (full batch), the inner
        gradient runs ``cuda_lasso.masked_grad_rows`` and the dictionary
        gradient ``cuda_dl.masked_grad_dict``: the M x N reconstruction
        never reaches device memory. Without one, True runs the inner
        sparse coding as ``lasso_iter`` iterations of
        ``cuda_lasso.solve_rows`` (float32, scalar alpha, per-row stopping
        at ``lasso_tol``, its fixed-budget mode at ``lasso_tol <= 0``).
        A 0/1 mask goes to both gradients as bits, packed once per
        solve, for f32 data (on the CPU, any data). 'auto' takes the masked
        kernels for a CUDA ``y`` where the card measured them faster than
        the composition (bf16 or f32 data, a 0/1 or weighted mask:
        ``lasso._auto_takes_masked``) at up to 128 atoms, and above that,
        up to the TPU kernel's gate (``cuda_lasso.grad_fits``), f32 data at
        N >= 256 on the wide route (``lasso._auto_width``); it never takes the
        whole-solve kernel (a fixed short inner budget leaves it nothing to
        gain). On a CPU tensor each kernel's plain twin runs.
        ``use_kernel=False``
        also vetoes the BCD sweep kernel, which 'auto' takes for unmasked
        real f32 data on the card whose K x N is inside the TPU kernel's
        gate (``cuda_dl.bcd_fits``: up to 256 x 3,712, 8 x 98,176 or
        1,736 x 128 atoms x channels), here, streamed and sharded.
    kernel_block_rows : rows per stripe of the whole-solve inner kernel (16
        or 32); refused where that kernel does not run.
    _bcd_kernel : private override of the BCD sweep kernel: None (auto),
        True (forced; unmasked real f32 only) or False.
    complex_split : accepted for ``decomp_tpu`` compatibility. Complex
        inputs always run natively in complex64/complex128.
    stop : 'rel_change' (default) or 'heldout' (masked real full-batch
        problems): reserve ``heldout_frac`` of the observed entries as a
        validation set, train on the rest, and stop when the validation
        error's relative improvement per outer iteration drops below
        ``tol`` (or the error rises), after a warm-up of
        ``min(10, maxiter - 1)`` iterations. ``aux["heldout_rel_err"]``
        carries the final validation error.
    heldout_frac : reserved fraction under stop='heldout'.
    device : where host-array inputs go (default the CUDA device; see
        ``utils.device``). A tensor ``y`` stays on its device.

    Returns
    -------
    DictionaryLearningResult(x, d, niter, converged, objective, aux)
    """
    del complex_split   # complex runs natively
    if precision not in _lasso._PRECISIONS:
        raise DecompError(f"precision must be one of {_lasso._PRECISIONS}, "
                          f"got {precision!r}")
    dev = _device.resolve(y, device)
    y = _device.on_device("y", y, dev)
    dev = y.device
    d = _device.on_device("d", d, dev)
    assertion.assert_inexact("y", y)
    assertion.assert_ndim("y", y, 2)
    assertion.assert_ndim("d", d, 2)
    assertion.assert_axis_size("d", d, 1, y.shape[1], "n_channels")
    dtype = torch.promote_types(y.dtype, d.dtype)
    y = y.to(dtype)
    d = d.to(dtype)
    rdt = real_dtype(dtype)
    n_samples, n_channels = y.shape
    n_atoms = d.shape[0]
    if x is not None:
        x = _device.on_device("x", x, dev, dtype)
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, n_samples, "n_samples")
        assertion.assert_axis_size("x", x, 1, n_atoms, "n_atoms")
    if mask is not None:
        mask = _device.on_device("mask", mask, dev)
        assertion.assert_same_shape("mask", mask, "y", y)
        mask = mask.to(rdt)
    if minibatch is not None:
        minibatch = int(minibatch)
        if not 0 < minibatch <= n_samples:
            raise DecompError(f"minibatch must be in [1, n_samples="
                              f"{n_samples}], got {minibatch}")
    _validate_lasso_method(lasso_method)
    assertion.assert_nonnegative("alpha", alpha)
    alpha = _device.on_device("alpha", alpha, dev, rdt)

    mode = _kernel_mode(use_kernel, y, mask, dtype, n_atoms, minibatch,
                        precision, alpha)
    if kernel_block_rows is not None:
        if mode != "whole":
            raise DecompError("kernel_block_rows sets the stripe height of "
                              "the whole-solve kernel, which this call does "
                              "not run")
        cuda_lasso.stripe_rows(kernel_block_rows, n_atoms)

    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', "
                          f"got {stop!r}")
    val = None
    if stop == "heldout":
        if mask is None:
            raise DecompError("stop='heldout' requires a mask")
        if minibatch is not None:
            raise DecompError("stop='heldout' is incompatible with "
                              "minibatch")
        if dtype.is_complex:
            raise DecompError("stop='heldout' supports real dtypes only")
        if not 0.0 < float(heldout_frac) < 1.0:
            raise DecompError("heldout_frac must be in (0, 1)")
        val = _nmf._heldout_reserve(mask, float(heldout_frac),
                                    int(random_seed))

    bcd = _bcd_mode(_bcd_kernel, use_kernel, y, n_atoms, n_channels,
                    masked=mask is not None)
    return _solve(
        y, d, x, mask, val, alpha, tol=float(tol), lasso_tol=float(lasso_tol),
        forget=float(forget), maxiter=int(maxiter),
        lasso_method=lasso_method, lasso_iter=int(lasso_iter),
        minibatch=minibatch, record_objective=bool(record_objective),
        kernel=mode, auto=use_kernel == "auto", hi_lo=precision == "high",
        block_rows=kernel_block_rows, bcd_kernel=bcd,
        random_seed=int(random_seed))


def _kernel_mode(use_kernel, y, mask, dtype, n_atoms, minibatch, precision,
                 alpha):
    """'masked', 'whole' or None: which kernels the solve runs
    (``decomp_tpu``'s ``use_pallas`` routing,
    ``dictionary_learning.py:195-242``)."""
    if use_kernel == "auto":
        ok = (mask is not None and y.is_cuda and minibatch is None
              and dtype in (torch.bfloat16, torch.float32)
              and _lasso._auto_width(y.shape[1], n_atoms, dtype))
        return "masked" if ok else None
    if not use_kernel:
        return None
    if minibatch is not None:
        raise DecompError("use_kernel=True is incompatible with minibatch")
    if dtype.is_complex:
        raise DecompError("use_kernel=True does not support complex dtypes")
    if mask is not None:
        return "masked"
    if dtype != torch.float32:
        raise DecompError("the whole-solve sparse-coding kernel requires "
                          f"float32 inputs, got {dtype}")
    if precision not in ("highest", "high"):
        raise DecompError("the whole-solve sparse-coding kernel supports "
                          "precision 'highest'/'high'")
    if alpha.dim() != 0:
        raise DecompError("the whole-solve sparse-coding kernel requires a "
                          "scalar alpha")
    return "whole"


def _bcd_mode(override, use_kernel, y, n_atoms, n_channels, masked=False):
    """Whether the dictionary sweep runs ``cuda_dl.bcd_sweep`` (the
    counterpart of ``decomp_tpu``'s ``_resolve_bcd``). ``override`` (the
    private ``_bcd_kernel``) forces: None = auto (a CUDA real f32 unmasked
    problem whose K x N the kernel takes), True / False. Forcing it on a
    masked problem raises (the masked dictionary step is a projected
    gradient, so the force would do nothing), as does forcing it on other
    than f32 data; ``use_kernel=False`` vetoes auto. On a CPU tensor the
    forced kernel is its twin."""
    if override not in (None, True, False):
        raise DecompError("_bcd_kernel must be None (auto), True or False, "
                          f"got {override!r}")
    if override:
        if masked:
            raise DecompError(
                "the BCD sweep kernel applies to UNMASKED dictionary "
                "updates only (masked problems take the projected-"
                "gradient dictionary step); drop _bcd_kernel or the mask")
        if y.dtype != torch.float32:
            raise DecompError("the BCD sweep kernel requires real float32 "
                              f"statistics, got {y.dtype}")
        return True
    if override is not None:
        return False
    if use_kernel is not None and not use_kernel:
        return False
    return (not masked and y.is_cuda and y.dtype == torch.float32
            and cuda_dl.bcd_fits(n_atoms, n_channels))


def _solve(y, d, x, mask, val, alpha, *, tol, lasso_tol, forget, maxiter,
           lasso_method, lasso_iter, minibatch, record_objective,
           kernel=None, auto=False, hi_lo=False, block_rows=None,
           bcd_kernel=False, random_seed=0, batch_idx=None, reduce_sum=None):
    """The alternation, after ``solve``'s checks. ``val``: the held-out
    validation set (0/1, inside ``mask``) under stop='heldout', else None;
    ``solve`` draws it with ``nmf._heldout_reserve``, and a parity test may
    pass ``decomp_tpu``'s. ``kernel``: ``_kernel_mode``'s answer; with
    ``auto``, the masked kernels are also subject to
    ``lasso._auto_takes_masked``.
    ``batch_idx``: the minibatch rows of each outer iteration, (maxiter,
    minibatch), instead of the seeded draws (a parity test passes
    ``decomp_tpu``'s).

    ``reduce_sum``: a row-sharded solve (``parallel.dictionary_learning``,
    full batch) runs this on its rows with the sum over its ranks, which
    codes each rank's rows through ``lasso.build_solver(reduce_sum=)``,
    sums the dictionary's statistics (A and B, or the masked gradient and
    x^H x) and every cross-row scalar; d, made from the summed statistics,
    is then the same on every rank. None: the identity."""
    red = _nmf._identity if reduce_sum is None else reduce_sum
    rdt = real_dtype(y.dtype)
    tiny = torch.finfo(rdt).tiny
    d = l2_normalize(d, axis=1)
    if x is None:
        x = torch.zeros((y.shape[0], d.shape[0]), dtype=y.dtype,
                        device=y.device)
    hd = None
    if val is not None:
        mask, hd = _nmf._heldout_split(y, mask, val, red)
    my = y if mask is None else mask * y
    kernel_mask = None
    if kernel == "masked":
        # The masked kernels' mask, packed once per solve (the training
        # mask under stop='heldout'): the inner gradient's and the
        # dictionary gradient's.
        kernel_mask = _lasso._kernel_mask(mask, y, auto, reduce_sum)
        if kernel_mask is None:
            kernel = None

    if kernel == "whole":
        # The inner coding in one solve_rows launch per outer iteration,
        # each row stopping on its own at lasso_tol (its fixed-budget mode
        # at lasso_tol <= 0, bit-identical to the exact mode there).
        fixed = _lasso._static_nonpositive(lasso_tol)

        def sparse_code(y_, d_, x_, mask_):
            return _lasso._solve_whole(
                y_, d_, alpha, x_, None, lasso_tol, None, None, None, None,
                method=lasso_method, maxiter=lasso_iter, hi_lo=hi_lo,
                block_rows=block_rows, fixed=fixed).x
    else:
        def sparse_code(y_, d_, x_, mask_):
            return _lasso._solve(
                y_, d_, alpha, x_, mask_, None, lasso_tol,
                method=lasso_method, maxiter=lasso_iter,
                record_objective=False, use_kernel=kernel == "masked",
                kernel_mask=kernel_mask, reduce_sum=reduce_sum).x

    def objective(state):
        recon = state[0] @ state[1]
        resid = (my - recon) if mask is None else (my - mask * recon)
        return (0.5 * red(torch.sum(_lasso._abs2(resid)))
                + red(torch.sum(alpha * torch.abs(state[0]))))

    def diff_fn(old, new):
        return l2_norm(new[1] - old[1]) / torch.clamp(l2_norm(old[1]),
                                                      min=tiny)

    val_sqerr = None
    if hd is not None:
        # diff is the validation error's relative improvement; it goes
        # negative when the error rises, and the loop stops then.
        val_sqerr, diff_fn = _nmf._heldout_machinery(hd, y.dtype, red)

    if minibatch is None:
        if mask is None:
            def update_d(x_, d_):
                xh = x_.conj().T
                return _bcd_dict_update(red(xh @ x_), red(xh @ my), d_,
                                        bcd_kernel)
        else:
            def update_d(x_, d_):
                if kernel == "masked":
                    return _masked_grad_dict_update(my, x_, d_, kernel_mask,
                                                    use_kernel=True,
                                                    reduce_sum=red)
                return _masked_grad_dict_update(my, x_, d_, mask,
                                                reduce_sum=red)

        def step(state, it):
            x_ = sparse_code(y, state[1], state[0], mask)
            return (x_, update_d(x_, state[1]))

        init = (x, d)
    else:
        gen = torch.Generator(device=y.device).manual_seed(random_seed)
        f = torch.tensor(forget, dtype=rdt, device=y.device)

        def step(state, it):
            x_, d_, acc_a, acc_b = state
            idx = (batch_idx[it] if batch_idx is not None
                   else torch.randint(0, y.shape[0], (minibatch,),
                                      generator=gen, device=y.device))
            yb = y[idx]
            mb = None if mask is None else mask[idx]
            xb = sparse_code(yb, d_, x_[idx], mb)
            x_ = x_.index_copy(0, idx, xb)
            if mask is None:
                xh = xb.conj().T
                acc_a = f * acc_a + xh @ xb
                acc_b = f * acc_b + xh @ yb
                d_ = _bcd_dict_update(acc_a, acc_b, d_, bcd_kernel)
            else:
                # Masked statistics cannot be folded into (A, B): take a
                # projected-gradient step on the batch instead.
                d_ = _masked_grad_dict_update(mb * yb, xb, d_, mb)
            return (x_, d_, acc_a, acc_b)

        k = d.shape[0]
        init = (x, d,
                torch.zeros((k, k), dtype=y.dtype, device=y.device),
                torch.zeros((k, y.shape[1]), dtype=y.dtype, device=y.device))

    res = run_iterations(
        step, init, tol=tol, maxiter=maxiter, diff_fn=diff_fn,
        objective_fn=objective, record_objective=record_objective,
        # held-out warm-up floor, clamped so that a short budget can still
        # report convergence
        min_iter=min(10, max(maxiter - 1, 0)) if hd is not None else 0,
        diff_nonnegative=hd is None)
    aux = (None if val_sqerr is None
           else {"heldout_rel_err": torch.sqrt(val_sqerr(res.state))})
    return DictionaryLearningResult(
        x=res.state[0], d=res.state[1], niter=res.niter,
        converged=res.converged, objective=res.objective, aux=aux)


def _bcd_dict_update(stats_a, stats_b, d, use_kernel=False):
    """One block-coordinate-descent pass over the atoms (Mairal et al.
    2010, Algorithm 2 shape) with exact unit-norm projection: the rows of
    ``A d = B`` one atom at a time, ``u_k = b_k - a_k d + a_kk d_k``, ``d_k
    <- u_k / ||u_k||``; dead atoms (``||u_k|| <= tiny``) keep their
    direction. ``use_kernel``: the whole sweep in one ``cuda_dl.bcd_sweep``
    launch; otherwise its twin, a host loop over the atoms in d's dtype."""
    if use_kernel:
        return cuda_dl.bcd_sweep(stats_a, stats_b, d)
    return cuda_dl.bcd_sweep_plain(stats_a, stats_b, d)


def _masked_grad_dict_update(my, x, d, mask, use_kernel=False,
                             reduce_sum=_nmf._identity):
    """Projected-gradient dictionary step for the masked loss, then unit-norm
    renormalisation. Step 1/lambda_max(x^H x), a Lipschitz bound that stays
    valid under masking (masking only shrinks the curvature). With
    ``use_kernel`` the gradient x^H (mask * (x d) - my) is one
    ``cuda_dl.masked_grad_dict`` call, and ``mask`` may be the bits of a
    0/1 mask (``lasso._kernel_mask``'s answer), which it routes on.
    ``reduce_sum``: a row-sharded solve sums x^H x and the gradient over
    its ranks."""
    rdt = real_dtype(d.dtype)
    gram = reduce_sum(x.conj().T @ x)
    lip = torch.clamp(spectral_norm_psd(gram), min=torch.finfo(rdt).tiny)
    if use_kernel:
        grad = reduce_sum(cuda_dl.masked_grad_dict(my, mask, x, d)).to(
            d.dtype)
    else:
        grad = reduce_sum(x.conj().T @ (mask * (x @ d) - my))
    return l2_normalize(d - grad / lip.to(d.dtype), axis=1)


def solve_split(*args, **kwargs):
    """Not ported: complex data runs natively through ``solve``."""
    raise DecompError("dictionary_learning.solve_split is not ported to "
                      "decomp_tpu_torch (ROADMAP.md 'Do not port': the "
                      "split-complex machinery): pass complex tensors to "
                      "dictionary_learning.solve, which runs them natively")



# The out-of-core variant reuses this module's dictionary updates, so it is
# imported at its end.
from decomp_tpu_torch.models.dl_streaming import (  # noqa: E402,F401
    solve_streaming,
)
