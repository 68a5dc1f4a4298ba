"""Out-of-core dictionary learning: data larger than device memory
(counterpart of ``decomp_tpu.models.dl_streaming``).

The pattern of ``nmf.solve_streaming``: per outer iteration each row chunk
is sparse-coded on the device against the current dictionary (rows are
independent given d), the dictionary statistics A += x_c^H x_c and B +=
x_c^H y_c accumulate on the device, and d is updated once from the
full-data statistics, which is the full-batch alternation. A masked
problem accumulates the Gram x^H x and the gradient x^H (mask * (x d) -
my) instead, the ingredients of the projected-gradient step. With the
inner lasso at its full budget (``lasso_tol=0``) the streamed trajectory is
the full-batch one up to summation order; with an inner tolerance the
inner stop is tested per chunk, as in ``decomp_tpu``.

Each chunk takes the in-core solve's routes: the sweep is
``cuda_dl.bcd_sweep`` where ``dictionary_learning._bcd_mode`` says so, and
with a mask ``dictionary_learning._kernel_mode`` sends the chunk's inner
gradient to ``cuda_lasso.masked_grad_rows`` and its dictionary gradient to
``cuda_dl.masked_grad_dict``. Host arrays stream through the host-array
path, x written back per chunk; a loader with ``jit_loader=True`` runs
loader mode (``decomp_tpu``'s fused epoch as a loop over the chunks: x on
the device, ragged tails, ``check_every``).
"""

from typing import Optional

import numpy as np
import torch

from decomp_tpu_torch.models import dictionary_learning as _dl
from decomp_tpu_torch.models import lasso as _lasso
from decomp_tpu_torch.models import nmf_streaming as _ns
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu
from decomp_tpu_torch.ops.spectral import spectral_norm_psd
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import acc_dtype, real_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.normalize import l2_normalize
from decomp_tpu_torch.utils.result import DictionaryLearningResult


def solve_streaming(
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
    chunk_rows: int = 65536,
    precision: str = "highest",
    callback=None,
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    check_every: int = 5,
    random_seed: int = 0,
    n_samples: Optional[int] = None,
    n_channels: Optional[int] = None,
    dtype=None,
    jit_loader: bool = False,
    record_objective: bool = False,
    use_kernel="auto",
    _bcd_kernel=None,
    device=None,
    _chunk_reserve=None,
) -> DictionaryLearningResult:
    """Out-of-core ``dictionary_learning.solve``.

    ``y``, ``x`` and ``mask`` are host arrays (numpy; a CPU tensor for bf16)
    streamed to ``device`` (default the CUDA device; see ``utils.device``)
    in ``chunk_rows`` blocks; the returned ``x`` is a host array. Complex
    data run natively. ``callback(it, diff)`` fires once per outer
    iteration.

    Loader mode: a callable ``y(lo, hi)`` with ``jit_loader=True``,
    ``n_samples``, ``n_channels`` and ``dtype`` (a real ``torch.dtype``;
    ``mask`` a loader too) and a scalar ``alpha``: x stays on the device
    and is returned there, a ragged trailing chunk reads the clamped window
    [n_samples - chunk_rows, n_samples), and the host reads the stopping
    quantity only every ``check_every`` epochs (the callback fires then).

    stop : 'rel_change' or 'heldout' (masked real problems): each chunk's
        reserve of ``heldout_frac`` of its observed entries is drawn from a
        generator seeded by ``random_seed`` and the chunk's offset, so every
        outer iteration reserves the same entries; coding and the
        dictionary step train on the rest, and iteration stops when the
        validation error's relative improvement between check iterations
        (every ``check_every``-th) falls below ``tol``, after a warm-up of
        ``min(3, max(2, maxiter // check_every))`` checks.
        ``aux["heldout_rel_err"]`` holds the last validation error.
    record_objective : the objective 0.5 ||mask * (y - x d)||^2 + alpha
        ||x||_1 per outer iteration, per chunk with the freshly coded x
        against the pre-update d; incompatible with 'heldout'.
    use_kernel, _bcd_kernel : as in ``dictionary_learning.solve``, per
        chunk: with a mask, 'auto' takes the masked-gradient kernels on
        the card where the in-core solve does (a 0/1 chunk mask packed into
        bits once per chunk); True without a mask runs each chunk's coding
        as ``cuda_lasso.solve_rows``.
    """
    if callable(y):
        if not jit_loader:
            raise DecompError("a callable y requires jit_loader=True "
                              "(host-array DL streaming slices arrays)")
        return _fused_run(_fused_prepare(
            y, d, alpha, x, lasso_method=lasso_method, lasso_iter=lasso_iter,
            lasso_tol=lasso_tol, mask_loader=mask, chunk_rows=chunk_rows,
            precision=precision, stop=stop, heldout_frac=heldout_frac,
            n_samples=n_samples, n_channels=n_channels, dtype=dtype,
            record_objective=record_objective, use_kernel=use_kernel,
            bcd_kernel=_bcd_kernel, device=device), tol=tol, maxiter=maxiter,
            callback=callback, check_every=check_every,
            random_seed=random_seed, heldout_frac=heldout_frac,
            reserve=_chunk_reserve)
    if jit_loader:
        raise DecompError("jit_loader=True requires a callable y loader")
    dev = _device.resolve(None, device)
    y = _ns._host_rows(y)
    assertion.assert_ndim("y", y, 2)
    d = _device.on_device("d", d, dev)
    assertion.assert_ndim("d", d, 2)
    assertion.assert_axis_size("d", d, 1, y.shape[1], "n_channels")
    assertion.assert_nonnegative("alpha", alpha)
    _dl._validate_lasso_method(lasso_method)
    _check_common(precision, stop, heldout_frac, record_objective,
                  masked=mask is not None)
    chunk_rows = int(chunk_rows)
    if chunk_rows < 1:
        raise DecompError("chunk_rows must be >= 1")
    if mask is not None:
        mask = _ns._host_rows(mask)
        assertion.assert_same_shape("mask", mask, "y", y)
    dtype = torch.promote_types(_ns._dtype_of("y", y), d.dtype)
    if stop == "heldout" and dtype.is_complex:
        raise DecompError("stop='heldout' supports real dtypes only")
    n_samples, n_channels = y.shape
    n_atoms = d.shape[0]
    if x is None:
        x = torch.zeros((n_samples, n_atoms), dtype=dtype)
    else:
        x = _ns._host_tensor("x", x).to(dtype, copy=True)
        assertion.assert_axis_size("x", x, 0, n_samples, "n_samples")
        assertion.assert_axis_size("x", x, 1, n_atoms, "n_atoms")
    rdt = real_dtype(dtype)
    alpha = _device.on_device("alpha", alpha, dev, rdt)
    d = l2_normalize(d.to(dtype), axis=1)
    code = _Coder(use_kernel, dev, dtype, n_atoms, n_channels,
                  mask is not None, precision, alpha, lasso_tol, lasso_method,
                  lasso_iter, _bcd_kernel)
    heldout = stop == "heldout"
    reserve = (_ns._reserve_fn(_chunk_reserve, random_seed,
                               float(heldout_frac), dev) if heldout else None)
    ce = max(1, int(check_every))
    warmup = min(3, max(2, int(maxiter) // ce))
    acc = acc_dtype(rdt)
    objs, prev_e, last_e, checks = [], None, None, 0
    niter, converged = 0, False
    for it in range(1, int(maxiter) + 1):
        d_old = d
        is_check = heldout and it % ce == 0
        sa = sb = obj = verr = vnorm = None
        for lo in range(0, n_samples, chunk_rows):
            hi = min(lo + chunk_rows, n_samples)
            yc = _ns._rows(y, lo, hi, dev, dtype)
            xc = x[lo:hi].to(dev)
            mc = None if mask is None else _ns._rows(mask, lo, hi, dev, rdt)
            mc_t = mc
            if heldout:
                val = reserve(lo, tuple(mc.shape)).to(rdt) * mc
                mc_t = mc - val      # train on the remainder
            kmask = code.kernel_mask(mc_t, yc)
            xc = code(yc, d, xc, mc_t, kmask)
            a_c, b_c = _chunk_stats(yc, d, xc, mc_t, kmask)
            if is_check:
                # The freshly coded x against the pre-update d.
                ve, vn = _val_err_chunk(yc, val, xc, d)
                verr = ve if verr is None else verr + ve
                vnorm = vn if vnorm is None else vnorm + vn
            if record_objective:
                oc = _obj_chunk(yc, mc, xc, d, alpha)
                obj = oc if obj is None else obj + oc
            x[lo:hi] = xc.to(x.device)
            sa = a_c if sa is None else sa + a_c
            sb = b_c if sb is None else sb + b_c
        d = code.update_d(sa, sb, d)
        diff = float(_ns._rel_diff(d_old, d))
        if record_objective:
            objs.append(obj)
        niter = it
        if callback is not None:
            callback(it, diff)
        if heldout:
            if is_check:
                e = float(verr) / max(float(vnorm), 1e-300)
                last_e, checks = e, checks + 1
                # No plateau verdict during the warm-up.
                if prev_e is not None and checks >= warmup and (
                        (prev_e - e) / max(prev_e, 1e-300) < float(tol)):
                    converged = True
                    break
                prev_e = e
        elif diff < float(tol):
            converged = True
            break
    return _result(_ns._host_result(x), d, niter, converged, objs, maxiter,
                   record_objective, acc, last_e, dev)


def _fused_prepare(y_loader, d, alpha, x, *, lasso_method, lasso_iter,
                   lasso_tol, mask_loader, chunk_rows, precision, stop,
                   heldout_frac, n_samples, n_channels, dtype,
                   record_objective, use_kernel, bcd_kernel, device,
                   shards=None):
    """Loader mode's checks and set-up (``decomp_tpu``'s
    ``_solve_streaming_fused``), before any loader call: the chunk source,
    d normalised and x padded to the grid on the device, and the chunk
    coder. ``shards``: (ranks, this rank's index) of a sharded run,
    whose grid is ``nmf_streaming.rank_grid``'s and whose ``x``, the global
    warm start, gives the rank its rows; None for one process."""
    _dl._validate_lasso_method(lasso_method)
    if n_samples is None or n_channels is None or dtype is None:
        raise DecompError("a callable y requires explicit n_samples, "
                          "n_channels and dtype")
    if not isinstance(dtype, torch.dtype):
        raise DecompError(f"dtype must be a torch.dtype, got {dtype!r}")
    if dtype.is_complex:
        raise DecompError("DL loader mode supports real dtypes only "
                          "(complex problems stream through the host-array "
                          "path)")
    if mask_loader is not None and not callable(mask_loader):
        raise DecompError("with a callable y, mask must also be a "
                          "callable (lo, hi) -> chunk")
    masked = mask_loader is not None
    _check_common(precision, stop, heldout_frac, record_objective, masked)
    n_samples, n_channels = int(n_samples), int(n_channels)
    chunk_rows = int(chunk_rows)
    if chunk_rows < 1:
        raise DecompError("chunk_rows must be >= 1")
    if chunk_rows > n_samples:
        raise DecompError(
            f"chunk_rows={chunk_rows} exceeds n_samples={n_samples}")
    if np.asarray(alpha).ndim:
        raise DecompError("DL loader mode supports a scalar alpha")
    dev = _device.resolve(None, device)
    d = _device.on_device("d", d, dev, dtype)
    assertion.assert_ndim("d", d, 2)
    assertion.assert_axis_size("d", d, 1, n_channels, "n_channels")
    assertion.assert_nonnegative("alpha", alpha)
    d = l2_normalize(d, axis=1)
    n_atoms = d.shape[0]
    alpha = _device.on_device("alpha", float(alpha), dev, dtype)
    row0, n_chunks = (0, None) if shards is None else _ns.rank_grid(
        n_samples, chunk_rows, *shards)
    src = _ns._LoaderChunks(y_loader, mask_loader, n_samples, chunk_rows, dev,
                            dtype, row0=row0, n_chunks=n_chunks)
    n_pad = src.n_chunks * chunk_rows
    if x is None:
        x = torch.zeros((n_pad, n_atoms), dtype=dtype, device=dev)
    else:
        if shards is None:
            x = _device.on_device("x", x, dev, dtype)
        assertion.assert_axis_size("x", x, 0, n_samples, "n_samples")
        assertion.assert_axis_size("x", x, 1, n_atoms, "n_atoms")
        if shards is not None:
            x = _ns.rank_rows("x", x, row0, row0 + n_pad, dev, dtype)
        x = torch.cat([x, x.new_zeros((n_pad - x.shape[0], n_atoms))])
    code = _Coder(use_kernel, dev, dtype, n_atoms, n_channels, masked,
                  precision, alpha, lasso_tol, lasso_method, lasso_iter,
                  bcd_kernel, bits=_ns._MaskBits(src.n_chunks))
    return dict(src=src, d=d, x=x, alpha=alpha, code=code,
                record_objective=record_objective, heldout=stop == "heldout",
                dev=dev)


def _fused_run(prep, *, tol, maxiter, callback, check_every, random_seed,
               heldout_frac, reserve, reduce_sum=None):
    """Loader mode's epochs on ``_fused_prepare``'s set-up (the body of
    ``decomp_tpu``'s ``_build_dl_fused_epoch``): each epoch one pass over
    the chunks and one dictionary update, driven by
    ``nmf_streaming._drive``. ``reduce_sum`` (sharded): the sum over the
    ranks of (A, B, the objective, the validation sums), once an epoch, in
    one buffer, before the update, which then runs on the same sums on
    every rank. Each chunk's inner lasso stops on its own, as in one
    process."""
    src, code, alpha = prep["src"], prep["code"], prep["alpha"]
    record_objective, heldout, dev = (prep["record_objective"],
                                      prep["heldout"], prep["dev"])
    c, dtype = src.chunk_rows, src.dtype
    if heldout:
        reserve = _ns._reserve_fn(reserve, random_seed, float(heldout_frac),
                                  dev)
    acc = acc_dtype(dtype)

    def epoch(state, with_val):
        x_, d_ = state
        sa = sb = obj = verr = vnorm = None
        for i in range(src.n_chunks):
            yc, mc, valid = src.load(i)
            mc_full = mc
            if heldout:
                val = reserve(src.offset(i), tuple(yc.shape)).to(dtype) * mc
                mc = mc - val
            sl = slice(i * c, (i + 1) * c)
            xc_prev = x_[sl]
            kmask = code.kernel_mask(mc, yc, i)
            xc = code(yc, d_, xc_prev, mc, kmask)
            a_c, b_c = _chunk_stats(yc, d_, xc, mc, kmask)
            if valid is not None:
                # Tail rows hold zero data and zero x, which coding keeps;
                # the select guards the padding all the same.
                xc = torch.where(valid, xc, xc_prev)
            x_[sl] = xc
            sa = a_c if sa is None else sa + a_c
            sb = b_c if sb is None else sb + b_c
            if record_objective:
                oc = _obj_chunk(yc, mc_full, xc, d_, alpha)
                obj = oc if obj is None else obj + oc
            if with_val:
                ve, vn = _val_err_chunk(yc, val, xc, d_, acc)
                verr = ve if verr is None else verr + ve
                vnorm = vn if vnorm is None else vnorm + vn
        if reduce_sum is not None:
            sa, sb, obj, verr, vnorm = _ns.reduce_together(
                reduce_sum, sa, sb, obj, verr, vnorm)
        d_new = code.update_d(sa, sb, d_)
        return (x_, d_new), _ns._rel_diff(d_, d_new), obj, verr, vnorm

    (x, d), niter, converged, objs, last_e = _ns._drive(
        epoch, (prep["x"], prep["d"]), maxiter=int(maxiter), tol=float(tol),
        check_every=check_every, heldout=heldout, callback=callback,
        record_objective=record_objective)
    return _result(x[:src.rows], d, niter, converged, objs, maxiter,
                   record_objective, acc, last_e, dev)


def _check_common(precision, stop, heldout_frac, record_objective, masked):
    """The checks both paths make of the stopping and precision options."""
    if precision not in _lasso._PRECISIONS:
        raise DecompError(f"precision must be one of {_lasso._PRECISIONS}, "
                          f"got {precision!r}")
    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', "
                          f"got {stop!r}")
    if stop == "heldout":
        if not masked:
            raise DecompError("stop='heldout' requires a mask")
        if record_objective:
            raise DecompError("stop='heldout' is incompatible with "
                              "record_objective")
        if not 0.0 < float(heldout_frac) < 1.0:
            raise DecompError("heldout_frac must be in (0, 1)")


class _Coder:
    """A chunk's sparse coding and the dictionary update, on the in-core
    solve's routes (``dictionary_learning._kernel_mode`` and ``_bcd_mode``,
    decided once for the solve): ``coder(y, d, x, mask, kmask)`` codes a
    chunk; ``kernel_mask(mask, y[, i])`` is the masked kernels' mask of a
    chunk (None: the composition); ``update_d(A, B, d)`` is the sweep, or
    with a mask the projected-gradient step. ``bits``: loader mode's
    ``nmf_streaming._MaskBits``, which packs without a host read after the
    first epoch."""

    def __init__(self, use_kernel, dev, dtype, n_atoms, n_channels, masked,
                 precision, alpha, lasso_tol, lasso_method, lasso_iter,
                 bcd_kernel, bits=None):
        probe = torch.empty((0, n_channels), dtype=dtype, device=dev)
        self.mode = _dl._kernel_mode(use_kernel, probe, True if masked
                                     else None, dtype, n_atoms, None,
                                     precision, alpha)
        self.bcd = _dl._bcd_mode(bcd_kernel, use_kernel, probe, n_atoms,
                                 n_channels, masked=masked)
        self.auto, self.hi_lo = use_kernel == "auto", precision == "high"
        self.masked, self.alpha, self.lasso_tol = masked, alpha, lasso_tol
        self.method, self.iters, self.bits = lasso_method, lasso_iter, bits

    def kernel_mask(self, mask, y, i=None):
        """``lasso._kernel_mask`` of one chunk."""
        if self.mode != "masked" or (
                self.auto and not _lasso._auto_takes_masked(y.dtype)):
            return None
        packed = None
        if cuda_lasso.grad_takes_packed(y):
            packed = (self.bits(i, mask) if self.bits is not None
                      else cuda_mu.pack_mask(mask))
        return mask if packed is None else packed

    def __call__(self, yc, d, xc, mc, kmask):
        if self.mode == "whole":
            return _lasso._solve_whole(
                yc, d, self.alpha, xc, None, self.lasso_tol, None, None,
                None, None, method=self.method, maxiter=self.iters,
                hi_lo=self.hi_lo,
                fixed=_lasso._static_nonpositive(self.lasso_tol)).x
        return _lasso._solve(
            yc, d, self.alpha, xc, mc, None, self.lasso_tol,
            method=self.method, maxiter=self.iters, record_objective=False,
            use_kernel=kmask is not None, kernel_mask=kmask).x

    def update_d(self, sa, sb, d):
        if not self.masked:
            return _dl._bcd_dict_update(sa, sb, d, self.bcd)
        return _masked_d_step(sa, sb, d)


def _chunk_stats(yc, d, xc, mc, kmask):
    """A coded chunk's dictionary statistics (``decomp_tpu``'s
    ``_chunk_code_and_stats_impl``): (x^H x, x^H y) without a mask, (x^H x,
    x^H (mask * (x d) - my)) with one; with ``kmask`` the gradient is one
    ``cuda_dl.masked_grad_dict`` call."""
    xh = xc.conj().T
    gram = xh @ xc
    if mc is None:
        return gram, xh @ yc
    myc = mc * yc
    if kmask is not None:
        return gram, cuda_dl.masked_grad_dict(myc, kmask, xc, d).to(d.dtype)
    return gram, xh @ (mc * (xc @ d) - myc)


def _masked_d_step(gram, grad, d):
    """The projected-gradient dictionary step from summed statistics
    (``dictionary_learning._masked_grad_dict_update``): step 1 /
    lambda_max(x^H x), then unit-norm rows."""
    rdt = real_dtype(d.dtype)
    lip = torch.clamp(spectral_norm_psd(gram), min=torch.finfo(rdt).tiny)
    return l2_normalize(d - grad / lip.to(d.dtype), axis=1)


def _obj_chunk(yc, mc, xc, d, alpha):
    """A chunk's share of 0.5 ||mask * (y - x d)||^2 + sum(alpha |x|) in
    >= f32, the freshly coded x against the pre-update d."""
    acc = acc_dtype(real_dtype(yc.dtype))
    recon = xc @ d
    resid = (yc - recon) if mc is None else mc * yc - mc * recon
    r = resid.to(torch.promote_types(acc, resid.dtype))
    data = 0.5 * torch.sum(_lasso._abs2(r)).to(acc)
    return data + torch.sum(alpha.to(acc) * torch.abs(xc).to(acc))


def _val_err_chunk(yc, val, xc, d, acc=torch.float32):
    """A chunk's (sum val * (y - x d)^2, sum (val * y)^2)."""
    wacc = acc_dtype(real_dtype(yc.dtype))
    recon = (xc @ d).to(wacc)
    yv = (val * yc).to(wacc)
    r = yv - val.to(wacc) * recon
    return torch.sum(r * r).to(acc), torch.sum(yv * yv).to(acc)


def _result(x, d, niter, converged, objs, maxiter, record_objective, acc,
            last_e, dev):
    aux = (None if last_e is None else {"heldout_rel_err": torch.tensor(
        float(np.sqrt(last_e)), dtype=torch.float32, device=dev)})
    return DictionaryLearningResult(
        x=x, d=d, niter=niter, converged=converged,
        objective=_ns._curve(objs, maxiter, record_objective, acc), aux=aux)
