"""Out-of-core NMF: data larger than device memory (counterpart of
``decomp_tpu.models.nmf_streaming``).

``y`` stays on the host, or comes chunk by chunk from a loader ``y(lo,
hi)``. Each outer iteration streams row chunks of ``chunk_rows`` through
the device: a chunk's x is updated and its share of the d-update
statistics is added to sums that stay on the device; d is then updated
once from the full-data statistics. The x update is row-local, so chunking
changes only the order of the statistics' sums: the streamed trajectory is
the full-batch one.

Two paths:
- the host-array path (``jit_loader=False``): per chunk, the composition of
  ``nmf``'s updates; x on the host (or on the device with ``x_device``), one
  host read per outer iteration;
- loader mode (``jit_loader=True``; a callable ``y``, x on the device):
  ``decomp_tpu``'s fused epoch as a Python loop over the chunks. Each chunk
  is one call of an ``ops.cuda_mu`` kernel where the kernel gate
  (``use_kernel``) engages, else the composition; a ragged trailing chunk
  reads a clamped loader window; ``stop='heldout'`` reserves entries per
  chunk; the first ``hbm_cache_chunks`` chunks stay on the device; and the
  host reads a scalar on check epochs only.

``masked_completion_streaming`` is the ``nmf.masked_completion`` preset over
chunk loaders. Loader mode's epoch also serves the sharded streamer
(``parallel.nmf_streaming``): a rank's chunks start at a global row offset
and the statistics take a reduction hook. ``decomp_tpu``'s compiled-epoch
caches (``epoch_cache_info``, the weak loader caches, the compile fallback)
have no counterpart: there is nothing to compile.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from decomp_tpu_torch.models import nmf as _nmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import assertion, convert
from decomp_tpu_torch.utils import device as _device
from decomp_tpu_torch.utils.dtypes import acc_dtype
from decomp_tpu_torch.utils.exceptions import DecompError, DtypeError
from decomp_tpu_torch.utils.normalize import l2_norm
from decomp_tpu_torch.utils.result import NMFResult


def solve_streaming(
    y,
    d=None,
    *,
    rank: Optional[int] = None,
    x=None,
    tol=1e-4,
    maxiter: int = 100,
    method: str = "mu",
    mask=None,
    chunk_rows: int = 65536,
    random_seed: int = 0,
    eps: float = 1e-15,
    precision: str = "highest",
    factor_dtype=None,
    inner_iter: int = 1,
    callback: Optional[Callable] = None,
    n_samples: Optional[int] = None,
    n_channels: Optional[int] = None,
    dtype=None,
    x_device: bool = False,
    record_objective: bool = False,
    jit_loader: bool = False,
    use_kernel="auto",
    kernel_block_rows: Optional[int] = None,
    hbm_cache_chunks: int = 0,
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    check_every: int = 5,
    device=None,
    _chunk_reserve=None,
) -> NMFResult:
    """Out-of-core ``y ≈ x @ d`` with nonnegative factors.

    Parameters are as in ``nmf.solve`` except:

    y : host array (numpy array or memmap; a CPU tensor for bf16, which
        numpy lacks), shape (n_samples, n_channels), streamed to the device
        in ``chunk_rows`` blocks; or a callable loader ``y(lo, hi)`` that
        returns rows [lo, hi) (numpy or a tensor on any device), called
        with Python ints. A loader needs ``n_samples``, ``n_channels`` and
        ``dtype`` (a ``torch.dtype``), ``mask`` must then be a loader too,
        and it must return the same rows on every call.
    x : warm start; returned as a host array (numpy; a CPU tensor for bf16
        factors), or, with ``x_device``, as a tensor on the device.
    random_seed : without ``d`` and ``x``, the initial factors are
        ``scale * rng.uniform`` from ``np.random.default_rng(random_seed)``,
        d first, as ``decomp_tpu`` draws them, with ``scale`` from the mean
        of the observed entries of the first 4,096 rows. With ``x_device``,
        x is drawn on the device from ``torch.Generator(device)
        .manual_seed(random_seed)`` instead.
    callback : ``callback(it, diff)`` once per outer iteration; in loader
        mode on check epochs only.
    x_device : keep x on the device and update it chunk by chunk.
    record_objective : 0.5 ||mask * (y - x @ d)||^2 per outer iteration,
        evaluated per chunk with the freshly updated x against the
        pre-update d.
    jit_loader : loader mode (requires a callable ``y`` and ``x_device``):
        the epoch loops over the chunks without a host read; n_samples
        need not divide ``chunk_rows`` (<= n_samples): the trailing chunk
        reads the window [n_samples - chunk_rows, n_samples) and its rows
        past n_samples keep their x.
    use_kernel : loader mode: True / False / 'auto'. Each chunk is one call
        of ``cuda_mu.mu_stats_dense``, ``mu_stats_masked``,
        ``kl_stats_dense`` or ``kl_stats_masked`` (a 0/1 mask as bits from
        ``cuda_mu.pack_mask`` where the route takes bits). 'auto' engages
        them on CUDA chunks when every condition of ``nmf.solve``'s gate
        holds (the rank by ``nmf._auto_rank``, bf16 or f32 data,
        factors in the data's dtype or f32, 'kl-mu' without
        ``factor_dtype``, ``inner_iter == 1`` unless dense 'mu', no
        ``record_objective``); True forces them, raising ``DecompError``
        that names the first unmet condition (``ShapeError`` for a rank
        past ``cuda_mu.kernel_takes_rank``: MU and KL above 128 inside the
        TPU kernels' gate), and runs the plain twins on CPU
        chunks. The host-array path refuses True.
    kernel_block_rows : rows per partial of the chunk kernels (see
        ``nmf.solve``).
    hbm_cache_chunks : loader mode: the first this many chunks are loaded
        once, before the first epoch, and stay on the device in the form
        the chunk step reads (the masked data, the kernel's mask bits and
        the held-out reserve).
    stop : 'rel_change' or, in loader mode with a mask, 'heldout': each
        chunk's reserve of ``heldout_frac`` of its observed entries is drawn
        from a generator seeded by ``random_seed`` and the chunk's offset,
        so every epoch reserves the same entries; training uses the rest,
        and iteration stops when the validation error's relative
        improvement between check epochs falls below ``tol`` (after a
        warm-up of ``min(3, max(2, maxiter // check_every))`` checks).
        ``aux["heldout_rel_err"]`` holds the last validation error.
    check_every : loader mode: epochs between host reads of the stopping
        quantity (the validation error under 'heldout'; the relative
        change of d with ``tol > 0`` or a callback).
    device : where the chunks go (default the CUDA device; see
        ``utils.device``). A tensor ``d``, or ``x`` with ``x_device``, on
        another device is refused; streamed chunks are copied.

    Returns NMFResult with ``d`` on the device.
    """
    inner_iter = _check_options(method, stop, use_kernel, precision,
                                inner_iter, kernel_block_rows)
    if not jit_loader:
        if use_kernel is True:
            raise DecompError("use_kernel=True requires jit_loader=True (the "
                              "host-array path streams through the "
                              "composition)")
        if stop == "heldout":
            raise DecompError("stop='heldout' requires jit_loader=True (the "
                              "reserve is drawn per chunk in loader mode)")
        if hbm_cache_chunks:
            raise DecompError("hbm_cache_chunks requires jit_loader=True")
    dev = _device.resolve(None, device)
    if callable(y):
        _check_loaders(mask, n_samples, n_channels, dtype)
        y_loader, mask_loader, y, mask = y, mask, None, None
        n_samples, n_channels, y_dtype = int(n_samples), int(n_channels), dtype
    else:
        y = _host_rows(y)
        assertion.assert_ndim("y", y, 2)
        y_dtype = _dtype_of("y", y)
        if y_dtype.is_complex:
            raise DtypeError("y must be real-valued for NMF")
        n_samples, n_channels = y.shape
        y_loader = mask_loader = None
        if mask is not None:
            mask = _host_rows(mask)
            assertion.assert_same_shape("mask", mask, "y", y)
    factor_dtype, fdt = _factor_dtypes(factor_dtype, y_dtype)
    if d is None and rank is None:
        raise DecompError("provide an initial dictionary `d` or a `rank`")
    masked = mask is not None or mask_loader is not None

    def load_y(lo, hi):
        if y_loader is not None:
            return _load(y_loader, lo, hi, dev, y_dtype)
        return _rows(y, lo, hi, dev)

    def load_mask(lo, hi, cdt):
        if mask_loader is not None:
            return _load(mask_loader, lo, hi, dev, cdt)
        return None if mask is None else _rows(mask, lo, hi, dev, cdt)

    def init_scale(k):
        head = load_y(0, min(n_samples, 4096))
        return _init_scale(head, load_mask(0, min(n_samples, 4096),
                                           head.dtype), k)

    rng = np.random.default_rng(random_seed)
    if d is None:
        d = torch.from_numpy(init_scale(rank)
                             * rng.uniform(size=(rank, n_channels)))
    else:
        d = _given_d(d, rank, n_channels, dev)
    d = d.to(device=dev, dtype=fdt)
    rank = d.shape[0]
    if x is None:
        scale = init_scale(rank)
        if x_device:
            gen = torch.Generator(device=dev).manual_seed(random_seed)
            x = (scale * torch.rand((n_samples, rank), generator=gen,
                                    device=dev)).to(fdt)
        else:
            x = torch.from_numpy(scale * rng.uniform(size=(n_samples, rank)))
            x = x.to(fdt)
    else:
        # The solve updates its own copy of x in place.
        x = (_device.on_device("x", x, dev) if x_device
             else _host_tensor("x", x))
        assertion.assert_ndim("x", x, 2)
        assertion.assert_axis_size("x", x, 0, n_samples, "n_samples")
        assertion.assert_axis_size("x", x, 1, rank, "rank")
        x = x.to(fdt, copy=True)
    chunk_rows = int(chunk_rows)
    if chunk_rows < 1:
        raise DecompError("chunk_rows must be >= 1")
    mixed = factor_dtype is not None
    # Statistics accumulate in >= f32, and in f64 for f64 data.
    acc = acc_dtype(y_dtype)
    eps_t = torch.tensor(eps, dtype=acc if mixed else y_dtype)
    opts = dict(method=method, masked=masked, mixed=mixed, eps=float(eps),
                eps_t=eps_t, inner_iter=inner_iter)
    if jit_loader:
        if y_loader is None:
            raise DecompError("jit_loader=True requires a callable y")
        if not x_device:
            raise DecompError("jit_loader=True requires x_device=True")
        heldout = stop == "heldout"
        _check_loader_mode(chunk_rows, n_samples, heldout, masked,
                           record_objective, heldout_frac)
        use_k = _chunk_kernel_gate(
            use_kernel, on_cuda=dev.type == "cuda", method=method,
            mixed=mixed, record_objective=record_objective, rank=rank,
            n=n_channels, y_dtype=y_dtype, fdt=fdt, masked=masked,
            inner_iter=inner_iter)
        src = _LoaderChunks(y_loader, mask_loader, n_samples, chunk_rows,
                            dev, y_dtype)
        reserve = None
        if heldout:
            reserve = _reserve_fn(_chunk_reserve, random_seed,
                                  float(heldout_frac), dev)
        x, d, niter, converged, objs, last_e = _loader_solve(
            src, x, d, reserve, use_k=use_k, block_rows=kernel_block_rows,
            n_cache=max(0, min(int(hbm_cache_chunks), src.n_chunks)),
            maxiter=int(maxiter), tol=float(tol), check_every=check_every,
            callback=callback, record_objective=record_objective, **opts)
    else:
        x, d, niter, converged, objs = _host_solve(
            load_y, load_mask, x, d, n_samples=n_samples,
            chunk_rows=chunk_rows, maxiter=int(maxiter),
            tol=float(tol), callback=callback,
            record_objective=record_objective, **opts)
        last_e = None
        x = x if x_device else _host_result(x)
    aux = (None if last_e is None else {"heldout_rel_err": torch.tensor(
        float(np.sqrt(last_e)), dtype=torch.float32, device=dev)})
    return NMFResult(x=x, d=d, niter=niter, converged=converged,
                     objective=_curve(objs, maxiter, record_objective, acc),
                     aux=aux)


def _check_options(method, stop, use_kernel, precision, inner_iter,
                   block_rows):
    """The option checks of the streamers (one process and sharded);
    returns the validated ``inner_iter``."""
    if method not in ("mu", "kl-mu"):
        raise DecompError(f"method must be 'mu' or 'kl-mu', got {method!r}")
    if stop not in ("rel_change", "heldout"):
        raise DecompError(f"stop must be 'rel_change' or 'heldout', "
                          f"got {stop!r}")
    if use_kernel not in (True, False, "auto"):
        raise DecompError(f"use_kernel must be True, False or 'auto', "
                          f"got {use_kernel!r}")
    if precision not in _nmf._PRECISIONS:
        raise DecompError(f"precision must be one of {_nmf._PRECISIONS}, "
                          f"got {precision!r}")
    inner_iter = _nmf._validate_inner_iter(inner_iter)
    cuda_mu.validate_block_rows(block_rows)
    return inner_iter


def _check_loaders(mask, n_samples, n_channels, dtype):
    """A loader's contract: explicit n_samples, n_channels and a
    ``torch.dtype``, and a mask that is a loader too."""
    if n_samples is None or n_channels is None or dtype is None:
        raise DecompError("a callable y requires explicit n_samples, "
                          "n_channels and dtype")
    if not isinstance(dtype, torch.dtype):
        raise DecompError(f"dtype must be a torch.dtype, got {dtype!r}")
    if mask is not None and not callable(mask):
        raise DecompError("with a callable y, mask must also be a "
                          "callable (lo, hi) -> chunk")


def _factor_dtypes(factor_dtype, y_dtype):
    """``(factor_dtype, fdt)``: the mixed mode's factor dtype (None where
    it is y's) and the factors' dtype."""
    if not y_dtype.is_floating_point:
        raise DtypeError(f"y must be floating, got dtype {y_dtype}")
    if factor_dtype is not None:
        if not isinstance(factor_dtype, torch.dtype):
            raise DecompError("factor_dtype must be a torch.dtype, got "
                              f"{factor_dtype!r}")
        if factor_dtype == y_dtype:
            factor_dtype = None
    if factor_dtype is not None and (
            torch.finfo(factor_dtype).bits < torch.finfo(y_dtype).bits):
        raise DecompError("factor_dtype must be at least as wide as y's "
                          "dtype")
    return factor_dtype, y_dtype if factor_dtype is None else factor_dtype


def _given_d(d, rank, n_channels, device):
    """A given dictionary on ``device``, its shape checked against
    ``n_channels`` and ``rank``."""
    d = _device.on_device("d", d, device)
    assertion.assert_ndim("d", d, 2)
    assertion.assert_axis_size("d", d, 1, n_channels, "n_channels")
    if rank is not None and d.shape[0] != rank:
        raise DecompError(
            f"rank={rank} inconsistent with d.shape[0]={d.shape[0]}")
    return d


def _check_loader_mode(chunk_rows, n_samples, heldout, masked,
                       record_objective, heldout_frac):
    """Loader mode's checks of the chunk window and the held-out stop."""
    if chunk_rows > n_samples:
        raise DecompError(
            f"chunk_rows={chunk_rows} exceeds n_samples={n_samples}; "
            "reduce chunk_rows (loader mode reads fixed-size windows "
            "inside the data)")
    if heldout:
        if not masked:
            raise DecompError("stop='heldout' requires a mask loader")
        if record_objective:
            raise DecompError("stop='heldout' is incompatible with "
                              "record_objective")
        if not 0.0 < float(heldout_frac) < 1.0:
            raise DecompError("heldout_frac must be in (0, 1)")


def _init_scale(head, mask, k):
    """The random init's scale, sqrt(2 mean / k), from the mean of the
    observed entries of the leading rows ``head`` (missing entries may
    hold any finite value)."""
    acc = acc_dtype(head.dtype)
    if mask is not None:
        total = float(torch.sum((head * mask).to(acc)))
        count = max(float(torch.sum(mask.to(acc))), 1.0)
        mean_y = max(total / count, 1e-30)
    else:
        mean_y = max(float(torch.mean(head.to(acc))), 1e-30)
    return float(np.sqrt(2.0 * mean_y / k))


def _host_solve(load_y, load_mask, x, d, *, n_samples, chunk_rows, maxiter,
                tol, callback, record_objective, method, masked, mixed, eps,
                eps_t, inner_iter):
    """The host-array path (``decomp_tpu``'s :640-692): per outer
    iteration, each chunk's composition step, then d from the summed
    statistics and one host read of its relative change."""
    niter, converged, objs = 0, False, []
    for it in range(1, maxiter + 1):
        d_old = d
        num = den = obj = None
        for lo in range(0, n_samples, chunk_rows):
            hi = min(lo + chunk_rows, n_samples)
            yc = load_y(lo, hi)
            mc = load_mask(lo, hi, yc.dtype)
            xc = x[lo:hi].to(yc.device)
            xc, num_c, den_c, obj_c = _chunk_step(
                yc if mc is None else mc * yc, xc, d, mc, eps_t,
                method=method, mixed=mixed, with_obj=record_objective,
                inner_iter=inner_iter)
            x[lo:hi] = xc.to(x.device)
            num = num_c if num is None else num + num_c
            den = den_c if den is None else den + den_c
            obj = obj_c if obj is None else obj + obj_c
        d = _d_from_stats(d, num, den, eps, method=method, masked=masked)
        diff = float(_rel_diff(d_old, d))
        if record_objective:
            objs.append(obj)
        niter = it
        if callback is not None:
            callback(it, diff)
        if diff < tol:
            converged = True
            break
    return x, d, niter, converged, objs


def _loader_solve(src, x, d, reserve, *, use_k, block_rows, n_cache, maxiter,
                  tol, check_every, callback, record_objective, method,
                  masked, mixed, eps, eps_t, inner_iter, reduce_sum=None):
    """Loader mode (``decomp_tpu``'s fused epoch, :728-1031, and the loop
    over epochs, :453-638): x padded to the chunk grid on the device, one
    pass over the chunks per epoch, the epochs run by ``_drive``.

    ``x`` holds the grid's first rows (``src.rows`` or more); the padding
    rows are zero. ``reduce_sum`` (sharded mode, ``src`` one rank's chunks):
    the sum over the ranks, applied once an epoch, before the d update, to
    one buffer of the statistics, the objective and the validation sums;
    unset, the one-process bits."""
    c, n_pad = src.chunk_rows, src.n_chunks * src.chunk_rows
    if x.shape[0] < n_pad:
        x = torch.cat([x, x.new_zeros((n_pad - x.shape[0], x.shape[1]))])
    acc = acc_dtype(src.dtype)
    bits = _MaskBits(src.n_chunks)
    kl_dense_k = use_k and method == "kl-mu" and not masked

    def prepare(i):
        """What chunk i's step reads: the (training) masked data, the
        training mask, the kernel's mask, the reserve and the reserved
        data."""
        yc, mc, valid = src.load(i)
        val = yv = None
        if reserve is not None:
            val = reserve(src.offset(i), tuple(yc.shape)).to(yc.dtype) * mc
            mc = mc - val   # train on the remainder
            yv = val * yc
        my = yc if mc is None else mc * yc
        kmask = None
        if use_k and masked:
            packs = (cuda_mu.kl_takes_packed(yc) if method == "kl-mu"
                     else cuda_mu.takes_packed(yc))
            kmask = bits(i, mc) if packs else None
            if kmask is None:
                kmask = mc
            else:
                mc = None   # the kernel reads the bits alone
        return _Chunk(my, mc, kmask, val, yv, valid)

    cache = [prepare(i) for i in range(n_cache)]

    def epoch(state, with_val):
        x_, d_ = state
        num = den = obj = verr = vnorm = None
        db = d_.to(src.dtype) if use_k else None
        for i in range(src.n_chunks):
            ch = cache[i] if i < n_cache else prepare(i)
            sl = slice(i * c, (i + 1) * c)
            xc_prev = x_[sl]
            if use_k:
                xc, nc, dc = _kernel_chunk(method, ch, xc_prev, db, eps,
                                           block_rows, inner_iter)
                nc, dc = nc.to(acc), dc.to(acc)
                if kl_dense_k:
                    dc = dc.T      # (1, K) column sums -> (K, 1)
                oc = None
            else:
                xc, nc, dc, oc = _chunk_step(
                    ch.my, xc_prev, d_, ch.mask, eps_t, method=method,
                    mixed=mixed, with_obj=record_objective,
                    inner_iter=inner_iter)
            if ch.valid is not None:
                # The tail's rows past n_samples keep their (zero) x.
                xc = torch.where(ch.valid, xc, xc_prev)
            x_[sl] = xc
            num = nc if num is None else num + nc
            den = dc if den is None else den + dc
            if oc is not None:
                obj = oc if obj is None else obj + oc
            if with_val:
                # The freshly updated x against the pre-update d: compute-
                # dtype products summed in >= f32.
                cdt = ch.my.dtype
                yva = ch.yv.to(acc)
                rv = yva - ch.val.to(acc) * _mm(xc.to(cdt), d_.to(cdt), acc)
                ve, vn = torch.sum(rv * rv), torch.sum(yva * yva)
                verr = ve if verr is None else verr + ve
                vnorm = vn if vnorm is None else vnorm + vn
        if reduce_sum is not None:
            num, den, obj, verr, vnorm = reduce_together(
                reduce_sum, num, den, obj, verr, vnorm)
        d_new = _d_from_stats(d_, num, den, eps, method=method, masked=masked)
        return (x_, d_new), _rel_diff(d_, d_new), obj, verr, vnorm

    (x, d), niter, converged, objs, last_e = _drive(
        epoch, (x, d), maxiter=maxiter, tol=tol, check_every=check_every,
        heldout=reserve is not None, callback=callback,
        record_objective=record_objective)
    return x[:src.rows], d, niter, converged, objs, last_e


def reduce_together(reduce_sum, *parts):
    """``reduce_sum`` of each of ``parts`` (None stays None) in one call per
    dtype: the parts of a dtype laid into one buffer, summed, and cut back
    into their shapes, which is exact. A sharded epoch reduces its
    statistics so: on gloo a rank's time follows the number of calls more
    than their bytes. Each part starts at a multiple of 64 elements into
    the buffer, so that a product on it finds the alignment of a tensor of
    its own."""
    out = list(parts)
    groups = {}
    for i, t in enumerate(parts):
        if t is not None:
            groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        offsets, total = [], 0
        for i in idx:
            offsets.append(total)
            total += -(-parts[i].numel() // 64) * 64
        flat = parts[idx[0]].new_zeros((total,))
        for i, o in zip(idx, offsets):
            flat[o:o + parts[i].numel()] = parts[i].reshape(-1)
        flat = reduce_sum(flat)
        for i, o in zip(idx, offsets):
            out[i] = flat[o:o + parts[i].numel()].view(parts[i].shape)
    return out


class _Chunk(NamedTuple):
    """One chunk as loader mode's step reads it."""

    my: torch.Tensor                  # the training mask times y
    mask: Optional[torch.Tensor]      # the dense training mask; None
                                      # without one or where bits serve
    kmask: Optional[torch.Tensor]     # the kernel's mask: bits or dense
    val: Optional[torch.Tensor]       # the held-out reserve
    yv: Optional[torch.Tensor]        # the reserved data
    valid: Optional[torch.Tensor]     # the tail's rows inside the data


def _kernel_chunk(method, ch, xc_prev, db, eps, block_rows, inner_iter):
    """One chunk through its ``cuda_mu`` kernel (``decomp_tpu``'s
    :870-905): ``(x_new, numd, den)``, the statistics in f32."""
    if method == "kl-mu":
        if ch.kmask is None:
            return cuda_mu.kl_stats_dense(ch.my, xc_prev, db, eps,
                                          block_rows=block_rows)
        return cuda_mu.kl_stats_masked(ch.my, ch.kmask, xc_prev, db, eps,
                                       block_rows=block_rows)
    if ch.kmask is None:
        return cuda_mu.mu_stats_dense(ch.my, xc_prev, db, eps,
                                      block_rows=block_rows,
                                      inner_iter=inner_iter)
    return cuda_mu.mu_stats_masked(ch.my, ch.kmask, xc_prev, db, eps,
                                   block_rows=block_rows)


def _chunk_kernel_gate(use_kernel, *, on_cuda, method, mixed, record_objective,
                       rank, n, y_dtype, fdt, masked, inner_iter):
    """Whether loader mode runs each chunk through its ``cuda_mu`` kernel
    (``decomp_tpu``'s ``_chunk_kernel_gate``, in the terms of
    ``nmf.solve``'s gate). 'auto' engages the kernels on CUDA chunks when
    every condition holds, the rank by ``nmf._auto_rank``; False keeps the
    composition; True forces the kernels (the twins on CPU chunks),
    raising ``DecompError`` that names the first unmet condition, and
    ``ShapeError`` for a rank the kernels do not take at N columns
    (``cuda_mu.kernel_takes_rank``)."""
    if use_kernel is False:
        return False
    rank_ok = (_nmf._auto_rank(method, n, rank, y_dtype, masked, fdt)
               if use_kernel == "auto"
               else cuda_mu.kernel_takes_rank(method, n, rank, y_dtype,
                                              masked))
    reqs = (
        (method == "mu" or not mixed,
         "method must be 'mu', or 'kl-mu' without factor_dtype (the KL "
         "kernels take x and d in the data's dtype)"),
        (not record_objective,
         "record_objective is unsupported (the chunk kernels do not form "
         "the data-fit term)"),
        (inner_iter == 1 or (method == "mu" and not masked),
         "inner_iter > 1 is supported by the chunk kernels only for dense "
         "method='mu' (the masked and KL denominators need fresh data "
         "passes)"),
        (y_dtype in (torch.bfloat16, torch.float32),
         f"the data must be bfloat16 or float32, got {y_dtype}"),
        (fdt in (y_dtype, torch.float32),
         f"the factors must be in the data's dtype or float32, got {fdt}"),
    )
    if use_kernel == "auto":
        return on_cuda and rank_ok and all(cond for cond, _ in reqs)
    for cond, why in reqs:
        if not cond:
            raise DecompError(f"use_kernel=True: {why}")
    cuda_mu.check_rank(method, n, rank, y_dtype, masked)
    return True


def _chunk_step(myc, xc, d, mc, eps, *, method, mixed=False, with_obj=False,
                inner_iter=1):
    """The x update of one row chunk and its d-statistic partials
    (``decomp_tpu``'s ``_chunk_step_impl``): ``(x_new, num, den, obj)``.
    ``myc`` is the chunk's masked data (``mc * y``, or y without a mask).

    'mu':    num = x_new^T my; den = x_new^T x_new (K x K, no mask) or
             x_new^T (mask * (x_new d)) (K x N);
    'kl-mu': num = x_new^T (my / (x_new d + eps)); den = the column sums of
             x_new (K x 1, no mask) or x_new^T mask (K x N).
    Products take compute-dtype (my's) operands and sum in >= f32; mixed
    mode (``factor_dtype``) runs ``nmf``'s mixed x updates. ``obj`` is the
    chunk's 0.5 ||my - mask * (x_new d)||^2 when ``with_obj``, else None.
    """
    acc = acc_dtype(myc.dtype)
    upd = _nmf._UPDATES[method, mixed][0]
    for _ in range(inner_iter):   # accelerated MU: see nmf.solve
        xc = upd(myc, xc, d, mc, eps)
    cdt = myc.dtype
    xc_c = xc.to(cdt)
    if method == "mu":
        num = _tdot(xc_c, myc, acc)
        if mc is None:
            den = _tdot(xc_c, xc_c, acc)
        else:
            recon = (mc.to(acc) * _mm(xc_c, d.to(cdt), acc)).to(cdt)
            den = _tdot(xc_c, recon, acc)
    elif mixed:
        # The ratio forms in f32; products take compute-dtype operands.
        r = _nmf._rows_dot(xc_c, d.to(cdt)) + eps
        num = _tdot(xc_c, (myc.to(torch.float32) / r).to(cdt), acc)
        den = (torch.sum(xc.to(acc), 0)[:, None] if mc is None
               else _tdot(xc_c, mc.to(cdt), acc))
    else:
        r = xc @ d + eps
        num = _tdot(xc, myc / r, acc)
        den = (torch.sum(xc, 0, dtype=acc)[:, None] if mc is None
               else _tdot(xc, mc, acc))
    obj = None
    if with_obj:
        recon_o = _mm(xc_c, d.to(cdt), acc)
        if mc is not None:
            recon_o = mc.to(acc) * recon_o
        resid = myc.to(acc) - recon_o
        obj = 0.5 * torch.sum(resid * resid)
    return xc, num, den, obj


def _mm(a, b, acc):
    """``a @ b`` with the operands' products exact and summed in ``acc``."""
    return a.to(acc) @ b.to(acc)


def _tdot(a, b, acc):
    """``a^T @ b`` like ``_mm``."""
    return a.to(acc).T @ b.to(acc)


def _d_from_stats(d, num, den, eps, *, method, masked):
    """``d * num / (den d + eps)`` (dense 'mu': den is the K x K Gram) or
    ``d * num / (den + eps)``, in the statistics' dtype, stored in d's. The
    dense-MU epilogue's product is full f32 (never TF32), as in
    ``cuda_mu._epilogue``."""
    d_acc = d.to(num.dtype)
    den_full = den @ d_acc if method == "mu" and not masked else den
    return (d_acc * num / (den_full + eps)).to(d.dtype)


def _rel_diff(d_old, d_new):
    """||d_new - d_old|| / max(||d_old||, tiny) in >= f32 (complex d keeps
    its imaginary part)."""
    acc = acc_dtype(d_old.dtype)
    w = torch.promote_types(acc, d_old.dtype)
    return l2_norm((d_new - d_old).to(w)) / torch.clamp(
        l2_norm(d_old.to(w)), min=torch.finfo(acc).tiny)


def _drive(epoch, state, *, maxiter, tol, check_every, heldout, callback,
           record_objective):
    """Loader mode's loop over epochs (``decomp_tpu``'s :572-620 and the DL
    streamer's :669-710): ``epoch(state, with_val) -> (state, diff, obj,
    verr, vnorm)`` as device tensors. The host reads only on check epochs:
    every ``check_every``-th epoch, the validation error under 'heldout'
    (with a warm-up of ``min(3, max(2, maxiter // check_every))`` checks
    before a plateau counts), else the relative change of d where ``tol >
    0`` or a callback needs it (and at the last epoch). The callback fires
    on check epochs only. Returns ``(state, niter, converged, objs,
    last_e)``: the per-epoch objectives as device scalars and the last
    squared relative validation error (None without 'heldout')."""
    need_diff = not heldout and (tol > 0.0 or callback is not None)
    ce = max(1, int(check_every))
    warmup = min(3, max(2, int(maxiter) // ce))
    objs, prev_e, last_e, checks = [], None, None, 0
    niter, converged = 0, False
    for it in range(1, maxiter + 1):
        if heldout and it % ce == 0:
            state, diff, _, verr, vnorm = epoch(state, True)
            e = float(verr) / max(float(vnorm), 1e-300)
            last_e, checks, niter = e, checks + 1, it
            if callback is not None:
                callback(it, float(diff))
            # No plateau verdict during the warm-up: "no progress yet" is
            # not "no progress any more".
            if prev_e is not None and checks >= warmup and (
                    (prev_e - e) / max(prev_e, 1e-300) < tol):
                converged = True
                break
            prev_e = e
            continue
        state, diff, obj, _, _ = epoch(state, False)
        if record_objective:
            objs.append(obj)
        niter = it
        if need_diff and (it % ce == 0 or it == maxiter):
            diff = float(diff)
            if callback is not None:
                callback(it, diff)
            if diff < tol:
                converged = True
                break
    return state, niter, converged, objs, last_e


def _curve(objs, maxiter, record_objective, acc):
    """The NaN-padded (maxiter,) objective curve from the per-iteration
    device scalars, read in one transfer; (0,) without it."""
    if not record_objective:
        return torch.zeros((0,), dtype=torch.float32)
    dt = torch.float64 if acc == torch.float64 else torch.float32
    curve = torch.full((int(maxiter),), float("nan"), dtype=dt)
    if objs:
        curve[:len(objs)] = torch.stack(objs).cpu().to(dt)
    return curve


class _LoaderChunks:
    """Loader mode's chunks: chunk i covers the global rows [row0 + i c,
    row0 + (i + 1) c) of the grid of ``n_chunks`` chunks of c =
    ``chunk_rows`` rows (by default, one process: row0 = 0 and the chunks
    that cover n_samples; sharded, one rank's, from ``rank_grid``). A
    chunk reaching past n_samples reads the clamped window [n_samples - c,
    n_samples), rolled into alignment with its rows at or past n_samples
    zeroed (``decomp_tpu``'s :807-855); a chunk wholly past them (a rank
    holding padding) is all zeros. ``load(i) -> (y, mask, valid)``: the
    chunk's data and mask (None without a mask loader) on the device in
    ``dtype``, and its rows inside the data as a (c, 1) bool tensor, or
    None where all are. ``rows``: how many of the grid's rows lie inside
    the data."""

    def __init__(self, y_loader, mask_loader, n_samples, chunk_rows, device,
                 dtype, row0=0, n_chunks=None):
        self.y_loader, self.mask_loader = y_loader, mask_loader
        self.n_samples, self.chunk_rows = n_samples, chunk_rows
        self.row0 = row0
        self.n_chunks = (-(-n_samples // chunk_rows) if n_chunks is None
                         else n_chunks)
        self.rows = max(0, min(self.n_chunks * chunk_rows, n_samples - row0))
        self.device, self.dtype = device, dtype

    def offset(self, i):
        """Chunk i's global row offset, which keys its held-out reserve."""
        return self.row0 + i * self.chunk_rows

    def load(self, i):
        c = self.chunk_rows
        lo = self.offset(i)
        lo_eff = min(lo, self.n_samples - c)
        s = lo - lo_eff

        def get(loader):
            t = _load(loader, lo_eff, lo_eff + c, self.device, self.dtype)
            if s:
                t = torch.cat([t[s:], t.new_zeros((min(s, c),)
                                                  + tuple(t.shape[1:]))])
            return t

        yc = get(self.y_loader)
        mc = None if self.mask_loader is None else get(self.mask_loader)
        valid = None
        if s:
            valid = (torch.arange(c, device=self.device) < c - s)[:, None]
        return yc, mc, valid


class _MaskBits:
    """The kernel mask of each chunk in loader mode: the bits of a 0/1
    mask, or None for any other. Whether a chunk's mask is 0/1 costs one
    host read, in the first epoch only: the loader returns the same rows
    every epoch, so later epochs pack without a read
    (``cuda_mu.pack_bits``)."""

    def __init__(self, n_chunks):
        self.binary = [None] * n_chunks

    def __call__(self, i, mask):
        if self.binary[i] is None:
            packed = cuda_mu.pack_mask(mask)
            self.binary[i] = packed is not None
            return packed
        return cuda_mu.pack_bits(mask) if self.binary[i] else None


def rank_grid(n_samples, chunk_rows, n_ranks, index):
    """A rank's share of the sharded grid (``decomp_tpu``'s
    ``parallel/nmf_streaming.py:154-158``): ``(row0, n_chunks)``, every rank
    ``ceil(n_samples / (n_ranks chunk_rows))`` chunks from the global row
    row0 = index n_chunks chunk_rows on."""
    n_chunks = -(-n_samples // (n_ranks * chunk_rows))
    return index * n_chunks * chunk_rows, n_chunks


def rank_rows(name, x, lo, hi, device, dtype):
    """Rows [lo, hi) of a global ``x`` (a host array, or a tensor on the host
    or on ``device``) as a new tensor on ``device`` in ``dtype``: a rank's
    rows of a warm start, cut before the copy."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            x = _device.on_device(name, x, device)
        return x[lo:hi].to(device=device, dtype=dtype, copy=True)
    return _as_tensor(np.asarray(x)[lo:hi]).to(device=device, dtype=dtype,
                                               copy=True)


def _reserve_fn(hook, random_seed, frac, device):
    """``reserve(lo, shape)``: the 0/1 draw of the held-out reserve of the
    chunk at aligned offset ``lo`` (each entry with probability ``frac``;
    the caller keeps only the observed ones). It depends on
    (``random_seed``, ``nmf._HELDOUT_SALT``, ``lo``) alone, so every epoch
    reserves the same entries. ``hook(lo, shape)``, a private override,
    gives the draws instead (a parity test passes ``decomp_tpu``'s)."""
    if hook is not None:
        return lambda lo, shape: _as_tensor(hook(lo, shape)).to(device)

    def reserve(lo, shape):
        gen = torch.Generator(device=device).manual_seed(
            _chunk_seed(random_seed, lo))
        return torch.rand(shape, generator=gen, device=device) < frac

    return reserve


def _chunk_seed(random_seed, lo):
    """The reserve's seed for the chunk at offset ``lo``: ``random_seed``
    salted as in ``nmf._heldout_reserve``, with ``lo`` mixed into both
    halves (the CPU generator keeps only the low 32 bits) by an odd
    multiplier, so that distinct offsets below 2^32 get distinct seeds."""
    salt = _nmf._HELDOUT_SALT * (2 ** 32 + 1)
    mix = (int(lo) * 0x9E3779B1) % 2 ** 32 * (2 ** 32 + 1)
    return (int(random_seed) ^ salt ^ mix) % 2 ** 64


def _as_tensor(a):
    """A loader's or host array's rows as a tensor (a tensor as it is; a
    numpy bfloat16 array by its bits; a read-only array copied)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return convert.from_numpy(a, "cpu")
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _host_rows(a):
    """A host array of rows, as numpy (a memmap stays one) or a tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return convert.from_numpy(a, "cpu") if a.dtype.name == "bfloat16" else a


def _dtype_of(name, a):
    if isinstance(a, torch.Tensor):
        return a.dtype
    try:
        return torch.from_numpy(np.empty((0,), a.dtype)).dtype
    except TypeError as err:
        raise DtypeError(f"{name} has no torch dtype: {a.dtype}") from err


def _rows(a, lo, hi, device, dtype=None):
    """Rows [lo, hi) of a host array as a tensor on ``device``: the chunk's
    copy (streamed chunks are copied from wherever they are)."""
    return _as_tensor(a[lo:hi]).to(device=device, dtype=dtype)


def _load(loader, lo, hi, device, dtype):
    """``loader(lo, hi)`` as a contiguous tensor on ``device`` in
    ``dtype``."""
    return _as_tensor(loader(lo, hi)).to(device=device,
                                         dtype=dtype).contiguous()


def _host_tensor(name, a):
    """A host array as a CPU tensor (numpy shares its memory; a tensor on
    another device is refused)."""
    if isinstance(a, torch.Tensor):
        return _device.on_device(name, a, torch.device("cpu"))
    return _as_tensor(a)


def _host_result(t):
    """A host tensor as numpy, where numpy has its dtype (bf16: the
    tensor)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def masked_completion_streaming(y, mask, rank=None, d=None, x=None, *,
                                n_samples, n_channels, dtype,
                                chunk_rows=65536, tol=1e-4, maxiter=4000,
                                heldout_frac=0.05, check_every=25,
                                random_seed=0, mixed="auto", mesh=None,
                                row_axis="rows", **kwargs) -> NMFResult:
    """Out-of-core matrix completion: the ``nmf.masked_completion`` recipe
    (masked MU stopped on held-out error) over chunk loaders, in loader
    mode (``solve_streaming(jit_loader=True, x_device=True,
    stop='heldout')``), or sharded over ``mesh`` (``parallel.nmf
    .solve_streaming`` over ``row_axis``; every rank calls this with the
    same loaders, which take global offsets, and each streams its rows).

    ``y`` and ``mask`` are loaders ``(lo, hi) -> chunk`` (``y`` pre-masked:
    missing entries zero); ``n_samples``, ``n_channels`` and ``dtype`` are
    their contract. ``mixed``: 'auto' (CUDA chunks of dtype f32), True or
    False. Mixed casts each f32 chunk to bf16 as it is loaded and keeps f32
    factors (``factor_dtype``), the completion operating point; loaders
    that already yield bf16 pass through. Other keywords go to the solver
    (``device`` does not apply with ``mesh``: each rank runs on its own).
    """
    if mesh is not None:
        from decomp_tpu_torch.parallel import mesh as _pmesh

        dev = _pmesh.placement(mesh, None)
        if "device" in kwargs:
            raise DecompError("device= does not apply with mesh=: each "
                              "rank streams to its own device")
    else:
        dev = _device.resolve(None, kwargs.get("device"))
    if mixed == "auto":
        mixed = dev.type == "cuda" and dtype == torch.float32
    y_loader, mask_loader = y, mask
    if mixed and dtype == torch.float32:
        y_loader, mask_loader = _bf16_loader(y), _bf16_loader(mask)
        dtype = torch.bfloat16
    if mixed:
        kwargs.setdefault("factor_dtype", torch.float32)
        kwargs.setdefault("precision", "default")
    common = dict(rank=rank, x=x, mask=mask_loader, tol=tol, maxiter=maxiter,
                  method="mu", stop="heldout", heldout_frac=heldout_frac,
                  check_every=check_every, random_seed=random_seed,
                  chunk_rows=chunk_rows, n_samples=n_samples,
                  n_channels=n_channels, dtype=dtype, **kwargs)
    if mesh is not None:
        from decomp_tpu_torch.parallel import nmf_streaming as _pns

        return _pns.solve_streaming(y_loader, d, mesh=mesh,
                                    row_axis=row_axis, **common)
    return solve_streaming(y_loader, d, x_device=True, jit_loader=True,
                           **common)


def _bf16_loader(loader):
    """``loader`` with its chunks cast to bf16."""
    def wrapped(lo, hi):
        return _as_tensor(loader(lo, hi)).to(torch.bfloat16)

    return wrapped
