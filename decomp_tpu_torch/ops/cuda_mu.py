"""Multiplicative-update NMF statistics: the CUDA kernels and their plain
twins (counterpart of ``decomp_tpu.ops.pallas_mu``).

Four kernels, each the x update of one iteration plus the d update's
sufficient statistics, in one call:

    mu_stats_dense(y, x, d, eps)          -> x_new, numd = x_new^T y,
                                             gram = x_new^T x_new
    mu_stats_masked(my, mask, x, d, eps)  -> x_new, numd = x_new^T my,
                                             dend = x_new^T (mask * (x_new d))
    kl_stats_dense(my, x, d, eps)         -> x_new, numd = x_new^T
                                             (my / (x_new d + eps)),
                                             xsum = column sums of x_new
    kl_stats_masked(my, mask, x, d, eps)  -> x_new, numd as kl_stats_dense,
                                             dend = x_new^T mask

(``my = mask * y``; the statistics are f32, numd and dend (K, N), gram
(K, K), xsum (1, K)), with the TPU kernels' quantisation points
(``pallas_mu.py:160-372``): products take compute-dtype operands
(``cdt = y.dtype``) and sum in f32; the masked reconstruction
``cdt(f32(mask) * recon)`` and the KL ratio ``cdt(f32(my) / (recon +
eps))`` are formed in f32 and cast to ``cdt``; ``x_new`` is formed in f32
and stored in ``x``'s dtype; the statistics use ``x_new`` cast to
``cdt``, and ``xsum`` sums the f32 ``x_new``. As in the TPU kernels,
``x_new`` and the statistics are formed in f32 even for f64 data.

On a CUDA tensor a wrapper launches its kernel and raises on anything it
does not take (bf16 or f32 data, ``d`` and a dense ``mask`` in the data's
dtype, 1 <= K <= 128 on the fused kernels, and above 128 inside the TPU
kernels' gate, ``rank_fits``; ``x`` in the data's dtype, or f32 for the
MU kernels). The routes, by rank (``rank_route``), dtype and the mask's
form:

- above rank 128, all four wrappers (the masked ones on bits or weights
  alike) to ``csrc/mu_wide.cu``, whose f32 products run as bf16x6 limb
  products and bf16 ones in one pass on the wide products of
  ``csrc/wide_common.cuh``, counted in ``.wide_launches``;
- ``mu_stats_dense``: bf16 data to ``csrc/mu_dense_tma.cu``
  (``dense_route``), f32 data to ``csrc/mu_dense_packed.cu``, whose f32
  products run as bf16x6 limb products on ``wgmma`` (the chain of
  ``csrc/wgmma_chain.cuh``); the first design, ``csrc/mu_stats_dense.cu``,
  stays only behind the private ``_dense_mma_launch``, for timing;
- ``mu_stats_masked``: the mask as bits (``pack_mask``) with f32 data to
  ``csrc/mu_masked_f32.cu``, whose f32 products run as bf16x6 limb
  products on ``wgmma`` (the chain of ``csrc/wgmma_chain.cuh``), and with
  bf16 data to ``csrc/mu_masked_packed.cu``; a dense mask (a weighted
  one, which ``pack_mask`` refuses) to ``csrc/mu_kl_stats.cu``;
- ``kl_stats_masked``: the mask as bits with f32 data to
  ``csrc/kl_masked_packed.cu``, whose f32 products run as bf16x6 limb
  products on the tensor cores (``split_bf16x3``; the TPU's
  ``Precision.HIGHEST``); a dense mask (bf16 data, or a weighted mask,
  which ``pack_mask`` refuses) to ``csrc/mu_kl_stats.cu``;
- ``kl_stats_dense``: f32 data to ``csrc/kl_dense_packed.cu``
  (``kl_dense_route``), whose f32 products run as bf16x6 limb
  products on ``wgmma`` with d's limbs from ``column_limbs``; bf16 data to
  ``csrc/mu_kl_stats.cu``.

``nmf.solve`` packs a 0/1 mask once per solve where ``takes_packed`` (MU)
or ``kl_takes_packed`` (KL) says the route takes bits. On a CPU tensor a
wrapper runs its ``*_plain`` twin (unpacking a packed mask first). It
never falls back from one to the other. Each wrapper counts its kernel
launches in ``.launches``; the masked ones also per route, in
``.packed_launches`` and ``.dense_launches`` (``mu_stats_masked`` counts
its f32 route, ``csrc/mu_masked_f32.cu``, in ``.f32_launches``, its bf16
one in ``.packed_launches`` and its wide one in ``.wide_launches``),
``kl_stats_dense`` in ``.packed_launches``, ``.mu_kl_launches`` and
``.wide_launches``, and ``mu_stats_dense`` in ``.tma_launches``,
``.packed_launches`` and ``.wide_launches``.

Not ported: ``calibrated_tpu`` and the v5e VMEM calibrations as gates of
the port's own kernels. ``rank_fits`` keeps ``fits_vmem``'s gate, at
``default_block_rows``' stripe, as the limit of the ranks the wide route
must take (``kernel_takes_rank``).
"""

import ctypes
import functools

import numpy as np
import torch

from decomp_tpu_torch.ops import _build
from decomp_tpu_torch.utils.exceptions import DecompError, DtypeError, ShapeError

# Largest rank the fused kernels take (their rank tile, KP in the CUDA
# sources); above it MU and KL-MU take the wide route (csrc/mu_wide.cu) up
# to the TPU kernels' gate, rank_fits.
KERNEL_MAX_RANK = 128
# The TPU kernels' gate (pallas_mu.py:82 fits_vmem, :113
# default_block_rows): the VMEM a stripe's residents take, per 128-padded
# column, under 15.7 MiB, at the stripe that halves from 128 rows while the
# streamed stripes pass a 10 MiB budget. Its corners: dense / masked MU at
# N <= 128 up to K = 10,624 / 6,272 in f32 and 12,800 / 7,040 in bf16; at
# N = 1,024 up to 1,280 / 640 and 1,536 / 768. Dense / masked KL at N <=
# 128 up to 4,480 / 3,456 in f32 and 4,864 / 3,712 in bf16; at N = 1,024
# up to 512 / 384 in either.
_TPU_GATE_BYTES = int(15.7 * 1024 * 1024)
_TPU_STRIPE_BUDGET = 10 * 1024 * 1024
# csrc/mu_wide.cu's and csrc/grad_wide.cu's statistics grid, (128-column N
# tiles) x (128-row K chunks) x (row chunks): the chunks aim at two waves of
# the H100's 132 SMs (one block each), in whole 32-row stages.
_WIDE_DICT_BLOCKS = 2 * 132
# csrc/mu_wide.cu's masked statistics pass (mask_stats): 64-column N tiles
# and 64-row stages, on the same aim of blocks.
_MSTATS_N_TILE = 64
_MSTATS_STAGE_ROWS = 64
# csrc/mu_wide.cu's column sums of x_new (dense KL's xsum): (128-column
# groups) x (row chunks) blocks of 128 threads, about this many, in whole
# 32-row chunks.
_WIDE_SUM_BLOCKS = 8 * 132
# The row chunks of the statistics pass aim at this many partials.
_TARGET_CHUNKS = 128
_MIN_CHUNK_ROWS = 256
_MAX_GRID_Y = 65535
# Rows per partial column sum of x_new in the dense KL kernels' x update:
# one per 64-row stripe in csrc/mu_kl_stats.cu (BM1 there), one per warp's
# 16 rows in csrc/kl_dense_packed.cu (whose stripes are 128 rows).
_X_STRIPE_ROWS = 64
_KL_DENSE_STRIPE_ROWS = 128
_KL_DENSE_SUM_ROWS = 16
# The packed kernel's statistics pass (csrc/mu_masked_packed.cu): 64-column
# N tiles and 64-row stages, and two waves of its resident blocks, 2 per SM
# (kBlocks there) on the H100's 132 SMs.
_PACKED_N_TILE = 64
_PACKED_STAGE_ROWS = 64
_PACKED_RESIDENT = 2 * 132
# Rows per chunk of pack_mask's int64 temporaries (32 MB per 1,024 words).
_PACK_ROWS = 4096
# The dense TMA kernel's statistics pass (csrc/mu_dense_tma.cu): 128-column
# N tiles plus one gram tile, 64-row stages, one resident block per SM on
# the H100's 132 SMs; its chunks fill at least this share of their waves
# (csrc/mu_dense_packed.cu's the same, in 32-row stages).
_TMA_N_TILE = 128
_TMA_STAGE_ROWS = 64
_TMA_RESIDENT = 132
_TMA_WAVE_FILL = 0.95
_TMA_MAX_CHUNKS = 64
# The packed KL kernels' statistics pass (csrc/kl_masked_packed.cu,
# csrc/kl_dense_packed.cu, and csrc/grad_dict_packed.cu,
# csrc/mu_dense_packed.cu and csrc/mu_masked_f32.cu, which run dense KL's
# chain): 128-column N tiles and 32-row stages, one resident block per SM
# on the H100's 132 SMs.
_KL_N_TILE = 128
_KL_STAGE_ROWS = 32
_KL_RESIDENT = 132
# csrc/mu_masked_f32.cu's statistics grid aims at this many waves of its
# blocks: half of them (numd's tiles) do half the work of the other half,
# so many small blocks balance the SMs (on an H100 at config 4, 8 waves
# took 1.157 ms a call against 1.201 for 4 and 1.294 for 2, in turns; at
# K = 128 they tie).
_MASKED_F32_WAVES = 8


def _tpu_block_rows(n_pad, k_pad, itemsize, masked):
    """``pallas_mu.default_block_rows``: 128 rows, halved (down to 8) while
    the streamed stripes pass the 10 MiB budget."""
    block = 128
    streams = 2 if masked else 1
    while (block > 8
           and block * n_pad * itemsize * 2 * streams > _TPU_STRIPE_BUDGET):
        block //= 2
    return block


def rank_fits(n: int, k: int, itemsize: int, masked: bool,
              kl_masked: bool = False, kl_dense: bool = False) -> bool:
    """Whether the TPU kernels take rank K at N columns of
    ``itemsize``-byte data: ``pallas_mu.fits_vmem`` at the stripe
    ``'auto'`` uses, with N and K rounded up to 128, the port's own copy.
    ``masked``: the masked kernels' shape (two streams, two K x N
    statistics), and for the KL kernels as ``decomp_tpu``'s gate passes it
    (any KL); ``kl_masked`` / ``kl_dense``: the KL kernels' heavier
    residents. The limit of the ranks the wide route must take."""
    n_pad, k_pad = -(-n // 128) * 128, -(-k // 128) * 128
    stripe = _tpu_block_rows(n_pad, k_pad, itemsize,
                             masked or kl_dense or kl_masked)
    stat_bytes = (32 if kl_masked else 24 if kl_dense else
                  16 if masked else 8)
    per_col = (k_pad * (itemsize + stat_bytes)
               + stripe * itemsize * (2 if masked else 1))
    return per_col * n_pad <= _TPU_GATE_BYTES


def rank_route(k: int) -> str:
    """Which kernels MU and KL-MU run at rank K: ``'fused'`` (the routes
    of ``dense_route``, ``kl_dense_route`` and the masked wrappers' mask
    forms) for K <= ``KERNEL_MAX_RANK``, ``'wide'`` (``csrc/mu_wide.cu``)
    above. A function of K alone: no shape moves to another route on a
    failure."""
    return "fused" if k <= KERNEL_MAX_RANK else "wide"


def kernel_takes_rank(method, n, k, dtype, masked) -> bool:
    """Whether the kernels of ``method`` take rank K at N columns of
    ``dtype`` data: K from 1 to ``KERNEL_MAX_RANK`` at any N (the fused
    kernels, MU and KL); above it the wide route inside the gate,
    ``rank_fits``, with the flags ``decomp_tpu``'s solve passes it (KL:
    the masked shape, and the KL kernels' residents, dense or masked). The
    predicate of ``nmf.solve``'s, the sharded solve's and loader mode's
    ``use_kernel``."""
    if k < 1:
        return False
    if rank_route(k) == "fused":
        return True
    if method == "kl-mu":
        return rank_fits(n, k, dtype.itemsize, True, kl_masked=masked,
                         kl_dense=not masked)
    return method == "mu" and rank_fits(n, k, dtype.itemsize, masked)


def check_rank(method, n, k, dtype, masked):
    """Raise ``ShapeError`` where ``kernel_takes_rank`` is False."""
    if not kernel_takes_rank(method, n, k, dtype, masked):
        raise ShapeError(
            f"the {method} kernels take rank 1 to {KERNEL_MAX_RANK} at any "
            f"N, and above it where the TPU kernels' gate takes it "
            f"(rank_fits: N and K rounded up to 128; at N = 1,024 in f32 up "
            f"to 1,280 dense and 640 masked for MU, 512 dense and 384 "
            f"masked for KL-MU; at N <= 128 up to 10,624 / 6,272 for MU, "
            f"4,480 / 3,456 for KL-MU); got rank {k}, N={n}, {dtype}"
            + (", masked" if masked else ""))


def _chunk_rows(m: int, chunks: int, stage: int) -> int:
    """Rows per chunk of M rows cut into ``chunks`` (at least one), in
    whole ``stage``-row stages."""
    rows = -(-m // max(1, chunks))
    return -(-rows // stage) * stage


def wide_dict_rows(m: int, n: int, kp: int) -> int:
    """Rows per partial of the wide routes' statistics pass (``wide_dict``
    of ``csrc/wide_common.cuh``) over an M x N E and kp (a multiple of 128)
    rows of G: as many chunks as make (128-column N tiles) x (kp / 128) x
    chunks about ``_WIDE_DICT_BLOCKS`` blocks, in whole 32-row stages. A
    function of the shape alone, so the summation order, and every bit of
    the statistics, is."""
    tiles = -(-n // 128) * (kp // 128)
    return _chunk_rows(m, -(-_WIDE_DICT_BLOCKS // tiles), 32)


def wide_sum_rows(m: int, kp: int) -> int:
    """Rows per partial of the wide route's column sums of x_new (dense
    KL's xsum) over M rows and kp (a multiple of 128) columns: as many
    chunks as make (kp / 128) x chunks about ``_WIDE_SUM_BLOCKS`` blocks,
    in whole 32-row chunks. A function of the shape alone, so the
    summation order, and every bit of xsum, is."""
    return _chunk_rows(m, -(-_WIDE_SUM_BLOCKS // (kp // 128)), 32)


def validate_block_rows(block_rows):
    """Typed up-front check of the ``kernel_block_rows`` override: a
    positive multiple of 8."""
    if block_rows is None:
        return
    if (not isinstance(block_rows, (int, np.integer))
            or isinstance(block_rows, bool)
            or int(block_rows) < 8
            or int(block_rows) % 8):
        raise DecompError("kernel_block_rows must be a positive multiple "
                          f"of 8, got {block_rows!r}")


def default_block_rows(m: int) -> int:
    """Rows per partial of the statistics pass: about ``_TARGET_CHUNKS``
    chunks (8,192 rows at M = 2^20), never under 256 rows. A fixed
    function of M, so the summation order, and with it every bit of the
    result, depends on the shape only."""
    rows = -(-m // _TARGET_CHUNKS)
    return max(_MIN_CHUNK_ROWS, -(-rows // 32) * 32)


def _work_dtype(dtype):
    """The dtype compute-dtype operands are upcast to for an exact-product,
    f32-sum matmul on any device: f32 for bf16/f32, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def gram_rows(d):
    """``d d^T`` in f32 with compute-dtype (d's) operands, as the JAX
    package forms it outside the kernel (``pallas_mu.py:453``)."""
    dw = d.to(_work_dtype(d.dtype))
    return (dw @ dw.T).to(torch.float32)


def mu_stats_dense_plain(y, x, d, eps, *, block_rows=None, inner_iter=1):
    """The kernel's plain twin: the same function and quantisation points
    as plain torch. Compute-dtype operands are upcast (exactly) to f32 in
    row chunks of ``block_rows``, so no f32 copy of all of ``y`` is made.
    """
    cdt, wdt = y.dtype, _work_dtype(y.dtype)
    eps32 = torch.tensor(float(eps), dtype=torch.float32)
    dw = d.to(wdt)
    ddt_c = gram_rows(d).to(cdt).to(wdt)
    x_new = torch.empty_like(x)
    numd = torch.zeros((d.shape[0], y.shape[1]), dtype=torch.float32,
                       device=y.device)
    gram = torch.zeros((d.shape[0], d.shape[0]), dtype=torch.float32,
                       device=y.device)
    for sl in _row_chunks(y.shape[0], block_rows):
        yc = y[sl].to(wdt)
        num = (yc @ dw.T).to(torch.float32)
        xf = x[sl].to(torch.float32)
        for _ in range(int(inner_iter)):
            den = (xf.to(cdt).to(wdt) @ ddt_c).to(torch.float32)
            xf = xf * num / (den + eps32)
        x_new[sl] = xf.to(x.dtype)
        xc = xf.to(cdt).to(wdt)
        numd += (xc.T @ yc).to(torch.float32)
        gram += (xc.T @ xc).to(torch.float32)
    return x_new, numd, gram


def mu_stats_masked_plain(my, mask, x, d, eps, *, block_rows=None):
    """``mu_stats_masked``'s plain twin (``_masked_kernel``,
    ``pallas_mu.py:222``), in row chunks of ``block_rows`` like
    ``mu_stats_dense_plain``."""
    cdt, wdt, f32 = my.dtype, _work_dtype(my.dtype), torch.float32
    eps32 = torch.tensor(float(eps), dtype=f32)
    dw = d.to(wdt)
    x_new = torch.empty_like(x)
    numd = torch.zeros((d.shape[0], my.shape[1]), dtype=f32, device=my.device)
    dend = torch.zeros_like(numd)
    for sl in _row_chunks(my.shape[0], block_rows):
        myc = my[sl].to(wdt)
        mc = mask[sl].to(f32)
        recon = (x[sl].to(cdt).to(wdt) @ dw).to(f32)
        den = ((mc * recon).to(cdt).to(wdt) @ dw.T).to(f32)
        xf = x[sl].to(f32) * (myc @ dw.T).to(f32) / (den + eps32)
        x_new[sl] = xf.to(x.dtype)
        xc = xf.to(cdt).to(wdt)
        recon2_m = (mc * (xc @ dw).to(f32)).to(cdt).to(wdt)
        numd += (xc.T @ myc).to(f32)
        dend += (xc.T @ recon2_m).to(f32)
    return x_new, numd, dend


def kl_stats_dense_plain(my, x, d, eps, *, block_rows=None):
    """``kl_stats_dense``'s plain twin (``_kl_dense_kernel``,
    ``pallas_mu.py:276``)."""
    return _kl_plain(my, None, x, d, eps, block_rows)


def kl_stats_masked_plain(my, mask, x, d, eps, *, block_rows=None):
    """``kl_stats_masked``'s plain twin (``_kl_masked_kernel``,
    ``pallas_mu.py:325``)."""
    return _kl_plain(my, mask, x, d, eps, block_rows)


def _kl_plain(my, mask, x, d, eps, block_rows):
    """Both KL twins: ``(x_new, numd, xsum)`` without a mask, ``(x_new,
    numd, dend)`` with one."""
    cdt, wdt, f32 = my.dtype, _work_dtype(my.dtype), torch.float32
    eps32 = torch.tensor(float(eps), dtype=f32)
    dw = d.to(wdt)
    dsum = _dsum(d)
    x_new = torch.empty_like(x)
    numd = torch.zeros((d.shape[0], my.shape[1]), dtype=f32, device=my.device)
    den_d = (torch.zeros((1, d.shape[0]), dtype=f32, device=my.device)
             if mask is None else torch.zeros_like(numd))

    def ratio(xc, myf):
        return (myf / ((xc @ dw).to(f32) + eps32)).to(cdt).to(wdt)

    for sl in _row_chunks(my.shape[0], block_rows):
        myf = my[sl].to(f32)
        num = (ratio(x[sl].to(cdt).to(wdt), myf) @ dw.T).to(f32)
        if mask is None:
            den = dsum
        else:
            mc = mask[sl].to(wdt)
            den = (mc @ dw.T).to(f32)
        xf = x[sl].to(f32) * num / (den + eps32)
        x_new[sl] = xf.to(x.dtype)
        xc = xf.to(cdt).to(wdt)
        numd += (xc.T @ ratio(xc, myf)).to(f32)
        if mask is None:
            den_d += xf.sum(0, keepdim=True)
        else:
            den_d += (xc.T @ mc).to(f32)
    return x_new, numd, den_d


def _dsum(d):
    """Row sums of ``d`` in f32, shape (1, K): the dense KL x update's
    denominator, formed outside the kernel as ``pallas_mu.py:618`` forms
    it."""
    return d.to(torch.float32).sum(1)[None, :]


def _row_chunks(m, block_rows):
    rows = block_rows or default_block_rows(m)
    return [slice(s, s + rows) for s in range(0, m, rows)]


def _check_kernel_args(y, x, d, inner_iter, block_rows, *, mask=None,
                       wide_x=True, gate=None, method="mu"):
    """Refuse what the kernels do not take, before any launch. ``mask``:
    the masked kernels' mask, which must match ``y``; ``wide_x``: whether
    the kernel takes f32 ``x`` with bf16 ``y`` (the MU kernels do);
    ``gate``: None for the fused kernels (1 <= K <= ``KERNEL_MAX_RANK``,
    any N), ``'dense'`` or ``'masked'`` for the wide route (``check_rank``
    of ``method``, 'mu' or 'kl-mu': inside the TPU kernels' gate)."""
    named = (("y", y), ("x", x), ("d", d))
    if mask is not None:
        named += (("mask", mask),)
    for name, t in named:
        if t.device != y.device:
            raise DecompError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise DecompError(f"{name} must be contiguous")
        if t.dim() != 2:
            raise ShapeError(f"{name} must be 2-D, got {tuple(t.shape)}")
    m, n = y.shape
    k = d.shape[0]
    if x.shape != (m, k) or d.shape != (k, n):
        raise ShapeError(f"x {tuple(x.shape)} and d {tuple(d.shape)} do not "
                         f"fit y {tuple(y.shape)}")
    if mask is not None and mask.shape != y.shape:
        raise ShapeError(f"mask {tuple(mask.shape)} does not match y "
                         f"{tuple(y.shape)}")
    if gate is not None:
        check_rank(method, n, k, y.dtype, gate == "masked")
    elif not 1 <= k <= KERNEL_MAX_RANK:
        raise ShapeError(f"the kernel takes 1 <= rank <= {KERNEL_MAX_RANK}, "
                         f"got {k}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise DtypeError(f"the kernel takes bf16 or f32 y, got {y.dtype}")
    for name, t in named[2:]:
        if t.dtype != y.dtype:
            raise DtypeError(f"{name} must have y's dtype {y.dtype}, got "
                             f"{t.dtype}")
    x_dtypes = (y.dtype, torch.float32) if wide_x else (y.dtype,)
    if x.dtype not in x_dtypes:
        raise DtypeError(f"x must be one of {x_dtypes}, got {x.dtype}")
    if int(inner_iter) < 1:
        raise DecompError(f"inner_iter must be >= 1, got {inner_iter}")
    if max(m, n) >= 2 ** 31:
        raise ShapeError(f"y's sides must be < 2^31, got {tuple(y.shape)}")
    if -(-m // block_rows) > _MAX_GRID_Y:
        raise DecompError(f"kernel_block_rows={block_rows} gives more than "
                          f"{_MAX_GRID_Y} row chunks for M={m}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong


def _c_function(source, name, argtypes):
    """The C entry point ``name`` of ``csrc/<source>.cu``, built on first
    use, with its ctypes signature (pointers and the stream as
    c_void_p). Every launch asks for it, so that ``_build.recording``
    sees the library at each launch."""
    _build.reached(source)
    return _c_entry(source, name, argtypes)


@functools.cache
def _c_entry(source, name, argtypes):
    fn = getattr(_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def _runs_plain(t):
    """True for a CPU tensor (the twin runs), False for a CUDA tensor (the
    kernel runs); any other device is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise DecompError(f"no kernel for device {t.device}")
    return False


def _launch(name, fn, device, *args):
    """Call the C entry point ``fn`` on ``device``'s current stream (the
    stream is the last argument); raise if it reports a CUDA error."""
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _f32(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _is_bf16(t):
    return int(t.dtype == torch.bfloat16)


def dense_route(dtype, device):
    """Which code ``mu_stats_dense`` runs for data of ``dtype`` on
    ``device``: ``'plain'`` (the twin) on the CPU; on the card ``'tma'``
    (``csrc/mu_dense_tma.cu``) for bf16 data and ``'packed'``
    (``csrc/mu_dense_packed.cu``, bf16x6 on ``wgmma``) for any other
    dtype, whose checks refuse all but f32. Other devices raise. A route
    by dtype, never a fallback."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise DecompError(f"no kernel for device {device}")
    return "tma" if dtype == torch.bfloat16 else "packed"


@functools.cache
def _wave_rows(m, n, stage_rows):
    """Rows per partial of a dense statistics pass over 128-column N tiles
    plus the gram tile: the fewest row chunks for which chunks x tiles
    fill at least 95% of their waves of resident blocks (one per SM on
    132 SMs), else the best fill up to 64 chunks; in whole stages of
    ``stage_rows``. A function of (M, N) alone, so the summation order,
    and every bit of the result, is (and is kept: config 1's calls are
    paced by the host)."""
    tiles = -(-n // _TMA_N_TILE) + 1
    stages = -(-m // stage_rows)
    best, best_fill = 1, 0.0
    for chunks in range(1, min(_TMA_MAX_CHUNKS, stages) + 1):
        blocks = tiles * chunks
        fill = blocks / (-(-blocks // _TMA_RESIDENT) * _TMA_RESIDENT)
        if fill > best_fill:
            best, best_fill = chunks, fill
        if fill >= _TMA_WAVE_FILL:
            break
    rows = -(-m // best)
    return -(-rows // stage_rows) * stage_rows


def dense_tma_block_rows(m: int, n: int) -> int:
    """Rows per partial of ``csrc/mu_dense_tma.cu``'s statistics pass
    (``_wave_rows``, 64-row stages). At 1,048,576 x 10,112: 8 chunks of
    131,072 rows (80 tiles, 640 blocks, 97% of 5 waves)."""
    return _wave_rows(m, n, _TMA_STAGE_ROWS)


def dense_packed_block_rows(m: int, n: int, block_rows=None) -> int:
    """Rows per partial of ``csrc/mu_dense_packed.cu``'s statistics pass:
    ``_wave_rows`` in 32-row stages (8 chunks of 32,768 rows at 262,144 x
    10,112: 640 blocks, 97% of 5 waves), or ``block_rows`` rounded up to
    whole 32-row stages. A function of the shape (and ``block_rows``)
    alone."""
    if block_rows is None:
        return _wave_rows(m, n, _KL_STAGE_ROWS)
    return -(-block_rows // _KL_STAGE_ROWS) * _KL_STAGE_ROWS


def mu_stats_dense(y, x, d, eps, *, block_rows=None, inner_iter=1):
    """The dense-MU statistics ``(x_new, numd, gram)``; see the module
    docstring. ``block_rows``: rows per partial of the kernel's statistics
    pass (on CPU: rows per upcast chunk of the twin).

    On the card the route follows the rank (``rank_route``) and the data's
    dtype (``dense_route``): above rank 128 ``csrc/mu_wide.cu``
    (``_dense_wide_launch``; f32 data as bf16x6, bf16 in one limb; its
    chunks whole 32-row stages), counted in ``.wide_launches``; else bf16
    ``y`` launches ``csrc/mu_dense_tma.cu`` (TMA ring, wgmma; its chunks
    are whole 64-row stages, so ``block_rows`` is rounded up to a multiple
    of 64) and counts it in ``.tma_launches``, and f32 ``y`` launches
    ``csrc/mu_dense_packed.cu`` (bf16x6 on wgmma; whole 32-row stages) and
    counts it in ``.packed_launches``. ``.launches`` counts all three."""
    validate_block_rows(block_rows)
    route = dense_route(y.dtype, y.device)
    if route == "plain":
        return mu_stats_dense_plain(y, x, d, eps, block_rows=block_rows,
                                    inner_iter=inner_iter)
    if rank_route(d.shape[0]) == "wide":
        out = _dense_wide_launch(y, x, d, eps, block_rows, inner_iter)
        mu_stats_dense.wide_launches += 1
    elif route == "tma":
        out = _dense_tma_launch(y, x, d, eps, block_rows, inner_iter)
        mu_stats_dense.tma_launches += 1
    else:
        out = _dense_packed_launch(y, x, d, eps, block_rows, inner_iter)
        mu_stats_dense.packed_launches += 1
    mu_stats_dense.launches += 1
    return out


def _dense_tma_launch(y, x, d, eps, block_rows, inner_iter):
    """Launch ``csrc/mu_dense_tma.cu`` on bf16 ``y`` and ``d``
    (``mu_stats_dense``'s bf16 route)."""
    m, n = y.shape
    k = d.shape[0]
    rows = (dense_tma_block_rows(m, n) if block_rows is None
            else -(-block_rows // _TMA_STAGE_ROWS) * _TMA_STAGE_ROWS)
    _check_kernel_args(y, x, d, inner_iter, rows)
    if y.dtype != torch.bfloat16:
        raise DtypeError(f"the TMA kernel takes bf16 data, got {y.dtype}")
    fn = _c_function("mu_dense_tma", "mu_dense_tma_launch",
                     (_I, _P, _I, _P, _P, _I, _P, _F) + (_I,) * 5
                     + (_P,) * 5)
    with torch.cuda.device(y.device):
        y_t, ld_y = _tma_rows(y)
        d_t, ld_d = _tma_rows(d)
        ddt = gram_rows(d)
        size = k * n + k * k
        x_new = torch.empty_like(x)
        xc = torch.empty((m, KERNEL_MAX_RANK), dtype=torch.bfloat16,
                         device=y.device)
        part = _f32(-(-m // rows) * size, y.device)
        out = _f32(size, y.device)
        _launch("mu_stats_dense (TMA)", fn, y.device, _is_bf16(x),
                y_t.data_ptr(), ld_y, x.data_ptr(), d_t.data_ptr(), ld_d,
                ddt.data_ptr(), float(eps), m, n, k, int(inner_iter), rows,
                x_new.data_ptr(), xc.data_ptr(), part.data_ptr(),
                out.data_ptr())
    return x_new, out[:k * n].view(k, n), out[k * n:].view(k, k)


def _dense_packed_workspace(kt, m, n, k, rows):
    """Bytes of ``csrc/mu_dense_packed.cu``'s workspace (``workspace_bytes``
    there, which checks it): d's limbs (N x 3 kt bf16), xc (M x 3 kt bf16)
    and the chunks' partials (K N + K K f32 each), each in whole KB."""
    def section(nbytes):
        return -(-nbytes // 1024) * 1024

    return (section(2 * n * 3 * kt) + section(2 * m * 3 * kt)
            + section(4 * -(-m // rows) * (k * n + k * k)))


def _dense_packed_launch(y, x, d, eps, block_rows, inner_iter):
    """Launch ``csrc/mu_dense_packed.cu`` on f32 ``y``, ``x`` and ``d``
    (``mu_stats_dense``'s f32 route). The kernel splits d into its limbs
    (``column_limbs``' layout) in its first launch; ``ddt`` is formed
    here, outside the kernel. At config 1 a call is paced by the host, so
    its scratch is one allocation, ``_dense_packed_workspace``."""
    m, n = y.shape
    k = d.shape[0]
    rows = dense_packed_block_rows(m, n, block_rows)
    _check_kernel_args(y, x, d, inner_iter, rows, wide_x=False)
    if y.dtype != torch.float32:
        raise DtypeError(f"the packed dense MU kernel takes f32 data, got "
                         f"{y.dtype}")
    kt = 64 if k <= 64 else 128
    fn = _c_function("mu_dense_packed", "mu_dense_packed_launch",
                     (_I, _P, _I, _P, _P, _P, _F) + (_I,) * 5
                     + (_P, _LL) + (_P,) * 3)
    ws_bytes = _dense_packed_workspace(kt, m, n, k, rows)
    with torch.cuda.device(y.device):
        y_t, ld_y = _tma_rows(y)
        ddt = gram_rows(d)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=y.device)
        x_new = torch.empty_like(x)
        out = _f32(k * n + k * k, y.device)
        _launch("mu_stats_dense (packed)", fn, y.device, kt, y_t.data_ptr(),
                ld_y, x.data_ptr(), d.data_ptr(), ddt.data_ptr(), float(eps),
                m, n, k, int(inner_iter), rows, ws.data_ptr(), ws_bytes,
                x_new.data_ptr(), out.data_ptr())
    numd, gram = out.split((k * n, k * k))
    return x_new, numd.view(k, n), gram.view(k, k)


def _dense_packed_limbs(d, kt):
    """d's limbs as ``csrc/mu_dense_packed.cu``'s first launch writes them
    ((N, 3 kt) bf16; ``column_limbs(d, kt)``'s layout), for the card's
    bit-for-bit check against ``column_limbs``."""
    k, n = d.shape
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise DtypeError("d must be contiguous f32")
    if not 1 <= k <= kt or kt not in (64, 128):
        raise ShapeError(f"rank {k} does not fit the rank tile {kt}")
    fn = _c_function("mu_dense_packed", "mu_dense_packed_split",
                     (_I, _P, _I, _I, _P, _P))
    with torch.cuda.device(d.device):
        limbs = torch.empty((n, 3 * kt), dtype=torch.bfloat16,
                            device=d.device)
        _launch("mu_dense_packed split", fn, d.device, kt, d.data_ptr(), k,
                n, limbs.data_ptr())
    return limbs


def _dense_mma_launch(y, x, d, eps, block_rows=None, inner_iter=1):
    """Launch ``csrc/mu_stats_dense.cu``, the first design, which no route
    takes any more: it stays so that ``chip_smoke.py`` can time it in
    turns with the kernels that replaced it, on f32 and bf16 data.
    Counts nothing."""
    rows = block_rows or default_block_rows(y.shape[0])
    _check_kernel_args(y, x, d, inner_iter, rows)
    m, n = y.shape
    k = d.shape[0]
    fn = _c_function("mu_stats_dense", "mu_stats_dense_launch",
                     (_I,) * 2 + (_P,) * 4 + (_F,) + (_I,) * 5 + (_P,) * 4)
    with torch.cuda.device(y.device):
        ddt = gram_rows(d)
        size = k * n + k * k
        x_new = torch.empty_like(x)
        part = _f32(-(-m // rows) * size, y.device)
        out = _f32(size, y.device)
        _launch("mu_stats_dense", fn, y.device, _is_bf16(y), _is_bf16(x),
                y.data_ptr(), x.data_ptr(), d.data_ptr(), ddt.data_ptr(),
                float(eps), m, n, k, int(inner_iter), rows,
                x_new.data_ptr(), part.data_ptr(), out.data_ptr())
    return x_new, out[:k * n].view(k, n), out[k * n:].view(k, k)


mu_stats_dense.launches = 0
mu_stats_dense.tma_launches = 0
mu_stats_dense.packed_launches = 0
mu_stats_dense.wide_launches = 0


def limb_count(dtype) -> int:
    """The bf16 limbs of an operand of the wgmma kernels that take f32 and
    bf16 data alike (the packed gradients, the wide routes): 3 for f32
    data (bf16x6 products), 1 for bf16 data (the data itself)."""
    return 1 if dtype == torch.bfloat16 else 3


def _wide_fns():
    """``csrc/mu_wide.cu``'s C entries, by name, with their signatures."""
    sigs = {
        "prep": (_I, _P, _I, _I, _I, _I, _P, _P, _P),
        "rows": (_I, _P, _I, _P, _I, _I, _I, _I, _P, _I),
        "xrows": (_I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _F, _P, _I, _P),
        "resid": (_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I),
        "xresid": (_I, _P, _P, _I, _I, _I, _P, _P, _F, _P, _I, _P),
        "dict": (_I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P),
        "kl_resid": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I),
        "kl_xrows": (_I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _F, _P, _I,
                     _P),
        "expand": (_I, _P, _I, _I, _I, _P, _I),
        "colsum": (_P, _I, _I, _I, _I, _P, _P),
        "mxupd": (_I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I, _F, _P,
                  _P),
        "mstats": (_I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P),
        "reduce": (_P, _LL, _I, _P),
    }
    return {name: _c_function("mu_wide", f"mu_wide_{name}_launch", args + (_P,))
            for name, args in sigs.items()}


def _wide_chunk_rows(m, n, kp, block_rows):
    """Rows per partial of a wide statistics product over M x N:
    ``wide_dict_rows``, or ``block_rows`` rounded up to whole 32-row
    stages."""
    if block_rows is None:
        return wide_dict_rows(m, n, kp)
    return -(-block_rows // _KL_STAGE_ROWS) * _KL_STAGE_ROWS


def _wide_prep(fns, x, kp, limbs, second, with_xf=True):
    """x in f32 (M, kp; unless not ``with_xf``: None) and cdt(x)'s limbs
    (M, limbs kp), each zero past K, by ``csrc/mu_wide.cu``'s prep launch;
    ``second``: also a second limb buffer with zero pads (the dense x
    update's). Returns (xf, [xl, ...])."""
    m, k = x.shape
    xf = _f32((m, kp), x.device) if with_xf else None
    xls = [torch.empty((m, limbs * kp), dtype=torch.bfloat16,
                       device=x.device) for _ in range(1 + second)]
    _launch("mu_stats (wide prep)", fns["prep"], x.device, limbs,
            x.data_ptr(), _is_bf16(x), m, k, kp,
            xf.data_ptr() if with_xf else 0, xls[0].data_ptr(),
            xls[1].data_ptr() if second else 0)
    return xf, xls


def _wide_stat(fns, limbs, e, ld_e, xl, m, n, k, kp, rows, part, out):
    """out (K, N) f32 = x^T E by the wide statistics product and its
    fixed-order reduction (``part``: the chunks' partials)."""
    _launch("mu_stats (wide statistics)", fns["dict"], e.device, limbs,
            e.data_ptr(), ld_e, xl.data_ptr(), m, n, k, kp, rows,
            part.data_ptr(), out.data_ptr())


def _dense_wide_launch(y, x, d, eps, block_rows, inner_iter):
    """Launch ``csrc/mu_wide.cu``'s dense MU (``mu_stats_dense``'s route
    above rank 128) on f32 or bf16 ``y`` and ``d``, x in the data's dtype or
    f32: the prep, num = y d^T, ``inner_iter`` x updates against G's limbs
    (G = cdt(``gram_rows(d)``), formed here as ``pallas_mu.py:453`` forms
    it), then numd and gram, each with its reduction. Refuses what the
    route does not take before any build or launch."""
    m, n = y.shape
    k = d.shape[0]
    kp = -(-k // 128) * 128
    rows_n = _wide_chunk_rows(m, n, kp, block_rows)
    rows_g = _wide_chunk_rows(m, k, kp, block_rows)
    _check_kernel_args(y, x, d, inner_iter, min(rows_n, rows_g),
                       gate="dense")
    limbs = limb_count(y.dtype)
    fns = _wide_fns()
    with torch.cuda.device(y.device):
        y_t, ld_y = _tma_rows(y)
        d_l = column_limbs(d, kp, limbs)
        g_l = column_limbs(gram_rows(d).to(y.dtype), kp, limbs)
        xf, xls = _wide_prep(fns, x, kp, limbs, True)
        num = _f32((m, kp), y.device)
        _launch("mu_stats_dense (wide num)", fns["rows"], y.device, limbs,
                y_t.data_ptr(), ld_y, d_l.data_ptr(), m, n, k, kp,
                num.data_ptr(), kp)
        x_new = torch.empty_like(x)
        cur = 0
        for it in range(int(inner_iter)):
            last = it == int(inner_iter) - 1
            _launch("mu_stats_dense (wide x update)", fns["xresid"],
                    y.device, limbs, xls[cur].data_ptr(), g_l.data_ptr(), m,
                    k, kp, xf.data_ptr(), num.data_ptr(), float(eps),
                    x_new.data_ptr() if last else 0, _is_bf16(x),
                    xls[1 - cur].data_ptr())
            cur = 1 - cur
        del num, g_l
        xl = xls[cur]
        part = _f32(max(-(-m // rows_n) * k * n, -(-m // rows_g) * k * k),
                    y.device)
        out = _f32(k * n + k * k, y.device)
        numd, gram = out.split((k * n, k * k))
        _wide_stat(fns, limbs, y_t, ld_y, xl, m, n, k, kp, rows_n, part,
                   numd)
        # gram's E is cdt(x_new): f32 x_new itself at three limbs, its one
        # bf16 limb at one.
        e_g = xf if limbs == 3 else xl
        _wide_stat(fns, limbs, e_g, kp, xl, m, k, k, kp, rows_g, part, gram)
    return x_new, numd.view(k, n), gram.view(k, k)


def mu_stats_masked(my, mask, x, d, eps, *, block_rows=None):
    """The masked-MU statistics ``(x_new, numd, dend)``; see the module
    docstring. ``my`` is the pre-masked data ``mask * y``.

    ``mask`` is either dense, in ``my``'s shape, or the bits of a 0/1
    mask from ``pack_mask`` (int32). On a CUDA tensor a packed mask
    launches ``csrc/mu_masked_f32.cu`` for f32 ``my`` (bf16x6 on
    ``wgmma``; ``block_rows`` is rounded up to whole 32-row stages),
    counted in ``.f32_launches``, and ``csrc/mu_masked_packed.cu`` for
    bf16 ``my``, counted in ``.packed_launches`` (``masked_packed_route``
    names the counter); a dense mask launches the masked kernel of
    ``csrc/mu_kl_stats.cu`` and counts it in ``.dense_launches``;
    ``.launches`` counts all three. On a CPU tensor a packed mask is
    unpacked to ``my``'s dtype for the twin, which then gives the dense
    mask's bits."""
    return _route_masked(mu_stats_masked, mu_stats_masked_plain,
                         _packed_launch, _masked_wide_launch, my, mask, x, d,
                         eps, block_rows, masked_packed_route)


def masked_packed_route(dtype):
    """The counter of ``mu_stats_masked``'s packed route for data of
    ``dtype`` on the card: ``'f32_launches'`` (``csrc/mu_masked_f32.cu``)
    for f32 and ``'packed_launches'`` (``csrc/mu_masked_packed.cu``, whose
    checks refuse all but bf16) for any other dtype."""
    return "f32_launches" if dtype == torch.float32 else "packed_launches"


def _route_masked(wrapper, plain, packed_launch, wide_launch, my, mask, x,
                  d, eps, block_rows,
                  packed_route=lambda dtype: "packed_launches"):
    """The routes of a masked wrapper (``mu_stats_masked`` or
    ``kl_stats_masked``) by the rank and the mask's form: on the CPU its
    twin ``plain`` (a packed mask unpacked to ``my``'s dtype first); on the
    card above rank 128 ``wide_launch`` on either form, counted in
    ``.wide_launches``;
    ``packed_launch`` for the bits of a 0/1 mask, counted in the counter
    ``packed_route(my.dtype)`` names, and the dense-mask kernel of
    ``csrc/mu_kl_stats.cu`` for a dense mask, counted in
    ``.dense_launches``; ``.launches`` counts them all."""
    validate_block_rows(block_rows)
    packed = mask.dtype == torch.int32
    if packed:
        _check_packed(my, mask)
    if _runs_plain(my):
        if packed:
            mask = unpack_mask(mask, my.shape[1], my.dtype)
        return plain(my, mask, x, d, eps, block_rows=block_rows)
    if rank_route(d.shape[0]) == "wide":
        out = wide_launch(my, mask, x, d, eps, block_rows)
        wrapper.wide_launches += 1
        wrapper.launches += 1
        return out
    if packed:
        out = packed_launch(my, mask, x, d, eps, block_rows)
        route = packed_route(my.dtype)
        setattr(wrapper, route, getattr(wrapper, route) + 1)
        wrapper.launches += 1
        return out
    out = _masked_launch(wrapper, my, mask, x, d, eps, block_rows)
    wrapper.dense_launches += 1
    return out


mu_stats_masked.launches = 0
mu_stats_masked.packed_launches = 0
mu_stats_masked.f32_launches = 0
mu_stats_masked.dense_launches = 0
mu_stats_masked.wide_launches = 0


def wide_mstats_rows(m: int, n: int, kp: int) -> int:
    """Rows per partial of the masked wide route's statistics pass
    (``mask_stats`` of ``csrc/mu_wide.cu``: (64-column N tiles) x (kp /
    128 K chunks) x (row chunks) blocks) over an M x N my and kp (a
    multiple of 128): the chunks that bring the grid nearest
    ``_WIDE_DICT_BLOCKS`` blocks, in whole 64-row stages. A function of the
    shape alone, so the summation order, and every bit of numd and dend,
    is."""
    tiles = -(-n // _MSTATS_N_TILE) * (kp // 128)
    return _chunk_rows(m, (_WIDE_DICT_BLOCKS + tiles // 2) // tiles,
                       _MSTATS_STAGE_ROWS)


def _masked_wide_launch(my, mask, x, d, eps, block_rows):
    """Launch ``csrc/mu_wide.cu``'s masked MU (``mu_stats_masked``'s route
    above rank 128) on f32 or bf16 ``my`` with the packed mask (int32 bits)
    or the weights (a dense mask in my's dtype), x in the data's dtype or
    f32, in six launches: the prep (cdt(x)'s limbs), E1 = cdt(mask (x d)),
    the x update (num = my d^T and den = E1 d^T in one pass, x_new in its
    epilogue), E2 = cdt(mask (x_new d)), the statistics (numd and dend in
    one pass, each row chunk's partials) and their reduction. One E buffer
    serves E1 and E2, one limb buffer x's and x_new's limbs; the chunks are
    ``wide_mstats_rows`` (or ``block_rows`` in whole 64-row stages).
    Refuses what the route does not take before any build or launch."""
    m, n = my.shape
    k = d.shape[0]
    kp = -(-k // 128) * 128
    rows = (wide_mstats_rows(m, n, kp) if block_rows is None else
            -(-block_rows // _MSTATS_STAGE_ROWS) * _MSTATS_STAGE_ROWS)
    packed = mask.dtype == torch.int32
    if packed:
        _check_packed(my, mask)
        _check_kernel_args(my, x, d, 1, rows, gate="masked")
    else:
        _check_kernel_args(my, x, d, 1, rows, mask=mask, gate="masked")
    limbs = limb_count(my.dtype)
    fns = _wide_fns()
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        if packed:
            mask_t = mask.contiguous()
            if mask_t.data_ptr() % 16:
                mask_t = mask_t.clone()
            ld_mask = mask_t.shape[1]
        else:
            mask_t, ld_mask = _tma_rows(mask)
        d_l = column_limbs(d, kp, limbs)
        _, (xl,) = _wide_prep(fns, x, kp, limbs, False, with_xf=False)
        e = torch.empty((m, ld_my), dtype=my.dtype, device=my.device)

        def resid():
            _launch("mu_stats_masked (wide reconstruction)", fns["resid"],
                    my.device, limbs, int(not packed), xl.data_ptr(),
                    d_l.data_ptr(), mask_t.data_ptr(), ld_mask, m, n, k, kp,
                    e.data_ptr(), ld_my)

        resid()
        x_new = torch.empty_like(x)
        _launch("mu_stats_masked (wide x update)", fns["mxupd"], my.device,
                limbs, my_t.data_ptr(), ld_my, e.data_ptr(), ld_my,
                d_l.data_ptr(), m, n, k, kp, x.data_ptr(), _is_bf16(x),
                float(eps), x_new.data_ptr(), xl.data_ptr())
        resid()
        chunks = -(-m // rows)
        part = _f32(chunks * 2 * k * n, my.device)
        _launch("mu_stats_masked (wide statistics)", fns["mstats"],
                my.device, limbs, my_t.data_ptr(), ld_my, e.data_ptr(),
                ld_my, xl.data_ptr(), m, n, k, kp, rows, part.data_ptr())
        out = _f32(2 * k * n, my.device)
        _launch("mu_stats_masked (wide reduction)", fns["reduce"], my.device,
                part.data_ptr(), 2 * k * n, chunks, out.data_ptr())
        numd, dend = out.split((k * n, k * n))
    return x_new, numd.view(k, n), dend.view(k, n)


def packed_words(n: int) -> int:
    """Words per row of a packed mask of ``n`` columns: ceil(n / 32)
    rounded up to a multiple of 4, so that rows start 16-byte aligned."""
    return -(-n // 128) * 4


def pack_mask(mask):
    """The bits of a 0/1 mask, for the packed routes of
    ``mu_stats_masked``, ``kl_stats_masked`` and
    ``cuda_lasso.masked_grad_rows``: an int32 tensor (M,
    ``packed_words(N)``) on the mask's device, bit j of word w of row r
    set where ``mask[r, 32 w + j] != 0``, pad bits 0.
    Returns None for a mask holding any value other than 0 and 1 (checked
    with one host read); such a mask stays dense. Run once per solve."""
    if mask.dim() != 2:
        raise ShapeError(f"mask must be 2-D, got {tuple(mask.shape)}")
    if not bool(((mask == 0) | (mask == 1)).all()):
        return None
    return pack_bits(mask)


def pack_mask_agreed(mask, reduce=None):
    """``pack_mask`` for a rank of a sharded solve: ``reduce`` sums the
    ranks' verdicts (``parallel.mesh.reducer``), and the mask packs only
    where every rank's block is 0/1, so that every rank takes the same
    route. ``reduce=None``: ``pack_mask`` itself."""
    if reduce is None:
        return pack_mask(mask)
    if mask.dim() != 2:
        raise ShapeError(f"mask must be 2-D, got {tuple(mask.shape)}")
    other = ~((mask == 0) | (mask == 1)).all()
    if bool(reduce(other.to(torch.int32).reshape(1)) > 0):
        return None
    return pack_bits(mask)


def pack_bits(mask):
    """``pack_mask``'s bits without its 0/1 check and its host read, for a
    2-D mask already known to hold only 0 and 1 (the streaming solves pack
    a chunk's mask again each epoch)."""
    m, n = mask.shape
    w = packed_words(n)
    shifts = torch.arange(32, device=mask.device, dtype=torch.int64)
    out = torch.empty((m, w), dtype=torch.int32, device=mask.device)
    for sl in _row_chunks(m, _PACK_ROWS):
        part = mask[sl]
        bits = torch.zeros((part.shape[0], w * 32), dtype=torch.int64,
                           device=mask.device)
        bits[:, :n] = part != 0
        words = (bits.view(-1, w, 32) << shifts).sum(-1)
        out[sl] = (words - (words >= 2 ** 31) * 2 ** 32).to(torch.int32)
    return out


def unpack_mask(packed, n, dtype):
    """The (M, n) 0/1 mask of ``pack_mask``'s bits, in ``dtype``."""
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n].to(dtype)


def takes_packed(my):
    """Whether ``mu_stats_masked`` runs ``my`` with a packed mask: f32
    data on the card (``csrc/mu_masked_f32.cu``), bf16 data on the card
    (``csrc/mu_masked_packed.cu``), any data on the CPU (the twin)."""
    return (my.dtype in (torch.bfloat16, torch.float32)
            or my.device.type == "cpu")


def packed_block_rows(m: int, n: int, k: int) -> int:
    """Rows per partial of the packed kernel's statistics pass: enough
    chunks that chunks x 64-column N tiles make two waves of the blocks
    the H100's 132 SMs hold at once (33 chunks of 3,072 rows at 100,000 x
    1,000; 4 of 65,536 at 262,144 x 10,112), in whole 64-row stages. A
    function of the shape alone, so every bit of the result is; ``k``
    does not change it."""
    tiles = -(-n // _PACKED_N_TILE)
    chunks = max(1, -(-2 * _PACKED_RESIDENT // tiles))
    rows = -(-m // chunks)
    return -(-rows // _PACKED_STAGE_ROWS) * _PACKED_STAGE_ROWS


def _check_packed(my, packed):
    """A packed mask must be 2-D int32 (M, packed_words(N)) for ``my`` (M,
    N), on ``my``'s device."""
    if my.dim() != 2 or packed.dim() != 2:
        raise ShapeError("my and the packed mask must be 2-D")
    want = (my.shape[0], packed_words(my.shape[1]))
    if tuple(packed.shape) != want:
        raise ShapeError(f"packed mask {tuple(packed.shape)} does not fit my "
                         f"{tuple(my.shape)}: expected {want}")
    if packed.device != my.device:
        raise DecompError(f"the packed mask is on {packed.device}, my on "
                          f"{my.device}")


def _tma_rows(t):
    """``t`` (2-D, contiguous) and its row stride in elements, with rows
    that start 16-byte aligned as TMA needs; otherwise a zero-padded
    copy."""
    per = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and t.shape[1] % per == 0:
        return t, t.shape[1]
    ld = -(-t.shape[1] // per) * per
    padded = torch.zeros((t.shape[0], ld), dtype=t.dtype, device=t.device)
    padded[:, :t.shape[1]] = t
    return padded, ld


def _packed_launch(my, packed, x, d, eps, block_rows):
    """``mu_stats_masked``'s packed routes, by the data's dtype: f32
    ``my`` to ``csrc/mu_masked_f32.cu`` (``_masked_f32_launch``), any other
    to ``csrc/mu_masked_packed.cu`` (``_masked_bf16_launch``, which
    refuses all but bf16)."""
    if my.dtype == torch.float32:
        return _masked_f32_launch(my, packed, x, d, eps, block_rows)
    return _masked_bf16_launch(my, packed, x, d, eps, block_rows)


def _masked_bf16_launch(my, packed, x, d, eps, block_rows):
    """Launch ``csrc/mu_masked_packed.cu`` on bf16 ``my`` and the packed
    mask (``mu_stats_masked``'s bf16 packed route)."""
    m, n = my.shape
    k = d.shape[0]
    rows = block_rows or packed_block_rows(m, n, k)
    _check_kernel_args(my, x, d, 1, rows)
    if my.dtype != torch.bfloat16:
        raise DtypeError(f"the packed-mask kernel takes bf16 data, got "
                         f"{my.dtype}")
    if packed.data_ptr() % 16:
        packed = packed.clone()
    kt = 64 if k <= 64 else 128
    fn = _c_function("mu_masked_packed", "mu_masked_packed_launch",
                     (_I,) * 2 + (_P, _I) * 2 + (_P,) * 2 + (_I, _F)
                     + (_I,) * 4 + (_P,) * 5)
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        d_t, ld_d = _tma_rows(d)
        x_new = torch.empty_like(x)
        xc = torch.empty((m, kt), dtype=torch.bfloat16, device=my.device)
        part = _f32(-(-m // rows) * 2 * k * n, my.device)
        out = _f32(2 * k * n, my.device)
        _launch("mu_stats_masked (packed)", fn, my.device, _is_bf16(x), kt,
                my_t.data_ptr(), ld_my, packed.data_ptr(), packed.shape[1],
                x.data_ptr(), d_t.data_ptr(), ld_d, float(eps), m, n, k, rows,
                x_new.data_ptr(), xc.data_ptr(), part.data_ptr(),
                out.data_ptr())
    return x_new, out[:k * n].view(k, n), out[k * n:].view(k, n)


def masked_f32_block_rows(m: int, n: int, block_rows=None) -> int:
    """Rows per partial of ``csrc/mu_masked_f32.cu``'s statistics pass:
    enough chunks that chunks x (numd's and dend's 128-column N tiles)
    make ``_MASKED_F32_WAVES`` waves of one block per SM on the H100's 132
    SMs (66 chunks of 1,536 rows at 100,000 x 1,000 and at 100,000 x
    1,024; 7 of 37,472 at 262,144 x 10,112), in whole 32-row stages; or
    ``block_rows`` rounded up to whole stages. A function of the shape
    (and ``block_rows``) alone, so the summation order, and every bit of
    the result, is."""
    if block_rows is not None:
        return -(-block_rows // _KL_STAGE_ROWS) * _KL_STAGE_ROWS
    tiles = 2 * -(-n // _KL_N_TILE)
    chunks = max(1, -(-_MASKED_F32_WAVES * _KL_RESIDENT // tiles))
    rows = -(-m // chunks)
    return -(-rows // _KL_STAGE_ROWS) * _KL_STAGE_ROWS


def _masked_f32_workspace(kt, m, n, k, rows):
    """Bytes of ``csrc/mu_masked_f32.cu``'s workspace (``workspace_bytes``
    there, which checks it): d's limbs (N x 3 kt bf16), xc (M x 3 kt bf16)
    and the chunks' partials (2 K N f32 each), each in whole KB."""
    def section(nbytes):
        return -(-nbytes // 1024) * 1024

    return (section(2 * n * 3 * kt) + section(2 * m * 3 * kt)
            + section(4 * -(-m // rows) * 2 * k * n))


def _masked_f32_launch(my, packed, x, d, eps, block_rows):
    """Launch ``csrc/mu_masked_f32.cu`` on f32 ``my``, ``x`` and ``d``
    and the packed mask (``mu_stats_masked``'s f32 packed route). The
    kernel splits d into its limbs (``column_limbs``' layout) in its first
    launch and parks num in ``x_new`` until its x update overwrites it;
    its scratch is one allocation, ``_masked_f32_workspace``. Refuses what
    the kernel does not take before any build or launch."""
    m, n = my.shape
    k = d.shape[0]
    rows = masked_f32_block_rows(m, n, block_rows)
    _check_kernel_args(my, x, d, 1, rows, wide_x=False)
    if my.dtype != torch.float32:
        raise DtypeError(f"the f32 masked MU kernel takes f32 data, got "
                         f"{my.dtype}")
    if packed.dtype != torch.int32:
        raise DtypeError(f"the packed mask must be int32, got "
                         f"{packed.dtype}")
    _check_packed(my, packed)
    packed = packed.contiguous()
    if packed.data_ptr() % 16:
        packed = packed.clone()
    kt = 64 if k <= 64 else 128
    fn = _c_function("mu_masked_f32", "mu_masked_f32_launch",
                     (_I, _P, _I, _P, _I, _P, _P, _F) + (_I,) * 4
                     + (_P, _LL) + (_P,) * 3)
    ws_bytes = _masked_f32_workspace(kt, m, n, k, rows)
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=my.device)
        x_new = torch.empty_like(x)
        out = _f32(2 * k * n, my.device)
        _launch("mu_stats_masked (f32)", fn, my.device, kt, my_t.data_ptr(),
                ld_my, packed.data_ptr(), packed.shape[1], x.data_ptr(),
                d.data_ptr(), float(eps), m, n, k, rows, ws.data_ptr(),
                ws_bytes, x_new.data_ptr(), out.data_ptr())
    numd, dend = out.split((k * n, k * n))
    return x_new, numd.view(k, n), dend.view(k, n)


def kl_stats_dense(my, x, d, eps, *, block_rows=None):
    """The dense KL-MU statistics ``(x_new, numd, xsum)``; see the module
    docstring. ``dsum``, the row sums of ``d`` in f32, is formed here,
    outside the kernel (``pallas_mu.py:618``).

    On a CUDA tensor the route follows the rank (``rank_route``) and the
    data's dtype (``kl_dense_route``): above rank 128 ``csrc/mu_wide.cu``
    (``_kl_dense_wide_launch``; f32 data as bf16x6, bf16 in one limb; its
    chunks whole 32-row stages), counted in ``.wide_launches``; else f32
    data launch ``csrc/kl_dense_packed.cu`` (bf16x6 products on ``wgmma``;
    ``block_rows`` is rounded up to whole 32-row stages) and count it in
    ``.packed_launches``, and bf16 data launch the KL_DENSE kernel of
    ``csrc/mu_kl_stats.cu`` and count it in ``.mu_kl_launches``;
    ``.launches`` counts all three."""
    validate_block_rows(block_rows)
    route = kl_dense_route(my.dtype, my.device)
    if route == "plain":
        return kl_stats_dense_plain(my, x, d, eps, block_rows=block_rows)
    if rank_route(d.shape[0]) == "wide":
        out = _kl_dense_wide_launch(my, x, d, eps, block_rows)
        kl_stats_dense.wide_launches += 1
    elif route == "packed":
        out = _kl_dense_packed_launch(my, x, d, eps, block_rows)
        kl_stats_dense.packed_launches += 1
    else:
        out = _kl_dense_mu_launch(my, x, d, eps, block_rows)
        kl_stats_dense.mu_kl_launches += 1
    kl_stats_dense.launches += 1
    return out


kl_stats_dense.launches = 0
kl_stats_dense.packed_launches = 0
kl_stats_dense.mu_kl_launches = 0
kl_stats_dense.wide_launches = 0


def _kl_dense_wide_launch(my, x, d, eps, block_rows):
    """Launch ``csrc/mu_wide.cu``'s dense KL-MU (``kl_stats_dense``'s route
    above rank 128) on f32 or bf16 ``my``, ``x`` and ``d``: the prep, E1 =
    cdt(my / (x d + eps)), num = E1 d^T with the x update against dsum
    (``_dsum``, formed here as ``pallas_mu.py:618`` forms it), E2 over E1's
    buffer, numd with its reduction, and xsum from the f32 x_new's row-chunk
    partials and their reduction. Refuses what the route does not take
    before any build or launch."""
    m, n = my.shape
    k = d.shape[0]
    kp = -(-k // 128) * 128
    rows = _wide_chunk_rows(m, n, kp, block_rows)
    _check_kernel_args(my, x, d, 1, rows, wide_x=False, gate="dense",
                       method="kl-mu")
    limbs = limb_count(my.dtype)
    fns = _wide_fns()
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        d_l = column_limbs(d, kp, limbs)
        dsum = _dsum(d)
        xf, (xl,) = _wide_prep(fns, x, kp, limbs, False)
        e = torch.empty((m, ld_my), dtype=my.dtype, device=my.device)

        def ratio():
            _launch("kl_stats_dense (wide ratio)", fns["kl_resid"],
                    my.device, limbs, xl.data_ptr(), d_l.data_ptr(),
                    my_t.data_ptr(), ld_my, m, n, k, kp, float(eps),
                    e.data_ptr(), ld_my)

        ratio()
        x_new = torch.empty_like(x)
        _launch("kl_stats_dense (wide x update)", fns["kl_xrows"], my.device,
                limbs, e.data_ptr(), ld_my, d_l.data_ptr(), m, n, k, kp,
                xf.data_ptr(), dsum.data_ptr(), float(eps), x_new.data_ptr(),
                _is_bf16(x), xl.data_ptr())
        ratio()
        part = _f32(-(-m // rows) * k * n, my.device)
        numd = _f32((k, n), my.device)
        _wide_stat(fns, limbs, e, ld_my, xl, m, n, k, kp, rows, part, numd)
        sum_rows = wide_sum_rows(m, kp)
        xpart = _f32(-(-m // sum_rows) * k, my.device)
        xsum = _f32((1, k), my.device)
        _launch("kl_stats_dense (wide xsum)", fns["colsum"], my.device,
                xf.data_ptr(), m, k, kp, sum_rows, xpart.data_ptr(),
                xsum.data_ptr())
    return x_new, numd, xsum


def kl_dense_block_rows(m: int, n: int, block_rows=None) -> int:
    """Rows per partial of ``csrc/kl_dense_packed.cu``'s statistics pass:
    ``kl_packed_block_rows`` (the masked KL kernel's grid: two waves of
    128-column N tiles), or ``block_rows`` rounded up to whole 32-row
    stages."""
    if block_rows is None:
        return kl_packed_block_rows(m, n)
    return -(-block_rows // _KL_STAGE_ROWS) * _KL_STAGE_ROWS


def kl_dense_partials(m: int, n: int, block_rows=None):
    """``(chunks, groups)`` of ``csrc/kl_dense_packed.cu`` at M x N: the
    statistics pass's row chunks, each writing a partial numd, and the x
    update's 16-row groups (8 per 128-row stripe, one per warp), each
    writing a partial xsum. A function of the shape (and ``block_rows``)
    alone, so the summation order, and every bit of the result, is."""
    stripes = -(-m // _KL_DENSE_STRIPE_ROWS)
    return (-(-m // kl_dense_block_rows(m, n, block_rows)),
            stripes * (_KL_DENSE_STRIPE_ROWS // _KL_DENSE_SUM_ROWS))


def _kl_dense_packed_launch(my, x, d, eps, block_rows):
    """Launch ``csrc/kl_dense_packed.cu`` on f32 ``my`` (``kl_stats_dense``'s
    f32 route). d's limbs go to the kernel as ``column_limbs(d, KT)``,
    made once per call."""
    m, n = my.shape
    k = d.shape[0]
    rows = kl_dense_block_rows(m, n, block_rows)
    chunks, groups = kl_dense_partials(m, n, block_rows)
    _check_kernel_args(my, x, d, 1, rows, wide_x=False)
    if my.dtype != torch.float32:
        raise DtypeError(f"the packed dense KL kernel takes f32 data, got "
                         f"{my.dtype}")
    kt = 64 if k <= 64 else 128
    fn = _c_function("kl_dense_packed", "kl_dense_packed_launch",
                     (_I, _P, _I, _P, _P, _P, _F) + (_I,) * 4 + (_P,) * 7)
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        limbs = column_limbs(d, kt)
        dsum = _dsum(d)
        x_new = torch.empty_like(x)
        xc = torch.empty((m, 3 * kt), dtype=torch.bfloat16, device=my.device)
        xpart = _f32(groups * k, my.device)
        xsum = _f32((1, k), my.device)
        part = _f32(chunks * k * n, my.device)
        out = _f32(k * n, my.device)
        _launch("kl_stats_dense (packed)", fn, my.device, kt,
                my_t.data_ptr(), ld_my, x.data_ptr(), limbs.data_ptr(),
                dsum.data_ptr(), float(eps), m, n, k, rows,
                x_new.data_ptr(), xc.data_ptr(), xpart.data_ptr(),
                xsum.data_ptr(), part.data_ptr(), out.data_ptr())
    return x_new, out.view(k, n), xsum


def _kl_dense_mu_launch(my, x, d, eps, block_rows=None):
    """Launch the KL_DENSE kernel of ``csrc/mu_kl_stats.cu``
    (``kl_stats_dense``'s bf16 route). It takes f32 data too, so that both
    designs can be timed on the same inputs; nothing on the main path
    calls it with f32."""
    rows = block_rows or default_block_rows(my.shape[0])
    _check_kernel_args(my, x, d, 1, rows, wide_x=False)
    m, n = my.shape
    k = d.shape[0]
    fn = _c_function("mu_kl_stats", "kl_stats_dense_launch",
                     (_I,) + (_P,) * 4 + (_F,) + (_I,) * 4 + (_P,) * 6)
    with torch.cuda.device(my.device):
        dsum = _dsum(d)
        x_new = torch.empty_like(x)
        part = _f32(-(-m // rows) * k * n, my.device)
        out = _f32(k * n, my.device)
        xpart = _f32(-(-m // _X_STRIPE_ROWS) * k, my.device)
        xsum = _f32((1, k), my.device)
        _launch("kl_stats_dense", fn, my.device, _is_bf16(my),
                my.data_ptr(), x.data_ptr(), d.data_ptr(), dsum.data_ptr(),
                float(eps), m, n, k, rows, x_new.data_ptr(), part.data_ptr(),
                out.data_ptr(), xpart.data_ptr(), xsum.data_ptr())
    return x_new, out.view(k, n), xsum


def kl_stats_masked(my, mask, x, d, eps, *, block_rows=None):
    """The masked KL-MU statistics ``(x_new, numd, dend)``; see the module
    docstring.

    ``mask`` is either dense, in ``my``'s shape, or the bits of a 0/1
    mask from ``pack_mask`` (int32). On a CUDA tensor above rank 128 either
    form launches ``csrc/mu_wide.cu`` (``_kl_masked_wide_launch``; f32 data
    as bf16x6, bf16 in one limb), counted in ``.wide_launches``; at rank
    128 or less a packed mask launches ``csrc/kl_masked_packed.cu`` (f32
    ``my`` only; its products are bf16x6 on the tensor cores) and counts
    it in ``.packed_launches``, and a dense mask launches the masked KL
    kernel of ``csrc/mu_kl_stats.cu`` and counts it in
    ``.dense_launches``; ``.launches`` counts all three. On a CPU tensor a
    packed mask is unpacked to ``my``'s dtype for the twin, which then
    gives the dense mask's bits."""
    return _route_masked(kl_stats_masked, kl_stats_masked_plain,
                         _kl_packed_launch, _kl_masked_wide_launch, my, mask,
                         x, d, eps, block_rows)


kl_stats_masked.launches = 0
kl_stats_masked.packed_launches = 0
kl_stats_masked.dense_launches = 0
kl_stats_masked.wide_launches = 0


def _kl_masked_wide_launch(my, mask, x, d, eps, block_rows):
    """Launch ``csrc/mu_wide.cu``'s masked KL-MU (``kl_stats_masked``'s
    route above rank 128) on f32 or bf16 ``my``, ``x`` and ``d`` with the
    packed mask (int32 bits) or the weights (a dense mask in my's dtype):
    the prep, E1 = cdt(my / (x d + eps)), num = E1 d^T, the mask as E (the
    weights as they are; the bits expanded to 0/1 over E1's buffer), den =
    mask d^T with the x update, dend = x_new^T mask, then E2 over the same
    buffer and numd, each statistic with its reduction. One M x N buffer
    serves E1, the expanded bits and E2. Refuses what the route does not
    take before any build or launch."""
    m, n = my.shape
    k = d.shape[0]
    kp = -(-k // 128) * 128
    rows = _wide_chunk_rows(m, n, kp, block_rows)
    packed = mask.dtype == torch.int32
    if packed:
        _check_packed(my, mask)
        _check_kernel_args(my, x, d, 1, rows, wide_x=False, gate="masked",
                           method="kl-mu")
    else:
        _check_kernel_args(my, x, d, 1, rows, mask=mask, wide_x=False,
                           gate="masked", method="kl-mu")
    limbs = limb_count(my.dtype)
    fns = _wide_fns()
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        d_l = column_limbs(d, kp, limbs)
        xf, (xl,) = _wide_prep(fns, x, kp, limbs, False)
        e = torch.empty((m, ld_my), dtype=my.dtype, device=my.device)

        def ratio():
            _launch("kl_stats_masked (wide ratio)", fns["kl_resid"],
                    my.device, limbs, xl.data_ptr(), d_l.data_ptr(),
                    my_t.data_ptr(), ld_my, m, n, k, kp, float(eps),
                    e.data_ptr(), ld_my)

        ratio()
        num = _f32((m, kp), my.device)
        _launch("kl_stats_masked (wide num)", fns["rows"], my.device, limbs,
                e.data_ptr(), ld_my, d_l.data_ptr(), m, n, k, kp,
                num.data_ptr(), kp)
        if packed:
            bits = mask.contiguous()
            if bits.data_ptr() % 16:
                bits = bits.clone()
            _launch("kl_stats_masked (wide mask)", fns["expand"], my.device,
                    limbs, bits.data_ptr(), bits.shape[1], m, n, e.data_ptr(),
                    ld_my)
            mask_e, ld_mask = e, ld_my
        else:
            mask_e, ld_mask = _tma_rows(mask)
        x_new = torch.empty_like(x)
        _launch("kl_stats_masked (wide x update)", fns["xrows"], my.device,
                limbs, mask_e.data_ptr(), ld_mask, d_l.data_ptr(), m, n, k,
                kp, xf.data_ptr(), num.data_ptr(), float(eps),
                x_new.data_ptr(), _is_bf16(x), xl.data_ptr())
        del num, xf
        part = _f32(-(-m // rows) * k * n, my.device)
        out = _f32(2 * k * n, my.device)
        numd, dend = out.split((k * n, k * n))
        _wide_stat(fns, limbs, mask_e, ld_mask, xl, m, n, k, kp, rows, part,
                   dend)
        ratio()
        _wide_stat(fns, limbs, e, ld_my, xl, m, n, k, kp, rows, part, numd)
    return x_new, numd.view(k, n), dend.view(k, n)


def kl_takes_packed(my):
    """Whether ``kl_stats_masked`` runs ``my`` with a packed mask: f32
    data on the card (``csrc/kl_masked_packed.cu``), any data on the CPU
    (the twin)."""
    return my.dtype == torch.float32 or my.device.type == "cpu"


def kl_dense_route(dtype, device):
    """Which code ``kl_stats_dense`` runs for data of ``dtype`` on
    ``device``: ``'plain'`` (the twin) on the CPU; on the card
    ``'packed'`` (``csrc/kl_dense_packed.cu``, bf16x6 on ``wgmma``) for
    f32 data and ``'mu_kl'`` (``csrc/mu_kl_stats.cu``) for any other
    dtype, whose checks refuse all but bf16. Other devices raise. A route
    by dtype, never a fallback."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise DecompError(f"no kernel for device {device}")
    return "packed" if dtype == torch.float32 else "mu_kl"


def split_bf16x3(t):
    """The three round-to-nearest bf16 limbs of f32 ``t``, stacked (3,
    *t.shape): ``t0 = bf16(t)``, ``t1 = bf16(t - t0)``, ``t2 = bf16(t - t0
    - t1)``, each residual exact in f32, so that ``t0 + t1 + t2`` gives
    back ``t`` to within 2^-24 |t|. The operand split of the bf16x6
    products of ``csrc/kl_masked_packed.cu``, made once per call for
    ``d``, and of ``column_limbs``."""
    t = t.to(torch.float32)
    t0 = t.to(torch.bfloat16)
    r = t - t0.to(torch.float32)
    t1 = r.to(torch.bfloat16)
    t2 = (r - t1.to(torch.float32)).to(torch.bfloat16)
    return torch.stack((t0, t1, t2))


def column_limbs(t, kt, limbs=3):
    """``t`` (K, N), K <= ``kt``, as the ``wgmma`` kernels read it: (N,
    limbs kt) bf16, row n = [limb 0 of t[:, n] | limb 1 | limb 2] in
    ``split_bf16x3``'s round-to-nearest limbs, each zero past K. d's
    limbs for ``csrc/kl_dense_packed.cu`` and ``csrc/grad_dict_packed.cu``
    (made once per call) and a's for ``csrc/lasso_grad_packed.cu``
    (``cuda_lasso.grad_limbs``). ``limbs=1``, the bf16 instances of the
    last two: limb 0 alone, which for bf16 ``t`` is ``t`` itself."""
    k, n = t.shape
    out = torch.zeros((n, limbs, kt), dtype=torch.bfloat16, device=t.device)
    if limbs == 1:   # limb 0, without the residuals' launches
        out[:, 0, :k] = t.to(torch.float32).to(torch.bfloat16).T
    else:
        out[:, :, :k] = split_bf16x3(t)[:limbs].permute(2, 0, 1)
    return out.view(n, limbs * kt)


def kl_packed_block_rows(m: int, n: int) -> int:
    """Rows per partial of the packed KL kernel's statistics pass: enough
    chunks that chunks x 128-column N tiles make two waves of the one
    block per SM that the H100's 132 SMs hold (33 chunks of 3,040 rows at
    100,000 x 1,024), in whole 32-row stages. A function of the shape
    alone, so every bit of the result is."""
    tiles = -(-n // _KL_N_TILE)
    chunks = max(1, -(-2 * _KL_RESIDENT // tiles))
    rows = -(-m // chunks)
    return -(-rows // _KL_STAGE_ROWS) * _KL_STAGE_ROWS


def _kl_packed_launch(my, packed, x, d, eps, block_rows):
    """Launch ``csrc/kl_masked_packed.cu`` on f32 ``my`` and the packed
    mask (``kl_stats_masked``'s packed route). d's limbs go to the kernel
    as one (3 KT, ld) bf16 array, limb l in rows [l KT, l KT + K), zero
    rows and columns around it."""
    m, n = my.shape
    k = d.shape[0]
    rows = block_rows or kl_packed_block_rows(m, n)
    _check_kernel_args(my, x, d, 1, rows, wide_x=False)
    if my.dtype != torch.float32:
        raise DtypeError(f"the packed KL kernel takes f32 data, got "
                         f"{my.dtype}")
    if packed.data_ptr() % 16:
        packed = packed.clone()
    kt = 64 if k <= 64 else 128
    fn = _c_function("kl_masked_packed", "kl_masked_packed_launch",
                     (_I, _P, _I, _P, _I, _P, _P, _I, _F) + (_I,) * 4
                     + (_P,) * 5)
    with torch.cuda.device(my.device):
        my_t, ld_my = _tma_rows(my)
        ld_d = -(-n // 8) * 8
        limbs = torch.zeros((3, kt, ld_d), dtype=torch.bfloat16,
                            device=my.device)
        limbs[:, :k, :n] = split_bf16x3(d)
        x_new = torch.empty_like(x)
        xc = torch.empty((m, 3 * kt), dtype=torch.bfloat16, device=my.device)
        part = _f32(-(-m // rows) * 2 * k * n, my.device)
        out = _f32(2 * k * n, my.device)
        _launch("kl_stats_masked (packed)", fn, my.device, kt,
                my_t.data_ptr(), ld_my, packed.data_ptr(), packed.shape[1],
                x.data_ptr(), limbs.data_ptr(), ld_d, float(eps), m, n, k,
                rows, x_new.data_ptr(), xc.data_ptr(), part.data_ptr(),
                out.data_ptr())
    return x_new, out[:k * n].view(k, n), out[k * n:].view(k, n)


def _masked_launch(wrapper, my, mask, x, d, eps, block_rows):
    """Launch the kernel of ``wrapper``, ``mu_stats_masked`` or
    ``kl_stats_masked`` (the same C signature, but only the MU kernel takes
    f32 x with bf16 data), and count the launch on it."""
    name = wrapper.__name__
    rows = block_rows or default_block_rows(my.shape[0])
    mu = name == "mu_stats_masked"
    _check_kernel_args(my, x, d, 1, rows, mask=mask, wide_x=mu)
    m, n = my.shape
    k = d.shape[0]
    fn = _c_function("mu_kl_stats", f"{name}_launch",
                     (_I,) * (1 + mu) + (_P,) * 4 + (_F,) + (_I,) * 4
                     + (_P,) * 4)
    with torch.cuda.device(my.device):
        x_new = torch.empty_like(x)
        part = _f32(-(-m // rows) * 2 * k * n, my.device)
        out = _f32(2 * k * n, my.device)
        flags = (_is_bf16(my), _is_bf16(x))[:1 + mu]
        _launch(name, fn, my.device, *flags, my.data_ptr(), mask.data_ptr(),
                x.data_ptr(), d.data_ptr(), float(eps), m, n, k, rows,
                x_new.data_ptr(), part.data_ptr(), out.data_ptr())
    wrapper.launches += 1
    return x_new, out[:k * n].view(k, n), out[k * n:].view(k, n)


def mu_update_dense(y, x, d, eps, *, block_rows=None, d_master=None,
                    inner_iter=1, reduce=None):
    """One dense MU iteration. Returns (x_new, d_new).

    The statistics come from ``mu_stats_dense``; the d update is the JAX
    package's f32 epilogue (``pallas_mu.py:428-434``), a K x K by K x N
    product left to ``torch.matmul`` in full f32:
    ``d_new = d * numd / (gram d + eps)``. ``d_master``: mixed-precision
    mode, where ``d`` is the compute-dtype copy and ``d_master`` the wider
    iterate that the epilogue updates. ``reduce``: a row-sharded solve's
    sum over its ranks, applied to the statistics between the kernel and
    the epilogue (``pallas_mu.py:426-427``); each update function below
    takes it the same way.
    """
    x_new, numd, gram = mu_stats_dense(y, x, d, eps, block_rows=block_rows,
                                       inner_iter=inner_iter)
    if reduce is not None:
        numd, gram = reduce(numd), reduce(gram)
    d_epi = d if d_master is None else d_master
    return x_new, _epilogue(d_epi, numd, gram @ d_epi.to(torch.float32),
                            eps)


def mu_update_masked(my, mask, x, d, eps, *, block_rows=None, d_master=None,
                     reduce=None):
    """One masked MU iteration (``pallas_mu.py:502``). Returns (x_new,
    d_new) with ``d_new = d * numd / (dend + eps)`` in f32; ``d_master``
    and ``reduce`` as in ``mu_update_dense``."""
    x_new, numd, dend = mu_stats_masked(my, mask, x, d, eps,
                                        block_rows=block_rows)
    if reduce is not None:
        numd, dend = reduce(numd), reduce(dend)
    return x_new, _epilogue(d if d_master is None else d_master, numd, dend,
                            eps)


def kl_update_dense(my, x, d, eps, *, block_rows=None, reduce=None):
    """One dense KL-MU iteration (``pallas_mu.py:581``). Returns (x_new,
    d_new) with ``d_new = d * numd / (xsum^T + eps)`` in f32; ``reduce``
    as in ``mu_update_dense``."""
    x_new, numd, xsum = kl_stats_dense(my, x, d, eps, block_rows=block_rows)
    if reduce is not None:
        numd, xsum = reduce(numd), reduce(xsum)
    return x_new, _epilogue(d, numd, xsum[0][:, None], eps)


def kl_update_masked(my, mask, x, d, eps, *, block_rows=None, reduce=None):
    """One masked KL-MU iteration (``pallas_mu.py:664``). Returns (x_new,
    d_new) with ``d_new = d * numd / (dend + eps)`` in f32; ``reduce`` as
    in ``mu_update_dense``."""
    x_new, numd, dend = kl_stats_masked(my, mask, x, d, eps,
                                        block_rows=block_rows)
    if reduce is not None:
        numd, dend = reduce(numd), reduce(dend)
    return x_new, _epilogue(d, numd, dend, eps)


def _epilogue(d, numd, den, eps):
    """The d update's f32 epilogue, ``d * numd / (den + eps)``, stored in
    ``d``'s dtype."""
    eps32 = torch.tensor(float(eps), dtype=torch.float32)
    return (d.to(torch.float32) * numd / (den + eps32)).to(d.dtype)
