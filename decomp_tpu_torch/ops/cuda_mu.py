"""Dense multiplicative-update NMF statistics: the CUDA kernel and its
plain twin (counterpart of the dense part of ``decomp_tpu.ops.pallas_mu``).

``mu_stats_dense(y, x, d, eps)`` returns ``(x_new, numd, gram)``:

    x_new = x * (y d^T) / (x (d d^T) + eps)   (``inner_iter`` refinements
                                               reuse the numerator y d^T)
    numd  = x_new^T y       (K, N) f32
    gram  = x_new^T x_new   (K, K) f32

with the TPU kernel's quantisation points (``pallas_mu.py:175-198``):
products take compute-dtype operands (``cdt = y.dtype``) and sum in f32;
``d d^T`` is formed in f32 and cast to ``cdt`` at use; the iterate stays
f32 across refinements; ``x_new`` is stored in ``x``'s dtype; the
statistics use ``x_new`` cast to ``cdt``. As in the TPU kernel, ``x_new``
and the statistics are formed in f32 even for f64 data.

On a CUDA tensor the wrapper launches ``csrc/mu_stats_dense.cu`` (bf16 or
f32 ``y``; ``x`` in ``y``'s dtype or f32; ``d`` in ``y``'s dtype;
1 <= K <= 128) and raises on anything else. On a CPU tensor it runs
``mu_stats_dense_plain``. It never falls back from one to the other.

Not ported: ``calibrated_tpu``, ``fits_vmem`` and ``default_block_rows``,
which encode TPU v5e VMEM calibrations.
"""

import ctypes
import functools

import numpy as np
import torch

from decomp_tpu_torch.utils.exceptions import DecompError, DtypeError, ShapeError

# Largest rank the kernel takes (its rank tile, KP in the CUDA source).
KERNEL_MAX_RANK = 128
# The row chunks of the statistics pass aim at this many partials.
_TARGET_CHUNKS = 128
_MIN_CHUNK_ROWS = 256
_MAX_GRID_Y = 65535


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
    m = y.shape[0]
    rows = block_rows or default_block_rows(m)
    cdt, wdt = y.dtype, _work_dtype(y.dtype)
    eps32 = torch.tensor(float(eps), dtype=torch.float32)
    dw = d.to(wdt)
    ddt_c = gram_rows(d).to(cdt).to(wdt)
    x_new = torch.empty_like(x)
    numd = torch.zeros((d.shape[0], y.shape[1]), dtype=torch.float32,
                       device=y.device)
    gram = torch.zeros((d.shape[0], d.shape[0]), dtype=torch.float32,
                       device=y.device)
    for s in range(0, m, rows):
        yc = y[s:s + rows].to(wdt)
        num = (yc @ dw.T).to(torch.float32)
        xf = x[s:s + rows].to(torch.float32)
        for _ in range(int(inner_iter)):
            den = (xf.to(cdt).to(wdt) @ ddt_c).to(torch.float32)
            xf = xf * num / (den + eps32)
        x_new[s:s + rows] = xf.to(x.dtype)
        xc = xf.to(cdt).to(wdt)
        numd += (xc.T @ yc).to(torch.float32)
        gram += (xc.T @ xc).to(torch.float32)
    return x_new, numd, gram


def _check_kernel_args(y, x, d, inner_iter, block_rows):
    for name, t in (("y", y), ("x", x), ("d", d)):
        if t.device != y.device:
            raise DecompError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise DecompError(f"{name} must be contiguous")
    if y.dim() != 2 or x.dim() != 2 or d.dim() != 2:
        raise ShapeError("y, x and d must be 2-D")
    m, n = y.shape
    k = d.shape[0]
    if x.shape != (m, k) or d.shape != (k, n):
        raise ShapeError(f"x {tuple(x.shape)} and d {tuple(d.shape)} do not "
                         f"fit y {tuple(y.shape)}")
    if not 1 <= k <= KERNEL_MAX_RANK:
        raise ShapeError(f"the kernel takes 1 <= rank <= {KERNEL_MAX_RANK}, "
                         f"got {k}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise DtypeError(f"the kernel takes bf16 or f32 y, got {y.dtype}")
    if d.dtype != y.dtype:
        raise DtypeError(f"d must have y's dtype {y.dtype}, got {d.dtype}")
    if x.dtype not in (y.dtype, torch.float32):
        raise DtypeError(f"x must be {y.dtype} or float32, got {x.dtype}")
    if int(inner_iter) < 1:
        raise DecompError(f"inner_iter must be >= 1, got {inner_iter}")
    if max(m, n) >= 2 ** 31:
        raise ShapeError(f"y's sides must be < 2^31, got {tuple(y.shape)}")
    if -(-m // block_rows) > _MAX_GRID_Y:
        raise DecompError(f"kernel_block_rows={block_rows} gives more than "
                          f"{_MAX_GRID_Y} row chunks for M={m}")


@functools.cache
def _launcher():
    """The kernel's C entry point, built on first use, with its ctypes
    signature (pointers and the stream as c_void_p)."""
    from decomp_tpu_torch.ops import _build

    fn = _build.load("mu_stats_dense").mu_stats_dense_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4)
    return fn


def mu_stats_dense(y, x, d, eps, *, block_rows=None, inner_iter=1):
    """The dense-MU statistics ``(x_new, numd, gram)``; see the module
    docstring. ``block_rows``: rows per partial of the kernel's statistics
    pass (on CPU: rows per upcast chunk of the twin)."""
    validate_block_rows(block_rows)
    if y.device.type == "cpu":
        return mu_stats_dense_plain(y, x, d, eps, block_rows=block_rows,
                                    inner_iter=inner_iter)
    if y.device.type != "cuda":
        raise DecompError(f"no kernel for device {y.device}")
    rows = block_rows or default_block_rows(y.shape[0])
    _check_kernel_args(y, x, d, inner_iter, rows)
    m, n = y.shape
    k = d.shape[0]
    fn = _launcher()
    with torch.cuda.device(y.device):
        ddt = gram_rows(d)
        chunks = -(-m // rows)
        size = k * n + k * k
        x_new = torch.empty_like(x)
        part = torch.empty(chunks * size, dtype=torch.float32,
                           device=y.device)
        out = torch.empty(size, dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(int(y.dtype == torch.bfloat16),
                 int(x.dtype == torch.bfloat16),
                 y.data_ptr(), x.data_ptr(), d.data_ptr(), ddt.data_ptr(),
                 float(eps), m, n, k, int(inner_iter), rows,
                 x_new.data_ptr(), part.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mu_stats_dense launch failed: cudaError {err}")
    mu_stats_dense.launches += 1
    return x_new, out[:k * n].view(k, n), out[k * n:].view(k, k)


mu_stats_dense.launches = 0


def mu_update_dense(y, x, d, eps, *, block_rows=None, d_master=None,
                    inner_iter=1):
    """One dense MU iteration. Returns (x_new, d_new).

    The statistics come from ``mu_stats_dense``; the d update is the JAX
    package's f32 epilogue (``pallas_mu.py:428-434``), a K x K by K x N
    product left to ``torch.matmul`` in full f32:
    ``d_new = d * numd / (gram d + eps)``. ``d_master``: mixed-precision
    mode, where ``d`` is the compute-dtype copy and ``d_master`` the wider
    iterate that the epilogue updates.
    """
    x_new, numd, gram = mu_stats_dense(y, x, d, eps, block_rows=block_rows,
                                       inner_iter=inner_iter)
    eps32 = torch.tensor(float(eps), dtype=torch.float32)
    d_epi = d if d_master is None else d_master
    d32 = d_epi.to(torch.float32)
    den_d = gram @ d32
    d_new = (d32 * numd / (den_d + eps32)).to(d_epi.dtype)
    return x_new, d_new
