"""Batch-lasso kernels and their plain twins (counterpart of
``decomp_tpu.ops.pallas_fista`` and of the rows kernel of
``decomp_tpu.ops.pallas_lasso``).

    solve_rows(yah, gram, x0, z0, t0, done0, nit0, step, thresh, tol, ...)
        -> (x, z, t, done, niter): the whole batched ISTA / FISTA /
           acc_ista solve of unmasked rows, each row stopping on its own
    masked_grad_rows(my, mask, x, a)
        -> g = (mask * (x a) - my) a^T: the masked lasso gradient

``solve_rows`` keeps the TPU kernel's semantics (``pallas_fista.py:133-
346``): the gradient ``v gram - yah``, the prox ``sign(u) max(|u| -
thresh, 0)`` of ``u = v - step grad``, momentum ``t' = (1 + sqrt(1 +
4 t^2)) / 2``, ``z' = x' + ((t - 1) / t') (x' - x)`` with the row-local
restart when ``(z - x') . (x' - x) > 0``, and per-row stopping on ``|x' -
x| / max(|x'|, f32 tiny) < tol`` in division form. A row that is done
leaves x, z and t as they are and stops counting iterations; rows that
enter done never move. ``step`` and ``thresh`` are scalars or per-feature
vectors. ``fixed=True`` (the caller knows ``tol <= 0``) drops the stopping
test: rows that entered done are kept and the others report ``nit0 +
maxiter``, bit-identical to the exact mode at ``tol = 0``. ``hi_lo=True``
(precision 'high') computes each product as bf16x3: the operands are split
into a high half, the f32 value with its low 16 bits cleared (exact in
bf16), and a low half, the bf16 rounding of the remainder; the products
hi.hi + hi.lo + lo.hi are summed in f32 and lo.lo is dropped
(``pallas_fista.py:123-130``, ``:159-182``). ``hi_lo=False`` is full f32
(on the wide route above 1,024 reals, bf16x6: three round-to-nearest bf16
limbs of each operand, ``cuda_mu.split_bf16x3``, and the six products
whose limb indices add up to at most 2).

Complex data (``group_fc``, ``pallas_fista.py:192-205``): complex64 yah,
gram, x0 and z0 run ``solve_rows``' complex mode. A row of Fc complex
features is solved as F = 2 Fc interleaved reals ``[re_0, im_0, re_1, ...]``
(``as_pairs``, a view of a contiguous complex tensor) against the real
embedding of the Hermitian Gram (``embed_gram``: the 2 x 2 block ``[[Re,
Im], [-Im, Re]]`` of each complex entry); the prox is the paired-magnitude
soft threshold ``u max(1 - thresh / max(|u|, tiny), 0)`` of each complex
``u``, and the stopping and restart sums run over all 2 Fc reals. Step and
threshold are per complex feature. x and z come back complex64. JAX's
``[re | im]`` halves are the same function with the sums over k in another
order.

``masked_grad_rows`` keeps the quantisation points of
``pallas_lasso.py:144-156``: products take the data's dtype (``cdt``) as
operands and sum in f32, the residual ``cdt(f32(mask) * (x a) - f32(my))``
is formed in f32 and cast to ``cdt``, and ``g`` is stored in x's dtype. Its
mask is dense, in my's shape, or the bits of a 0/1 mask
(``cuda_mu.pack_mask``, int32).

On a CUDA tensor a wrapper launches its kernel (``solve_rows``: f32
with 1 <= F <= ``SOLVE_MAX_FEATURES``, or complex64 with 1 <= Fc <=
``SOLVE_MAX_COMPLEX_FEATURES``, on ``csrc/lasso_fista_tma.cu`` for
``hi_lo=True`` and ``csrc/lasso_fista.cu`` for ``hi_lo=False``; above, up to
the TPU kernel's gate ``solve_fits``, on ``csrc/lasso_fista_wide.cu`` at
either precision, 'highest' as bf16x6 there (``solve_route`` names the
route from F alone);
``masked_grad_rows``, f32 or bf16 data at 1 <= F <= ``GRAD_MAX_FEATURES``
at any N and at wider F inside the TPU kernel's gate, ``grad_fits``, on
wgmma, whose f32 products run as bf16x6 limb
products and whose bf16 products as one bf16 pass (a's limbs from
``grad_limbs``: three, or one for bf16), on the route ``grad_route`` names
from F alone: for 1 <= F <= ``GRAD_MAX_FEATURES`` ``csrc/lasso_grad_packed.cu``
(a packed mask on its bits instance, a dense mask, i.e. a weighted one, in
the data's dtype on its weighted instance), above it ``csrc/grad_wide.cu``
(the residual E to device memory once, then g = E a^T; bits or weights
alike) and raises on anything else. On a CPU
tensor it runs its ``*_plain`` twin (a packed mask unpacked to my's dtype
first). It never falls back from one to the other. Each wrapper counts
its kernel launches in ``.launches``; ``solve_rows`` counts its complex-mode launches
in ``.complex_launches``, its launches of the 'high' kernel in
``.tma_launches`` and of the wide one in ``.wide_launches`` as well; ``masked_grad_rows`` counts each route, in
``.packed_launches`` and ``.dense_launches`` (the weighted instance) for
the fused kernel and ``.wide_launches`` for the wide one. The
'high' kernel gives, row for row, the bits of ``csrc/lasso_fista.cu``'s
'high' path, which ``_solve_rows_mma`` still launches for comparison;
``csrc/lasso_grad.cu``, the first design of the dense-mask gradient
(``mma.sync`` for bf16, full-f32 FMAs for f32), is on no route: only the
private ``_grad_dense_mma_launch`` reaches it, for timing.

Not ported: the TPU kernels' VMEM calibrations and 128-alignment padding
(``default_block_rows``, ``auto_wins``, ``kernel_alignment``, ``pad2``,
``pad_alpha``): the CUDA kernels mask ragged rows and features themselves.
``grad_fits`` keeps ``pallas_lasso.fits_vmem``'s gate, after
``kernel_alignment``'s padding, and ``solve_fits`` ``pallas_fista.fits_vmem``'s
after the solvers' padding, as the port's own predicates.
"""

import torch

from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.ops.cuda_mu import (_F, _I, _P, _c_function, _launch,
                                          _runs_plain, _work_dtype)
from decomp_tpu_torch.utils.exceptions import (DecompError, DtypeError,
                                               ShapeError)

# Largest F of solve_rows' narrow kernels (csrc/lasso_fista.cu,
# csrc/lasso_fista_tma.cu: a block's rows stay on chip in f32); wider F, up
# to the TPU kernel's gate (solve_fits), takes the wide route
# (csrc/lasso_fista_wide.cu).
SOLVE_MAX_FEATURES = 1024
# Largest complex Fc of the narrow kernels' complex mode: 2 Fc reals.
SOLVE_MAX_COMPLEX_FEATURES = SOLVE_MAX_FEATURES // 2
# The whole solve's gate, the TPU kernel's (pallas_fista.py:64-120): its
# VMEM budget and calibration, at the 16-row stripe that the TPU's
# default_block_rows falls back to.
_SOLVE_VMEM_LIMIT = int(15.5 * 1024 * 1024)
_SOLVE_CALIBRATION = 1.6
# Largest F of masked_grad_rows' fused kernel (csrc/lasso_grad_packed.cu):
# its rank tile (KP in csrc/nmf_common.cuh); wider F takes the wide route.
GRAD_MAX_FEATURES = 128
# The masked gradients' gate, the TPU kernels' (pallas_lasso.py:72
# fits_vmem): F and N padded to 128, f_pad n_pad itemsize 2 < 10 MiB. Its
# corners: F <= 1,152 f32 and 2,432 bf16 at N = 1,024; 10,112 and 20,352
# at N <= 128.
GRAD_GATE_BYTES = 10 * 2**20
# Rows per block of solve_rows' kernels: 32 up to F = 512, 16 above.
_WIDE_STRIPE_MAX_F = 512
# The 'high' kernel's tiles: 512 output columns by 16 deep.
_TILE_COLS, _KD = 512, 16
# Rows per chunk of masked_grad_rows' twin.
_GRAD_CHUNK_ROWS = 8192
_F32_TINY = torch.finfo(torch.float32).tiny
_HI_MASK = -65536  # 0xFFFF0000 as an int32


def split_hi_lo(v):
    """The bf16x3 split of f32 ``v``: ``hi``, the f32 value with its low 16
    bits cleared (exact in bf16), and ``lo = bf16(v - hi)``, both bf16."""
    hi_f = (v.contiguous().view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi_f.to(torch.bfloat16), (v - hi_f).to(torch.bfloat16)


def _solve_resident_bytes(f_pad, momentum, hi_lo, block_rows, group):
    """``pallas_fista._resident_bytes``: the TPU kernel's VMEM residents
    (the Gram, the step and threshold rows, the stripe's planes) times its
    calibration."""
    planes = 3 + (2 if momentum else 0) + (2 if group else 0)
    per_row = planes * 2 * 4 * f_pad + 6 * 4
    extra = 2 * block_rows * f_pad * 2 if hi_lo else 0
    raw = 4 * f_pad * f_pad + block_rows * per_row + extra + 2 * 4 * f_pad
    return int(raw * _SOLVE_CALIBRATION)


def solve_fits(f: int, momentum: bool = True, hi_lo: bool = False,
               group: bool = False) -> bool:
    """Whether ``solve_rows`` takes F reals (2 Fc in the complex mode,
    ``group``): the TPU kernel's gate, the port's own copy of
    ``pallas_fista.fits_vmem`` applied after the JAX callers' padding (F up
    to a multiple of 128, ``lasso.py:804``; in the complex mode Fc, then
    doubled, ``lasso.py:904``). ``fits_vmem`` with its default stripe
    asks whether the 16-row stripe fits (``default_block_rows`` halves the
    stripe until it fits or reaches 16, and the residents grow with it).
    Its edges: 1,408 reals with momentum, 1,536 without, 640 complex
    features, at either precision."""
    if group:
        f_pad = 2 * (-(-f // 256) * 128)
    else:
        f_pad = -(-f // 128) * 128
    return (_solve_resident_bytes(f_pad, momentum, hi_lo, 16, group)
            <= _SOLVE_VMEM_LIMIT)


def solve_max_features(momentum: bool = True, hi_lo: bool = False,
                       group: bool = False) -> int:
    """The largest F (reals) that ``solve_fits`` takes."""
    step = 256 if group else 128
    f = step
    while solve_fits(f + step, momentum, hi_lo, group):
        f += step
    return f


def solve_route(f: int) -> str:
    """Which kernel ``solve_rows`` launches for F reals: ``'narrow'``
    (``csrc/lasso_fista_tma.cu`` at 'high', ``csrc/lasso_fista.cu`` at
    'highest') for F <= ``SOLVE_MAX_FEATURES``, ``'wide'``
    (``csrc/lasso_fista_wide.cu``, both precisions) above. A function of F
    alone: no shape moves to another route on a failure."""
    return "narrow" if f <= SOLVE_MAX_FEATURES else "wide"


def stripe_rows(block_rows, f: int) -> int:
    """Rows per stripe of ``solve_rows``' kernel at F features: 16, or 32
    at F <= 512 (the default there); anything else is refused. The wide
    route's clusters hold 16 row slots."""
    rows = block_rows or (32 if f <= _WIDE_STRIPE_MAX_F else 16)
    if rows not in (16, 32) or (rows == 32 and f > _WIDE_STRIPE_MAX_F):
        raise DecompError(f"kernel_block_rows must be 16, or 32 at F <= "
                          f"{_WIDE_STRIPE_MAX_F}; got {block_rows!r} at F={f}")
    return rows


def _feature_vector(v, f, device):
    """A scalar or (F,) / (1, F) step or threshold as an f32 (F,) tensor."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if v.numel() not in (1, f):
        raise ShapeError(f"step / threshold must be a scalar or have {f} "
                         f"entries, got {v.numel()}")
    return v.expand(f).contiguous()


def as_pairs(v):
    """A complex (M, Fc) tensor as the f32 (M, 2 Fc) rows ``[re_0, im_0,
    re_1, im_1, ...]``: a view of a contiguous complex64 tensor."""
    v = v.resolve_conj().contiguous()
    return torch.view_as_real(v).reshape(v.shape[0], 2 * v.shape[1])


def from_pairs(v):
    """``as_pairs``' inverse: f32 (M, 2 Fc) rows as a complex64 (M, Fc)
    view."""
    return torch.view_as_complex(v.contiguous().reshape(v.shape[0], -1, 2))


def embed_gram(gram):
    """The real embedding of a complex (Fc, Fc) Gram in ``as_pairs``'
    order: (2 Fc, 2 Fc) f32 with the block ``[[Re g, Im g], [-Im g, Re g]]``
    at (k, n), so that ``as_pairs(v) @ embed_gram(g) == as_pairs(v @ g)``.
    It is symmetric when ``gram`` is Hermitian."""
    g = torch.view_as_real(gram.resolve_conj())
    re, im = g[..., 0], g[..., 1]
    rows = torch.stack([torch.stack([re, im], -1),
                        torch.stack([-im, re], -1)], 1)
    fc = gram.shape[0]
    return rows.reshape(2 * fc, 2 * fc).to(torch.float32)


def pair_gram(gram):
    """A complex (Fc, Fc) Gram as the (Fc, 2 Fc) f32 rows that the 'high'
    kernel (``csrc/lasso_fista_tma.cu``) reads: row n holds ``(Re g[k, n],
    Im g[k, n])`` for k = 0 .. Fc - 1, column n of ``gram`` in ``as_pairs``'
    order. It builds ``embed_gram``'s entries from these pairs in
    registers, so it reads each complex entry once."""
    return as_pairs(gram.resolve_conj().T)


def _pairs_of_embedding(emb):
    """``pair_gram`` of the complex Gram whose ``embed_gram`` is ``emb``
    (2 Fc, 2 Fc): ``emb[2k, 2n + j]`` is pair entry (n, 2k + j). Refuses an
    ``emb`` that is not, bit for bit, the embedding of those pairs: the
    'high' kernel reads only the pairs."""
    fc = emb.shape[0] // 2
    pairs = emb[0::2].reshape(fc, fc, 2).transpose(0, 1).reshape(fc, 2 * fc)
    again = embed_gram(from_pairs(pairs).T)
    if not torch.equal(again.view(torch.int32),
                       emb.contiguous().view(torch.int32)):
        raise DecompError("group=True at precision 'high', or above "
                          f"{SOLVE_MAX_FEATURES} reals, takes the embed_gram "
                          "of a complex Gram ([[Re, Im], [-Im, Re]] "
                          "blocks); pass complex64 operands instead")
    return pairs


def _complex_pairs(yah, gram, x0, z0, stepsz, thresh, embed=True):
    """``solve_rows``' complex64 operands in the complex mode's f32 layout:
    yah, x0, z0 as pairs, the embedded Gram (or with ``embed=False`` the
    ``pair_gram`` that the 'high' kernel reads), and step and threshold
    repeated in both reals of each feature. Refuses other dtypes and
    shapes."""
    if yah.dim() != 2:
        raise ShapeError(f"yah must be 2-D, got {tuple(yah.shape)}")
    m, fc = yah.shape
    for name, t, shape in (("yah", yah, (m, fc)), ("gram", gram, (fc, fc)),
                           ("x0", x0, (m, fc)), ("z0", z0, (m, fc))):
        if t.dtype != torch.complex64:
            raise DtypeError(f"the complex mode takes complex64 {name} "
                             f"(f32 parts), got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ShapeError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    step, thr = (_feature_vector(v, fc, yah.device).repeat_interleave(2)
                 for v in (stepsz, thresh))
    return (as_pairs(yah), embed_gram(gram) if embed else pair_gram(gram),
            as_pairs(x0), as_pairs(z0), step, thr)


def _complex_call(fn, yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh,
                  tol, **kw):
    """``fn`` (``solve_rows`` or its twin) on complex64 operands, through
    the complex mode; x and z come back complex64."""
    yah, gram, x0, z0, step, thr = _complex_pairs(yah, gram, x0, z0, stepsz,
                                                  thresh)
    x, z, t, done, nit = fn(yah, gram, x0, z0, t0, done0, nit0, step, thr,
                            tol, group=True, **kw)
    return from_pairs(x), from_pairs(z), t, done, nit


def _gradient(yah, gram, hi_lo):
    """``v -> v gram - yah`` in full f32 or bf16x3 (the exact bf16 halves
    upcast to f32: a bf16 x bf16 product is exact in f32)."""
    if not hi_lo:
        return lambda v: v @ gram - yah
    ghi, glo = (h.float() for h in split_hi_lo(gram))

    def grad(v):
        vhi, vlo = (h.float() for h in split_hi_lo(v))
        p = vhi @ ghi
        p = p + vhi @ glo
        p = p + vlo @ ghi
        return p - yah

    return grad


def solve_rows_plain(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol,
                     *, momentum, restart, maxiter, hi_lo=False, fixed=False,
                     block_rows=None, group=False):
    """``solve_rows``' plain twin: the same function in plain torch. The
    host loops over iterations, freezes rows per step and looks for an
    all-done stripe every 8 steps (which changes no row's result).
    ``block_rows`` is the kernel's stripe height and changes nothing here.
    Complex64 operands, or ``group=True`` on their f32 pairs, run the
    complex mode's paired-magnitude prox.
    """
    del block_rows
    kw = dict(momentum=momentum, restart=restart, maxiter=maxiter,
              hi_lo=hi_lo, fixed=fixed)
    if yah.is_complex():
        return _complex_call(solve_rows_plain, yah, gram, x0, z0, t0, done0,
                             nit0, stepsz, thresh, tol, **kw)
    f32 = torch.float32
    m, f = yah.shape
    dev = yah.device
    yah, gram = yah.to(f32), gram.to(f32)
    step = _feature_vector(stepsz, f, dev)[None, :]
    thr = _feature_vector(thresh, f, dev)[None, :]
    tol = torch.tensor(float(tol), dtype=f32, device=dev)
    tiny = torch.tensor(_F32_TINY, dtype=f32, device=dev)
    grad = _gradient(yah, gram, hi_lo)

    def prox(v):
        u = v - step * grad(v)
        if group:
            pair = u.reshape(m, f // 2, 2)
            mag = torch.sqrt(pair[..., 0] * pair[..., 0]
                             + pair[..., 1] * pair[..., 1])
            scale = torch.clamp(1.0 - thr[:, 0::2] / torch.maximum(mag, tiny),
                                min=0.0)
            return (pair * scale[..., None]).reshape(m, f)
        return torch.sign(u) * torch.clamp(torch.abs(u) - thr, min=0.0)

    def candidate(x, z, t):
        if not momentum:
            return prox(x), z, t
        x_c = prox(z)
        t_c = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z_c = x_c + ((t - 1.0) / t_c) * (x_c - x)
        if restart:
            do = torch.sum((z - x_c) * (x_c - x), dim=1, keepdim=True) > 0
            t_c = torch.where(do, torch.ones_like(t_c), t_c)
            z_c = torch.where(do, x_c, z_c)
        return x_c, z_c, t_c

    x0 = x0.to(f32)
    z0 = (z0 if momentum else x0).to(f32)
    t0 = t0.reshape(m, 1).to(f32)
    done0 = done0.reshape(m, 1).to(f32)
    nit0 = nit0.reshape(m, 1).to(torch.int32)
    keep0 = done0 > 0.5
    x, z, t = x0, z0, t0
    if fixed:
        for _ in range(int(maxiter)):
            x, z, t = candidate(x, z, t)
        x = torch.where(keep0, x0, x)
        z = torch.where(keep0, z0, z) if momentum else x
        t = torch.where(keep0, t0, t)
        nit = nit0 + torch.where(keep0, 0, int(maxiter)).to(torch.int32)
        return x, z, t, done0.clone(), nit

    done, nit = keep0, nit0.clone()
    for it in range(int(maxiter)):
        if it % 8 == 0 and bool(done.all()):
            break
        x_c, z_c, t_c = candidate(x, z, t)
        num = torch.sqrt(torch.sum((x_c - x) ** 2, dim=1, keepdim=True))
        den = torch.maximum(torch.sqrt(torch.sum(x_c * x_c, dim=1,
                                                 keepdim=True)), tiny)
        newly = num / den < tol
        x = torch.where(done, x, x_c)
        if momentum:
            z = torch.where(done, z, z_c)
            t = torch.where(done, t, t_c)
        nit = nit + (~done).to(torch.int32)
        done = done | newly
    return x, (z if momentum else x), t, done.to(f32), nit


def check_solve_rows_args(yah, gram, x0, z0, t0, done0, nit0, maxiter,
                          block_rows, pairs=False, *, momentum=True,
                          hi_lo=False, group=False):
    """Refuse what ``solve_rows``' kernels do not take, before any launch:
    among it F past the TPU kernel's gate (``solve_fits`` for ``momentum``,
    ``hi_lo`` and the complex mode, ``group``). ``pairs``: gram is the
    complex mode's ``pair_gram`` (F / 2, F)."""
    if yah.dim() != 2:
        raise ShapeError(f"yah must be 2-D, got {tuple(yah.shape)}")
    m, f = yah.shape
    gshape = (f // 2, f) if pairs else (f, f)
    for name, t, shape in (("yah", yah, (m, f)), ("gram", gram, gshape),
                           ("x0", x0, (m, f)), ("z0", z0, (m, f))):
        if t.device != yah.device:
            raise DecompError(f"{name} is on {t.device}, yah on {yah.device}")
        if t.dtype != torch.float32:
            raise DtypeError(f"the kernel takes f32 {name}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ShapeError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("t0", t0), ("done0", done0), ("nit0", nit0)):
        if t.device != yah.device or t.numel() != m:
            raise ShapeError(f"{name} must hold {m} entries on {yah.device}")
    group = group or pairs
    if f < 1 or (solve_route(f) == "wide"
                 and not solve_fits(f, momentum, hi_lo, group)):
        edge = solve_max_features(momentum, hi_lo, group)
        what = (f"reals ({edge // 2} complex features) in the complex mode"
                if group else "features with momentum" if momentum
                else "features without momentum")
        raise ShapeError(f"the whole-solve kernels take 1 <= F <= {edge} "
                         f"{what} (the TPU kernel's gate, solve_fits), got "
                         f"F={f}")
    if m >= 2 ** 31 or int(maxiter) >= 2 ** 31:
        raise ShapeError("M and maxiter must be < 2^31")
    return stripe_rows(block_rows, f)


def solve_rows(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol, *,
               momentum, restart, maxiter, hi_lo=False, fixed=False,
               block_rows=None, group=False):
    """The whole batched proximal-gradient solve; see the module docstring.

    yah (M, F), gram (F, F), x0 and z0 (M, F): f32, or complex64 for the
    complex mode (``z0`` is read only by the momentum methods); t0, done0
    (0/1) and nit0: M entries each, any shape; ``stepsz`` and ``thresh``
    scalars or F-vectors; ``tol`` a number. ``block_rows``: the kernel's
    rows per block, 16 or 32 (32 only at F <= 512 reals; default by F).
    ``group=True`` runs the complex mode on f32 operands already in its
    layout (F even). Returns (x, z, t, done, niter) with shapes ((M, F),
    (M, F), (M, 1), (M, 1), (M, 1)), x and z in yah's dtype, done f32 0/1
    and niter int32.

    On the card, F <= ``SOLVE_MAX_FEATURES`` reals launch
    ``csrc/lasso_fista_tma.cu`` at ``hi_lo=True`` (counted in
    ``.tma_launches``) and ``csrc/lasso_fista.cu`` at ``hi_lo=False``;
    wider F, up to the TPU kernel's gate (``solve_fits``), launches
    ``csrc/lasso_fista_wide.cu`` at either precision (``.wide_launches``).
    ``.launches`` counts all three, ``.complex_launches`` those of the
    complex mode; each block's (or, on the wide route, each cluster's)
    slot-iterations of the last launch of the persistent kernels stay in
    ``.slot_iters``.
    """
    if int(maxiter) < 0:
        raise ValueError(f"maxiter must be >= 0, got {maxiter}")
    kw = dict(momentum=momentum, restart=restart, maxiter=maxiter,
              hi_lo=hi_lo, fixed=fixed, block_rows=block_rows)
    if yah.is_complex():
        wide = solve_route(2 * yah.shape[-1]) == "wide"
        if _runs_plain(yah) or not (hi_lo or wide):
            return _complex_call(solve_rows, yah, gram, x0, z0, t0, done0,
                                 nit0, stepsz, thresh, tol, **kw)
        # The 'high' and the wide kernels read the pair Gram, not the
        # embedding.
        yah, gram, x0, z0, step, thr = _complex_pairs(
            yah, gram, x0, z0, stepsz, thresh, embed=False)
        x, z, t, done, nit = _solve_rows_card(yah, gram, x0, z0, t0, done0,
                                              nit0, step, thr, tol,
                                              group=True, pairs=True, **kw)
        return from_pairs(x), from_pairs(z), t, done, nit
    stripe_rows(block_rows, yah.shape[-1])
    if group and yah.shape[-1] % 2:
        raise ShapeError(f"the complex mode takes an even F, got "
                         f"{yah.shape[-1]}")
    if _runs_plain(yah):
        return solve_rows_plain(yah, gram, x0, z0, t0, done0, nit0, stepsz,
                                thresh, tol, group=group, **kw)
    return _solve_rows_card(yah, gram, x0, z0, t0, done0, nit0, stepsz,
                            thresh, tol, group=group, **kw)


def _solve_rows_card(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol,
                     *, group=False, pairs=False, **kw):
    """``solve_rows`` on f32 operands on the card: the route of F
    (``solve_route``) and, on the narrow one, of the precision.
    ``pairs``: the complex mode's gram is already ``pair_gram``'s, else in
    the complex mode the embedding, which the 'high' and the wide kernels
    read as its pairs. The persistent kernels' launchers count their
    launches; ``csrc/lasso_fista.cu``'s is counted here."""
    f = yah.shape[-1]
    wide = solve_route(f) == "wide"
    if group and not pairs and (wide or kw["hi_lo"]):
        check_solve_rows_args(yah, gram, x0, z0, t0, done0, nit0,
                              kw["maxiter"], kw["block_rows"],
                              momentum=kw["momentum"], hi_lo=kw["hi_lo"],
                              group=True)
        gram = _pairs_of_embedding(gram)
    if wide:
        return _solve_rows_wide(yah, gram, x0, z0, t0, done0, nit0, stepsz,
                                thresh, tol, group=group, **kw)
    if kw["hi_lo"]:
        return _solve_rows_tma(yah, gram, x0, z0, t0, done0, nit0, stepsz,
                               thresh, tol, group=group, **kw)
    out = _solve_rows_mma(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh,
                          tol, group=group, **kw)
    solve_rows.launches += 1
    solve_rows.complex_launches += int(bool(group))
    return out


solve_rows.launches = 0
solve_rows.complex_launches = 0
solve_rows.tma_launches = 0
solve_rows.wide_launches = 0
solve_rows.slot_iters = None


def _outputs(m, f, dev):
    """Empty x, z (M, F), t, done (M, 1) f32 and niter (M, 1) int32."""
    x = torch.empty((m, f), dtype=torch.float32, device=dev)
    t = torch.empty((m, 1), dtype=torch.float32, device=dev)
    return (x, torch.empty_like(x), t, torch.empty_like(t),
            torch.empty((m, 1), dtype=torch.int32, device=dev))


def _row_state(t0, done0, nit0, m):
    """t0, done0 (f32) and nit0 (int32) as contiguous (M,) tensors."""
    return (t0.reshape(m).to(torch.float32).contiguous(),
            done0.reshape(m).to(torch.float32).contiguous(),
            nit0.reshape(m).to(torch.int32).contiguous())


def stage_rows(f: int, group: bool = False):
    """Rows of each 512-column chunk's tiles in ``csrc/lasso_fista_tma.cu``
    at F (real) features (its ``chunk_rows``): the rows that the chunk's
    columns read, its columns rounded up to whole 8-column groups, and half
    as many pair rows in the complex mode."""
    return [-(-min(_TILE_COLS, f - c) // 8) * (4 if group else 8)
            for c in range(0, f, _TILE_COLS)]


def tile_images(b_rows, group=False, limbs=2):
    """The stage images that ``csrc/lasso_fista_tma.cu`` and
    ``csrc/lasso_fista_wide.cu`` copy into their rings, one bulk copy a
    stage: ``b_rows`` (N, F) f32 holds row n of the product's B^T (B(k, n)
    = b_rows[n, k]; N = F), or with ``group`` the pair Gram (N = F / 2).
    Returns them as one flat bf16 tensor: for each chunk c of 512 output
    columns (``stage_rows(F, group)[c]`` rows from row 512 c, or 256 c) and
    each depth step s (k = 16 s ..), the tile of each limb, 16 values a row
    with the two 8-element halves swapped on rows with bit 2 set (the
    kernels' bank-conflict swizzle), zeros past the matrix. ``limbs``: 2,
    the hi then the lo of ``split_hi_lo`` ('high'), or 3, the limbs of
    ``cuda_mu.split_bf16x3`` (the wide kernel's 'highest')."""
    n, k = b_rows.shape
    nks, dev = -(-k // _KD), b_rows.device
    first = _TILE_COLS // 2 if group else _TILE_COLS
    parts = (split_hi_lo(b_rows) if limbs == 2
             else tuple(cuda_mu.split_bf16x3(b_rows)))
    images = []
    for c, rows in enumerate(stage_rows(k, group)):
        swap = ((torch.arange(rows, device=dev) >> 2) & 1).bool()
        tiles = []
        for h in parts:
            p = torch.zeros((rows, nks * _KD), dtype=torch.bfloat16,
                            device=dev)
            part = h[c * first:c * first + rows]
            p[:part.shape[0], :k] = part
            p = p.reshape(rows, nks, 2, _KD // 2).transpose(0, 1)
            tiles.append(torch.where(swap[:, None, None], p.flip(-2), p))
        images.append(torch.stack(tiles, 1).reshape(-1))
    return torch.cat(images)


def _solve_rows_tma(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol,
                    *, momentum, restart, maxiter, hi_lo=True, fixed=False,
                    block_rows=None, group=False):
    """Launch ``csrc/lasso_fista_tma.cu`` ('high'): f32 operands, and for
    ``group`` the complex mode with gram as ``pair_gram`` (F / 2, F). One
    persistent block per SM (at most one per ``rows`` rows)."""
    rows = check_solve_rows_args(yah, gram, x0, z0, t0, done0, nit0, maxiter,
                                 block_rows, pairs=group, momentum=momentum,
                                 hi_lo=hi_lo)
    m, f = yah.shape
    dev = yah.device
    fn = _c_function("lasso_fista_tma", "lasso_solve_rows_tma_launch",
                     (_I,) * 6 + (_P,) * 9 + (_F,) + (_I,) * 3 + (_P,) * 8)
    with torch.cuda.device(dev):
        step = _feature_vector(stepsz, f, dev)
        thr = _feature_vector(thresh, f, dev)
        # Real: the kernel reads B(k, n) = gram[k, n] from rows of gram^T;
        # complex: rows of the pair Gram.
        gimg = tile_images(gram if group else gram.T, group)
        t0c, d0c, n0c = _row_state(t0, done0, nit0, m)
        x0c, z0c, yahc = x0.contiguous(), z0.contiguous(), yah.contiguous()
        x, z, t, done, nit = _outputs(m, f, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(sms, -(-m // rows))
        queue = torch.zeros(1, dtype=torch.int32, device=dev)
        slot_iters = torch.empty(blocks, dtype=torch.int64, device=dev)
        _launch("solve_rows", fn, dev, int(momentum), int(restart),
                int(fixed), int(group), rows, blocks, yahc.data_ptr(),
                gimg.data_ptr(), x0c.data_ptr(),
                z0c.data_ptr(), t0c.data_ptr(), d0c.data_ptr(),
                n0c.data_ptr(), step.data_ptr(), thr.data_ptr(), float(tol),
                m, f, int(maxiter), x.data_ptr(), z.data_ptr(), t.data_ptr(),
                done.data_ptr(), nit.data_ptr(), queue.data_ptr(),
                slot_iters.data_ptr())
    solve_rows.launches += 1
    solve_rows.tma_launches += 1
    solve_rows.complex_launches += int(bool(group))
    solve_rows.slot_iters = slot_iters
    return x, z, t, done, nit


def _solve_rows_wide(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh,
                     tol, *, momentum, restart, maxiter, hi_lo=True,
                     fixed=False, block_rows=None, group=False):
    """Launch ``csrc/lasso_fista_wide.cu`` (either precision): f32 operands,
    and for ``group`` the complex mode with gram as ``pair_gram`` (F / 2,
    F). One cluster of ceil(F / 512) blocks per 16 rows, at most as many
    clusters as the card's SMs hold; counted in ``solve_rows.launches``
    and ``.wide_launches``. Its C entry takes any 1 <= F <= 1,536, so that
    the route can be timed against the narrow kernels at F <= 1,024."""
    check_solve_rows_args(yah, gram, x0, z0, t0, done0, nit0, maxiter,
                          block_rows, pairs=group, momentum=momentum,
                          hi_lo=hi_lo)
    m, f = yah.shape
    dev = yah.device
    fn = _c_function("lasso_fista_wide", "lasso_solve_rows_wide_launch",
                     (_I,) * 6 + (_P,) * 9 + (_F,) + (_I,) * 3 + (_P,) * 8)
    with torch.cuda.device(dev):
        step = _feature_vector(stepsz, f, dev)
        thr = _feature_vector(thresh, f, dev)
        limbs = 2 if hi_lo else 3
        gimg = tile_images(gram if group else gram.T, group, limbs)
        t0c, d0c, n0c = _row_state(t0, done0, nit0, m)
        x0c, z0c, yahc = x0.contiguous(), z0.contiguous(), yah.contiguous()
        x, z, t, done, nit = _outputs(m, f, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clusters = min(sms // -(-f // _TILE_COLS), -(-m // 16))
        queue = torch.zeros(1, dtype=torch.int32, device=dev)
        slot_iters = torch.zeros(clusters, dtype=torch.int64, device=dev)
        _launch("solve_rows (wide)", fn, dev, limbs, int(momentum),
                int(restart), int(fixed), int(group), clusters,
                yahc.data_ptr(), gimg.data_ptr(), x0c.data_ptr(),
                z0c.data_ptr(), t0c.data_ptr(), d0c.data_ptr(),
                n0c.data_ptr(), step.data_ptr(), thr.data_ptr(), float(tol),
                m, f, int(maxiter), x.data_ptr(), z.data_ptr(), t.data_ptr(),
                done.data_ptr(), nit.data_ptr(), queue.data_ptr(),
                slot_iters.data_ptr())
    solve_rows.launches += 1
    solve_rows.wide_launches += 1
    solve_rows.complex_launches += int(bool(group))
    solve_rows.slot_iters = slot_iters
    return x, z, t, done, nit


def _solve_rows_mma(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol,
                    *, momentum, restart, maxiter, hi_lo=True, fixed=False,
                    block_rows=None, group=False):
    """Launch ``csrc/lasso_fista.cu`` at either precision, on f32 operands
    (``group``: the complex mode on the embedded Gram) or on complex64
    ones. ``solve_rows`` takes it for 'highest'; its 'high' path is the
    reference that ``chip_smoke.py`` holds ``csrc/lasso_fista_tma.cu``
    against bit for bit and times in turns with it. Counts nothing."""
    kw = dict(momentum=momentum, restart=restart, maxiter=maxiter,
              hi_lo=hi_lo, fixed=fixed, block_rows=block_rows)
    if yah.is_complex():
        return _complex_call(_solve_rows_mma, yah, gram, x0, z0, t0, done0,
                             nit0, stepsz, thresh, tol, **kw)
    rows = check_solve_rows_args(yah, gram, x0, z0, t0, done0, nit0, maxiter,
                                 block_rows, momentum=momentum, hi_lo=hi_lo,
                                 group=group)
    m, f = yah.shape
    dev = yah.device
    fn = _c_function("lasso_fista", "lasso_solve_rows_launch",
                     (_I,) * 6 + (_P,) * 10 + (_F,) + (_I,) * 3 + (_P,) * 6)
    with torch.cuda.device(dev):
        step = _feature_vector(stepsz, f, dev)
        thr = _feature_vector(thresh, f, dev)
        if hi_lo:
            # The kernel reads B(k, n) = gram[k, n] from rows of gram^T.
            g0, g1 = (h.contiguous() for h in split_hi_lo(gram.T))
        else:
            g0, g1 = gram.contiguous(), gram
        t0c, d0c, n0c = _row_state(t0, done0, nit0, m)
        x0c, z0c, yahc = x0.contiguous(), z0.contiguous(), yah.contiguous()
        x, z, t, done, nit = _outputs(m, f, dev)
        _launch("solve_rows", fn, dev, int(hi_lo), int(momentum),
                int(restart), int(fixed), int(group), rows, yahc.data_ptr(),
                g0.data_ptr(), g1.data_ptr(), x0c.data_ptr(), z0c.data_ptr(),
                t0c.data_ptr(), d0c.data_ptr(), n0c.data_ptr(),
                step.data_ptr(), thr.data_ptr(), float(tol), m, f,
                int(maxiter), x.data_ptr(), z.data_ptr(), t.data_ptr(),
                done.data_ptr(), nit.data_ptr())
    return x, z, t, done, nit


def masked_grad_rows_plain(my, mask, x, a, *, block_rows=None):
    """``masked_grad_rows``' plain twin (``_grad_rows_kernel``,
    ``pallas_lasso.py:144``), in row chunks of ``block_rows``. As in the TPU
    kernel, the products' sums and the residual are f32 even for f64
    data."""
    cdt, wdt, f32 = my.dtype, _work_dtype(my.dtype), torch.float32
    aw = a.to(wdt)
    g = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = block_rows or _GRAD_CHUNK_ROWS
    for s in range(0, my.shape[0], rows):
        sl = slice(s, s + rows)
        recon = (x[sl].to(cdt).to(wdt) @ aw).to(f32)
        resid = (mask[sl].to(f32) * recon - my[sl].to(f32)).to(a.dtype)
        g[sl] = (resid.to(wdt) @ aw.T).to(f32).to(x.dtype)
    return g


def grad_fits(n: int, f: int, itemsize: int) -> bool:
    """Whether the masked-gradient kernels take F features (or K atoms) at
    N columns of ``itemsize``-byte data: the TPU kernels' gate
    (``pallas_lasso.fits_vmem`` after ``kernel_alignment``'s padding), the
    port's own copy, ``f_pad n_pad itemsize 2 < 10 MiB`` with F and N
    rounded up to 128."""
    f_pad, n_pad = -(-f // 128) * 128, -(-n // 128) * 128
    return f_pad * n_pad * itemsize * 2 < GRAD_GATE_BYTES


def grad_route(f: int) -> str:
    """Which kernel the masked gradients launch for F features (K atoms):
    ``'fused'`` (``csrc/lasso_grad_packed.cu``, ``csrc/grad_dict_packed.cu``)
    for F <= ``GRAD_MAX_FEATURES``, ``'wide'`` (``csrc/grad_wide.cu``) above.
    A function of F alone: no shape moves to another route on a failure."""
    return "fused" if f <= GRAD_MAX_FEATURES else "wide"


def grad_width(f: int) -> int:
    """The width of an operand's limbs at F features (``grad_limbs``,
    ``cuda_mu.column_limbs``): the fused kernels' tile (``grad_tile``: 64
    or 128), or on the wide route F rounded up to 128."""
    return grad_tile(f) if grad_route(f) == "fused" else -(-f // 128) * 128


def check_grad_width(n: int, f: int, dtype):
    """Refuse F (or K) below 1, or on the wide route (``grad_route``)
    outside the gate (``grad_fits``) at N columns of ``dtype`` data. The
    fused route takes 1 <= F <= ``GRAD_MAX_FEATURES`` at any N."""
    if f < 1 or (grad_route(f) == "wide"
                 and not grad_fits(n, f, dtype.itemsize)):
        raise ShapeError(
            f"the masked-gradient kernels take F (or K) from 1 to "
            f"{GRAD_MAX_FEATURES} at any N, and above it where the padded "
            f"working set f_pad n_pad itemsize 2 is below 10 MiB (the TPU "
            f"kernels' gate, grad_fits: F and N rounded up to 128; up to "
            f"1,152 f32 or 2,432 bf16 features at N = 1,024), got F={f}, "
            f"N={n}, {dtype}")


def _check_grad_tensors(my, mask, x, a, first):
    """The checks of a dense (weighted) mask's launches: devices, 2-D
    shapes, one dtype (bf16 or f32), fitting shapes, and F: 1 .. 128 for
    the first designs (``first``), else ``check_grad_width``'s."""
    named = (("my", my), ("mask", mask), ("x", x), ("a", a))
    for name, t in named:
        if t.device != my.device:
            raise DecompError(f"{name} is on {t.device}, my on {my.device}")
        if t.dim() != 2:
            raise ShapeError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype != my.dtype:
            raise DtypeError(f"{name} must have my's dtype {my.dtype}, got "
                             f"{t.dtype}")
    if my.dtype not in (torch.bfloat16, torch.float32):
        raise DtypeError(f"the kernel takes bf16 or f32 data, got {my.dtype}")
    m, n = my.shape
    f = a.shape[0]
    if mask.shape != my.shape or x.shape != (m, f) or a.shape != (f, n):
        raise ShapeError(f"mask {tuple(mask.shape)}, x {tuple(x.shape)} and "
                         f"a {tuple(a.shape)} do not fit my {tuple(my.shape)}")
    if first and not 1 <= f <= GRAD_MAX_FEATURES:
        raise ShapeError(f"the first design of the masked-gradient kernel "
                         f"takes 1 <= F <= {GRAD_MAX_FEATURES} features, got "
                         f"{f}")
    check_grad_width(n, f, my.dtype)
    if max(m, n) >= 2 ** 31:
        raise ShapeError(f"my's sides must be < 2^31, got {tuple(my.shape)}")


def check_masked_grad_args(my, mask, x, a):
    """Refuse what the first designs of the dense-mask gradients
    (``csrc/lasso_grad.cu``, ``csrc/mu_kl_stats.cu``'s GRAD_DICT, on no
    route) do not take, before any launch: F above 128 among it."""
    _check_grad_tensors(my, mask, x, a, first=True)


def check_weighted_grad_args(my, w, x, a):
    """Refuse what the weighted routes (the fused kernels' weighted
    instances, ``csrc/grad_wide.cu``) do not take, before any launch: F
    (or K) that ``check_grad_width`` refuses among it."""
    _check_grad_tensors(my, w, x, a, first=False)


def masked_grad_rows(my, mask, x, a, *, a_limbs=None):
    """The masked lasso gradient ``(mask * (x a) - my) a^T`` (M, F) in x's
    dtype; ``my`` is the pre-masked data ``mask * y`` (M, N), ``x`` (M, F),
    ``a`` (F, N). The M x N reconstruction never reaches device memory.

    ``mask`` is dense, in my's shape and dtype (a weighted mask), or the
    bits of a 0/1 mask from ``cuda_mu.pack_mask`` (int32). On a CUDA tensor
    (f32 or bf16 data) F <= 128 launches ``csrc/lasso_grad_packed.cu``, its
    instance by the dtype and the mask's form: a packed mask counts in
    ``.packed_launches``, a dense one (the weights streamed beside my) in
    ``.dense_launches``; F above 128, up to the gate (``grad_fits``),
    launches ``csrc/grad_wide.cu`` on either form, counted in
    ``.wide_launches``; ``.launches`` counts all three. All read a as
    ``a_limbs``, ``grad_limbs(a)`` made once by a caller that keeps a for
    many calls, or here when None. On a CPU tensor a packed mask is
    unpacked to my's dtype for the twin, which then gives the dense mask's
    bits, and ``a_limbs`` is not read."""
    packed = mask.dtype == torch.int32
    if packed:
        cuda_mu._check_packed(my, mask)
    if _runs_plain(my):
        if packed:
            mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
        return masked_grad_rows_plain(my, mask, x, a)
    if grad_route(a.shape[0]) == "wide":
        g = _grad_wide_rows_launch(my, mask, x, a, a_limbs)
        masked_grad_rows.wide_launches += 1
    elif packed:
        g = _grad_packed_launch(my, mask, x, a, a_limbs)
        masked_grad_rows.packed_launches += 1
    else:
        g = _grad_weighted_launch(my, mask, x, a, a_limbs)
        masked_grad_rows.dense_launches += 1
    masked_grad_rows.launches += 1
    return g


masked_grad_rows.launches = 0
masked_grad_rows.packed_launches = 0
masked_grad_rows.dense_launches = 0
masked_grad_rows.wide_launches = 0


def grad_takes_packed(my):
    """Whether ``masked_grad_rows`` and ``cuda_dl.masked_grad_dict`` run
    ``my`` with a packed mask: f32 or bf16 data on the card
    (``csrc/lasso_grad_packed.cu``, ``csrc/grad_dict_packed.cu``), any data
    on the CPU (the twin)."""
    return (my.dtype in (torch.float32, torch.bfloat16)
            or my.device.type == "cpu")


# The bf16 limbs of an operand in the packed and wide gradient kernels.
grad_limb_count = cuda_mu.limb_count


def grad_tile(f: int) -> int:
    """The fused kernels' feature tile at F features: 64 or 128; F
    outside 1 .. ``GRAD_MAX_FEATURES`` (the wide route's, ``grad_route``)
    is refused."""
    if not 1 <= f <= GRAD_MAX_FEATURES:
        raise ShapeError(f"the fused masked-gradient kernels take 1 <= F <= "
                         f"{GRAD_MAX_FEATURES} features, got {f} (wider F: "
                         "the wide route, grad_route)")
    return 64 if f <= 64 else 128


def grad_limbs(a):
    """a (F, N) as the masked-gradient kernels read it: (N, L W) bf16 with
    W = ``grad_width(F)`` (the fused tile, 64 or 128, or F rounded up to
    128 on the wide route) and L = ``grad_limb_count(a.dtype)``, row n =
    [limb 0 of a[:, n] | limb 1 | limb 2] in ``cuda_mu.split_bf16x3``'s
    round-to-nearest limbs, or for bf16 a (one limb) a[:, n] itself, each
    zero past F. A solve makes it once for its fixed a
    (``cuda_mu.column_limbs``). F that ``check_grad_width`` refuses is
    refused."""
    f, n = a.shape
    check_grad_width(n, f, a.dtype)
    return cuda_mu.column_limbs(a, grad_width(f), grad_limb_count(a.dtype))


def check_packed_grad_args(my, packed, x, a, a_limbs=None):
    """Refuse what the packed routes (``csrc/lasso_grad_packed.cu``,
    ``csrc/grad_dict_packed.cu`` and ``csrc/grad_wide.cu``) do not take,
    before any launch: a packed mask of another shape or device, data other
    than all f32 or all bf16 (mixed dtypes, f64), F (or K) that
    ``check_grad_width`` refuses, ``a_limbs`` other than ``grad_limbs(a)``'s
    shape."""
    cuda_mu._check_packed(my, packed)
    if my.dtype not in (torch.float32, torch.bfloat16):
        raise DtypeError(f"the packed-mask gradient kernels take f32 or "
                         f"bf16 data, got my {my.dtype}")
    for name, t in (("my", my), ("x", x), ("a", a)):
        if t.device != my.device:
            raise DecompError(f"{name} is on {t.device}, my on {my.device}")
        if t.dim() != 2:
            raise ShapeError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype != my.dtype:
            raise DtypeError(f"the packed-mask gradient kernels take all-f32 "
                             f"or all-bf16 data: my is {my.dtype}, {name} "
                             f"{t.dtype}")
    m, n = my.shape
    f = a.shape[0]
    if x.shape != (m, f) or a.shape != (f, n):
        raise ShapeError(f"x {tuple(x.shape)} and a {tuple(a.shape)} do not "
                         f"fit my {tuple(my.shape)}")
    check_grad_width(n, f, my.dtype)
    if max(m, n) >= 2 ** 31:
        raise ShapeError(f"my's sides must be < 2^31, got {tuple(my.shape)}")
    _check_a_limbs(my, a, a_limbs)


def _check_a_limbs(my, a, a_limbs):
    """``a_limbs``, where given, must have ``grad_limbs(a)``'s layout."""
    want = (my.shape[1], grad_limb_count(my.dtype) * grad_width(a.shape[0]))
    if a_limbs is not None and (
            a_limbs.dtype != torch.bfloat16 or a_limbs.device != my.device
            or tuple(a_limbs.shape) != want or not a_limbs.is_contiguous()):
        raise ShapeError(f"a_limbs must be grad_limbs(a): contiguous bf16 "
                         f"{want} on {my.device}, got {a_limbs.dtype} "
                         f"{tuple(a_limbs.shape)} on {a_limbs.device}")


def _grad_packed_launch(my, packed, x, a, a_limbs):
    """Launch ``csrc/lasso_grad_packed.cu`` on f32 or bf16 ``my`` and the
    packed mask (``masked_grad_rows``' packed route): the instance of
    ``grad_limb_count(my.dtype)`` limbs; g in the data's dtype."""
    check_packed_grad_args(my, packed, x, a, a_limbs)
    packed = packed.contiguous()
    if packed.data_ptr() % 16:
        packed = packed.clone()
    return _grad_rows_chain(my, x, a, a_limbs, "lasso_grad_packed_launch",
                            packed, packed.shape[1])


def _grad_weighted_launch(my, w, x, a, a_limbs):
    """Launch ``csrc/lasso_grad_packed.cu``'s weighted instance on f32 or
    bf16 ``my`` and the dense mask ``w`` in my's dtype (``masked_grad_rows``'
    dense route): the weights stream beside my, each with 16-byte-aligned
    rows; g in the data's dtype."""
    check_weighted_grad_args(my, w, x, a)
    _check_a_limbs(my, a, a_limbs)
    with torch.cuda.device(my.device):
        w_t, ld_w = cuda_mu._tma_rows(w.contiguous())
        return _grad_rows_chain(my, x, a, a_limbs,
                                "lasso_grad_weighted_launch", w_t, ld_w)


def _grad_rows_chain(my, x, a, a_limbs, entry, mask, ld_mask):
    """Call ``csrc/lasso_grad_packed.cu``'s C entry ``entry`` with the mask
    (the bits, ``ld_mask`` words a row, or the weights, row stride
    ``ld_mask``) and ``a_limbs`` (``grad_limbs(a)`` where None); g (M, F)
    in the data's dtype."""
    m, n = my.shape
    f = a.shape[0]
    if a_limbs is None:
        a_limbs = grad_limbs(a)
    fn = _c_function("lasso_grad_packed", entry,
                     (_I, _I, _P, _I, _P, _I, _P, _P) + (_I,) * 3
                     + (_P,) * 2)
    with torch.cuda.device(my.device):
        my_t, ld_my = cuda_mu._tma_rows(my.contiguous())
        xc = x.contiguous()
        g = torch.empty((m, f), dtype=my.dtype, device=my.device)
        _launch(f"masked_grad_rows ({entry})", fn, my.device,
                grad_limb_count(my.dtype), grad_tile(f), my_t.data_ptr(),
                ld_my, mask.data_ptr(), ld_mask, xc.data_ptr(),
                a_limbs.data_ptr(), m, n, f, g.data_ptr())
    return g


def check_wide_args(my, mask, x, a, a_limbs=None):
    """The checks of ``csrc/grad_wide.cu``'s launches (F or K on the wide
    route): a packed mask's, or a weighted one's."""
    if mask.dtype == torch.int32:
        check_packed_grad_args(my, mask, x, a, a_limbs)
    else:
        check_weighted_grad_args(my, mask, x, a)
        _check_a_limbs(my, a, a_limbs)


def wide_operands(my, mask, x):
    """What ``csrc/grad_wide.cu`` reads beside b's limbs, on my's device:
    (my, ld_my, the mask (the bits, or the weights with 16-byte-aligned
    rows), its row stride, weighted (0 / 1), x (f32 contiguous; bf16 with
    16-byte-aligned rows), ld_x, x's limbs' scratch (f32: (M, 3 Kp) bf16,
    else None), E's scratch (M, ld_my) in my's dtype)."""
    m, k = x.shape
    my_t, ld_my = cuda_mu._tma_rows(my.contiguous())
    if mask.dtype == torch.int32:
        mask_t = mask.contiguous()
        if mask_t.data_ptr() % 16:
            mask_t = mask_t.clone()
        ld_mask, weighted = mask_t.shape[1], 0
    else:
        (mask_t, ld_mask), weighted = cuda_mu._tma_rows(mask.contiguous()), 1
    if my.dtype == torch.float32:
        x_t, ld_x = x.contiguous(), k
        xl = torch.empty((m, 3 * grad_width(k)), dtype=torch.bfloat16,
                         device=my.device)
    else:
        (x_t, ld_x), xl = cuda_mu._tma_rows(x.contiguous()), None
    e = torch.empty((m, ld_my), dtype=my.dtype, device=my.device)
    return my_t, ld_my, mask_t, ld_mask, weighted, x_t, ld_x, xl, e


def _grad_wide_rows_launch(my, mask, x, a, a_limbs):
    """Launch ``csrc/grad_wide.cu``'s rows gradient (``masked_grad_rows``'
    wide route) on f32 or bf16 ``my`` with the packed mask or the weights:
    x's limbs (f32), E, then g = E a^T; g (M, F) in the data's dtype."""
    check_wide_args(my, mask, x, a, a_limbs)
    m, n = my.shape
    f = a.shape[0]
    if a_limbs is None:
        a_limbs = grad_limbs(a)
    fn = _c_function("grad_wide", "grad_wide_rows_launch",
                     (_I, _I, _P, _I, _P, _I, _P, _I, _P) + (_I,) * 4
                     + (_P, _P, _I, _P, _P))
    with torch.cuda.device(my.device):
        my_t, ld_my, mask_t, ld_mask, weighted, x_t, ld_x, xl, e = \
            wide_operands(my, mask, x)
        g = torch.empty((m, f), dtype=my.dtype, device=my.device)
        _launch("masked_grad_rows (grad_wide_rows_launch)", fn, my.device,
                grad_limb_count(my.dtype), weighted, my_t.data_ptr(), ld_my,
                mask_t.data_ptr(), ld_mask, x_t.data_ptr(), ld_x,
                a_limbs.data_ptr(), m, n, f, grad_width(f),
                0 if xl is None else xl.data_ptr(), e.data_ptr(), ld_my,
                g.data_ptr())
    return g


def _grad_dense_mma_launch(my, mask, x, a):
    """Launch ``csrc/lasso_grad.cu``, the first design of the dense-mask
    gradient, on no route of ``masked_grad_rows``: kept to be timed beside
    the weighted instance. Counts nothing."""
    check_masked_grad_args(my, mask, x, a)
    m, n = my.shape
    f = a.shape[0]
    fn = _c_function("lasso_grad", "masked_grad_rows_launch",
                     (_I,) + (_P,) * 4 + (_I,) * 3 + (_P,) * 2)
    with torch.cuda.device(my.device):
        myc, maskc, xc, ac = (t.contiguous() for t in (my, mask, x, a))
        g = torch.empty((m, f), dtype=x.dtype, device=my.device)
        _launch("masked_grad_rows", fn, my.device,
                int(my.dtype == torch.bfloat16), myc.data_ptr(),
                maskc.data_ptr(), xc.data_ptr(), ac.data_ptr(), m, n, f,
                g.data_ptr())
    return g
