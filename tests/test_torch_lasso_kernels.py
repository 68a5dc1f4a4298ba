"""The lasso slice's building blocks in the PyTorch port against
``decomp_tpu``: soft-thresholding, the spectral-norm estimate, the bf16x3
split, and the two kernels' plain twins (``ops.cuda_lasso``) against the
Pallas kernels in interpret mode. The same numpy inputs, made from a seed,
go through both packages. The CUDA kernels themselves run only on the
card (``chip_smoke.py``); here a CPU tensor runs each wrapper's twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decomp_tpu.ops import pallas_fista, pallas_lasso
from decomp_tpu.ops import spectral as jspec
from decomp_tpu.ops.soft_threshold import soft_threshold as j_soft
from decomp_tpu_torch.ops import cuda_lasso
from decomp_tpu_torch.ops import spectral as tspec
from decomp_tpu_torch.ops.soft_threshold import soft_threshold as t_soft
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err


def _t(a):
    return torch.from_numpy(np.array(a))


def _randn(rng, shape, complex_, dtype):
    z = rng.normal(size=shape)
    if complex_:
        z = z + 1j * rng.normal(size=shape)
    return z.astype(dtype)


# f64 agrees to rounding (1e-12); f32 to 1e-6 (last-bit differences of
# torch's and XLA's elementwise code and of the power iteration's sums).
_TOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-6,
        np.complex64: 1e-6}


@pytest.mark.parametrize("dtype", list(_TOL))
def test_soft_threshold_matches_jax(dtype):
    rng = np.random.default_rng(1)
    complex_ = np.iscomplexobj(np.zeros(1, dtype))
    x = _randn(rng, (7, 9), complex_, dtype)
    x[0, :3] = 0
    for thresh in (0.3, np.abs(rng.normal(size=(9,))).astype(
            np.float64 if dtype in (np.float64, np.complex128)
            else np.float32)):
        ref = np.asarray(j_soft(jnp.asarray(x), thresh))
        got = t_soft(_t(x), _t(thresh) if np.ndim(thresh)
                     else thresh).numpy()
        assert got.dtype == ref.dtype
        assert rel_err(got, ref) <= _TOL[dtype]
        assert np.all(got[0, :3] == 0)


@pytest.mark.parametrize("method", ["power", "eigh"])
@pytest.mark.parametrize("dtype", list(_TOL))
def test_spectral_norm_and_lipschitz_match_jax(method, dtype):
    rng = np.random.default_rng(2)
    complex_ = np.iscomplexobj(np.zeros(1, dtype))
    for f, n in ((40, 60), (5, 3)):
        a = _randn(rng, (f, n), complex_, dtype)
        gram = a @ a.conj().T
        ref = float(jspec.spectral_norm_psd(jnp.asarray(gram),
                                            method=method))
        got = tspec.spectral_norm_psd(_t(gram), method=method)
        assert not got.dtype.is_complex
        assert abs(float(got) - ref) <= _TOL[dtype] * ref
        lip = float(tspec.lipschitz_gram(_t(a), method=method))
        ref = float(jspec.lipschitz_gram(jnp.asarray(a), method=method))
        assert abs(lip - ref) <= _TOL[dtype] * ref


def test_spectral_norm_zero_gram_and_unknown_method():
    got = tspec.spectral_norm_psd(torch.zeros((4, 4), dtype=torch.float64))
    assert float(got) == torch.finfo(torch.float64).tiny
    with pytest.raises(ValueError):
        tspec.spectral_norm_psd(torch.eye(3), method="bogus")


def test_hi_lo_split_is_the_truncated_bf16x3_split():
    """hi is the f32 value with its low 16 bits cleared (not a bf16
    rounding), lo the bf16 rounding of the rest: the bits of
    ``pallas_fista._bitmask_split``."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(64, 64)).astype(np.float32)
    hi, lo = cuda_lasso.split_hi_lo(_t(g))
    jhi, jlo = pallas_fista._bitmask_split(jnp.asarray(g))
    np.testing.assert_array_equal(hi.float().numpy(),
                                  np.asarray(jhi).astype(np.float32))
    np.testing.assert_array_equal(lo.float().numpy(),
                                  np.asarray(jlo).astype(np.float32))
    bits = hi.float().numpy().view(np.uint32)
    assert np.all(bits & 0xFFFF == 0)
    rounded = _t(g).to(torch.bfloat16).float().numpy()
    assert np.any(rounded != hi.float().numpy())  # truncation, not rounding


def _grad_inputs(seed, m, n, f):
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    my = (rng.normal(size=(m, n)) * mask).astype(np.float32)
    x = rng.normal(size=(m, f)).astype(np.float32)
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    return my, mask, x, a


def _pad(v, rows, cols):
    return np.pad(v, ((0, rows - v.shape[0]), (0, cols - v.shape[1])))


# f32: 1e-5 relative, as tests/test_pallas.py:161 holds the TPU kernel to
# the composition. bf16: the residual is rounded to bf16 before the second
# product, and a one-ulp f32 difference of x a flips a rounding, so the
# limit is 1e-3 (measured: <= 2e-4 at these shapes).
@pytest.mark.parametrize("m,n,f", [(64, 128, 128), (50, 100, 20),
                                   (130, 257, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_grad_twin_matches_pallas(m, n, f, dtype):
    my, mask, x, a = _grad_inputs(m + n + f, m, n, f)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    mp, np_, fp = -(-m // 8) * 8, -(-n // 128) * 128, -(-f // 128) * 128
    ref = pallas_lasso.masked_grad_rows(
        *(jnp.asarray(_pad(v, r, c), jdt) for v, r, c in
          ((my, mp, np_), (mask, mp, np_), (x, mp, fp), (a, fp, np_))),
        block_rows=8, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))[:m, :f]
    before = cuda_lasso.masked_grad_rows.launches
    got = cuda_lasso.masked_grad_rows(*(_t(v).to(tdt)
                                        for v in (my, mask, x, a)))
    assert cuda_lasso.masked_grad_rows.launches == before  # the twin ran
    assert got.dtype == tdt and got.shape == (m, f)
    limit = 1e-5 if dtype == "float32" else 1e-3
    assert rel_err(got.float().numpy(), ref) < limit


def test_masked_grad_twin_is_the_composition_in_f64():
    my, mask, x, a = (v.astype(np.float64)
                      for v in _grad_inputs(9, 40, 30, 12))
    got = cuda_lasso.masked_grad_rows_plain(_t(my), _t(mask), _t(x), _t(a),
                                            block_rows=16)
    ref = (mask * (x @ a) - my) @ a.T
    assert got.dtype == torch.float64
    # the TPU kernel's f32 sums and residual, kept for f64 data
    assert rel_err(got.numpy(), ref) < 1e-6


def _rows_problem(seed, m, f, n=96, vec=False):
    """yah, gram, start and step / threshold of a well-posed batch: the
    scalar step 1/L or parallel_cd's per-feature step theta / diag."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(f, n)) / np.sqrt(n)
    gram = (a @ a.T).astype(np.float32)
    xt = rng.normal(size=(m, f)) * (rng.random((m, f)) < 0.1)
    y = xt @ a + 0.01 * rng.normal(size=(m, n))
    yah = (y @ a.T).astype(np.float32)
    g64 = gram.astype(np.float64)
    if vec:
        d = np.diag(g64)
        theta = 1.0 / np.linalg.eigvalsh(g64 / np.sqrt(np.outer(d, d)))[-1]
        step = (theta / d).astype(np.float32)[None, :]
    else:
        step = np.float32(1.0 / (1.02 * np.linalg.eigvalsh(g64)[-1]))
    thresh = (np.float32(0.05) * step).astype(np.float32)
    x0 = (0.1 * rng.normal(size=(m, f))).astype(np.float32)
    t0 = np.ones((m, 1), np.float32)
    d0 = np.zeros((m, 1), np.float32)
    d0[5] = 1.0                       # one row resumes already done
    n0 = np.zeros((m, 1), np.float32)
    n0[5] = 9.0
    return yah, gram, x0, t0, d0, n0, step, thresh


_METHOD_FLAGS = {"ista": (False, False), "fista": (True, False),
                 "acc_ista": (True, True)}


def _both(m, f, method, vec, hi_lo, fixed, maxiter, tol, seed=5):
    """solve_rows' twin and the Pallas kernel (interpret mode, inputs
    zero-padded to its 128-feature alignment, padded rows done) on the
    same problem."""
    yah, gram, x0, t0, d0, n0, step, thr = _rows_problem(seed, m, f,
                                                         vec=vec)
    momentum, restart = _METHOD_FLAGS[method]
    kw = dict(momentum=momentum, restart=restart, maxiter=maxiter,
              hi_lo=hi_lo, fixed=fixed)
    mp, fp = -(-m // 16) * 16, -(-f // 128) * 128
    pad_vec = (lambda v: _pad(v, 1, fp)) if vec else (lambda v: v)
    jx0 = _pad(x0, mp, fp)
    ref = pallas_fista.solve_rows(
        _pad(yah, mp, fp), _pad(gram, fp, fp), jx0, jx0,
        np.pad(t0, ((0, mp - m), (0, 0)), constant_values=1.0),
        np.pad(d0, ((0, mp - m), (0, 0)), constant_values=1.0),
        _pad(n0, mp, 1), pad_vec(step), pad_vec(thr), tol,
        block_rows=16, interpret=True, **kw)
    ref = [np.asarray(r)[:m, :f] for r in ref]
    got = cuda_lasso.solve_rows(
        _t(yah), _t(gram), _t(x0), _t(x0), _t(t0), _t(d0), _t(n0),
        _t(step) if vec else float(step), _t(thr) if vec else float(thr),
        tol, **kw)
    return [g.numpy() for g in got], ref


# Exact mode: the products are summed in another order, so a row whose
# relative change hovers near tol may stop some iterations apart (FISTA is
# not monotone: measured 82 against 94 for one bf16x3 row). As
# tests/test_lasso.py:324-337 accepts for the padded TPU kernel: niter
# equal on >= 90% of rows and x within 1e-3; the rows whose niter agree
# within 1e-4 (measured <= 6.3e-6; all rows <= 4.3e-4).
_EXACT_CASES = [(64, 128, method, vec, hi_lo)
                for method in ("ista", "fista", "acc_ista")
                for vec in (False, True) for hi_lo in (False, True)]
_EXACT_CASES += [(50, 100, "fista", True, True), (50, 100, "fista", False,
                                                   False),
                 (50, 100, "acc_ista", False, True), (50, 100, "ista", True,
                                                      False)]


@pytest.mark.parametrize("m,f,method,vec,hi_lo", _EXACT_CASES)
def test_solve_rows_twin_matches_pallas(m, f, method, vec, hi_lo):
    got, ref = _both(m, f, method, vec, hi_lo, False, 200, 1e-4)
    assert got[0].shape == (m, f) and got[4].dtype == np.int32
    same = got[4][:, 0] == ref[4][:, 0]
    assert np.mean(same) >= 0.9
    assert rel_err(got[0][same], ref[0][same]) < 1e-4
    assert rel_err(got[0], ref[0]) < 1e-3
    assert got[4][5, 0] == 9 and np.array_equal(got[0][5], ref[0][5])
    assert np.sum(got[3]) > 1     # rows stopped on their own, not only row 5


# Fixed budget (tol <= 0): no row stops, so x and z to 1e-5 relative
# (measured <= 3e-6) and niter equal everywhere.
@pytest.mark.parametrize("hi_lo", [False, True])
@pytest.mark.parametrize("method,vec,maxiter", [
    ("ista", False, 0), ("fista", True, 7), ("acc_ista", False, 8),
    ("acc_ista", True, 37)])
def test_solve_rows_fixed_twin_matches_pallas(method, vec, maxiter, hi_lo):
    got, ref = _both(64, 128, method, vec, hi_lo, True, maxiter, 0.0)
    assert rel_err(got[0], ref[0]) < 1e-5
    assert rel_err(got[1], ref[1]) < 1e-5
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[3], ref[3])


@pytest.mark.parametrize("maxiter", [0, 7, 8, 37])
@pytest.mark.parametrize("hi_lo", [False, True])
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista"])
def test_solve_rows_twin_fixed_is_exact_mode_at_tol_zero(method, vec, hi_lo,
                                                        maxiter):
    yah, gram, x0, t0, d0, n0, step, thr = _rows_problem(7, 48, 40, vec=vec)
    momentum, restart = _METHOD_FLAGS[method]
    args = [_t(v) for v in (yah, gram, x0, x0, t0, d0, n0)]
    args += [_t(step), _t(thr)] if vec else [float(step), float(thr)]
    kw = dict(momentum=momentum, restart=restart, maxiter=maxiter,
              hi_lo=hi_lo)
    exact = cuda_lasso.solve_rows(*args, 0.0, **kw)
    fixed = cuda_lasso.solve_rows(*args, 0.0, fixed=True, **kw)
    for e, f_ in zip(exact, fixed):
        assert torch.equal(e, f_)
    assert torch.equal(exact[0][5], args[2][5])          # the done row
    assert torch.equal(exact[4][:, 0], torch.where(
        torch.arange(48) == 5, 9, maxiter).to(torch.int32))


def _complex_rows_problem(seed, m, fc, n=96, vec=False):
    """The complex counterpart of ``_rows_problem``: complex64 yah and
    Hermitian gram, a complex start, and the scalar step 1/L or
    parallel_cd's per-feature step theta / diag of the complex Gram."""
    rng = np.random.default_rng(seed)

    def cnormal(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    a = cnormal(fc, n) / np.sqrt(2 * n)
    gram = a @ a.conj().T
    xt = cnormal(m, fc) * (rng.random((m, fc)) < 0.1)
    y = xt @ a + 0.01 * cnormal(m, n)
    yah = (y @ a.conj().T).astype(np.complex64)
    if vec:
        d = gram.real.diagonal()
        theta = 1.0 / np.linalg.eigvalsh(gram / np.sqrt(np.outer(d, d)))[-1]
        step = (theta / d).astype(np.float32)
    else:
        step = np.float32(1.0 / (1.02 * np.linalg.eigvalsh(gram)[-1]))
    thresh = (np.float32(0.05) * step).astype(np.float32)
    x0 = (0.1 * cnormal(m, fc)).astype(np.complex64)
    t0 = np.ones((m, 1), np.float32)
    d0 = np.zeros((m, 1), np.float32)
    d0[5] = 1.0                       # one row resumes already done
    n0 = np.zeros((m, 1), np.float32)
    n0[5] = 9.0
    return yah, gram.astype(np.complex64), x0, t0, d0, n0, step, thresh


def _both_complex(m, fc, method, vec, hi_lo, fixed, maxiter, tol, seed=6):
    """solve_rows' complex mode on the twin, and the Pallas kernel's
    ``group_fc`` mode (interpret mode) on the same problem in its layout:
    [re | im] halves of 128-aligned Fc, the embedding [[Gre, Gim], [-Gim,
    Gre]], per-feature vectors repeated in both halves, padded rows done.
    Returns ((x, z, t, done, niter), the same from Pallas) with x, z
    complex."""
    yah, gram, x0, t0, d0, n0, step, thr = _complex_rows_problem(
        seed, m, fc, vec=vec)
    momentum, restart = _METHOD_FLAGS[method]
    kw = dict(momentum=momentum, restart=restart, maxiter=maxiter,
              hi_lo=hi_lo, fixed=fixed)
    mp, fp = -(-m // 16) * 16, -(-fc // 128) * 128

    def halves(v):
        return np.concatenate([_pad(v.real, mp, fp), _pad(v.imag, mp, fp)],
                              axis=1).astype(np.float32)

    gre, gim = _pad(gram.real, fp, fp), _pad(gram.imag, fp, fp)
    g2 = np.block([[gre, gim], [-gim, gre]]).astype(np.float32)
    feat = ((lambda v: np.tile(_pad(v[None, :], 1, fp), (1, 2))) if vec
            else (lambda v: v))
    ref = pallas_fista.solve_rows(
        halves(yah), g2, halves(x0), halves(x0),
        np.pad(t0, ((0, mp - m), (0, 0)), constant_values=1.0),
        np.pad(d0, ((0, mp - m), (0, 0)), constant_values=1.0),
        _pad(n0, mp, 1), feat(step), feat(thr), tol, block_rows=16,
        interpret=True, group_fc=fp, **kw)
    ref = [np.asarray(r)[:m] for r in ref]
    ref[0], ref[1] = (r[:, :fc] + 1j * r[:, fp:fp + fc] for r in ref[:2])
    got = cuda_lasso.solve_rows(
        _t(yah), _t(gram), _t(x0), _t(x0), _t(t0), _t(d0), _t(n0),
        _t(step) if vec else float(step), _t(thr) if vec else float(thr),
        tol, **kw)
    return [g.numpy() for g in got], ref


# Exact mode, complex: the criteria of the real case above (measured: niter
# equal on >= 95.8% of rows, those rows within 4.3e-6, all rows within
# 3.9e-5).
_COMPLEX_EXACT_CASES = [(48, 100, method, vec, hi_lo)
                        for method in ("ista", "fista", "acc_ista")
                        for vec in (False, True) for hi_lo in (False, True)]
_COMPLEX_EXACT_CASES += [(40, 37, "acc_ista", True, True),
                         (40, 37, "fista", False, False)]


@pytest.mark.parametrize("m,fc,method,vec,hi_lo", _COMPLEX_EXACT_CASES)
def test_solve_rows_complex_twin_matches_pallas(m, fc, method, vec, hi_lo):
    before = (cuda_lasso.solve_rows.launches,
              cuda_lasso.solve_rows.complex_launches)
    got, ref = _both_complex(m, fc, method, vec, hi_lo, False, 200, 1e-4)
    assert before == (cuda_lasso.solve_rows.launches,
                      cuda_lasso.solve_rows.complex_launches)  # the twin
    assert got[0].dtype == np.complex64 and got[0].shape == (m, fc)
    assert got[1].dtype == np.complex64 and got[4].dtype == np.int32
    same = got[4][:, 0] == ref[4][:, 0]
    assert np.mean(same) >= 0.9
    assert rel_err(got[0][same], ref[0][same]) < 1e-4
    assert rel_err(got[0], ref[0]) < 1e-3
    assert got[4][5, 0] == 9 and np.array_equal(got[0][5], ref[0][5])
    assert np.sum(got[3]) > 1


# Fixed budget, complex: x and z to 1e-5 (measured <= 3.2e-6), niter and
# the done row equal.
@pytest.mark.parametrize("hi_lo", [False, True])
@pytest.mark.parametrize("method,vec,maxiter", [
    ("ista", False, 0), ("fista", True, 7), ("acc_ista", False, 8),
    ("acc_ista", True, 37)])
def test_solve_rows_complex_fixed_twin_matches_pallas(method, vec, maxiter,
                                                      hi_lo):
    got, ref = _both_complex(48, 100, method, vec, hi_lo, True, maxiter, 0.0)
    assert rel_err(got[0], ref[0]) < 1e-5
    assert rel_err(got[1], ref[1]) < 1e-5
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[0][5], ref[0][5])   # the done row


@pytest.mark.parametrize("hi_lo", [False, True])
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista"])
def test_solve_rows_complex_twin_fixed_is_exact_mode_at_tol_zero(method,
                                                                 hi_lo):
    yah, gram, x0, t0, d0, n0, step, thr = _complex_rows_problem(
        8, 40, 30, vec=True)
    momentum, restart = _METHOD_FLAGS[method]
    args = [_t(v) for v in (yah, gram, x0, x0, t0, d0, n0, step, thr)]
    kw = dict(momentum=momentum, restart=restart, maxiter=11, hi_lo=hi_lo)
    exact = cuda_lasso.solve_rows(*args, 0.0, **kw)
    fixed = cuda_lasso.solve_rows(*args, 0.0, fixed=True, **kw)
    for e, f_ in zip(exact, fixed):
        assert torch.equal(e, f_)
    assert torch.equal(exact[0][5], args[2][5])          # the done row
    assert not torch.equal(exact[0][4], args[2][4])


def test_complex_layout_is_the_complex_product():
    """as_pairs views a complex row as [re, im, ...]; the embedded Gram
    multiplies pairs as the complex Gram multiplies rows, and is symmetric
    for a Hermitian Gram."""
    rng = np.random.default_rng(4)
    a = _randn(rng, (6, 9), True, np.complex128)
    gram = a @ a.conj().T
    gram = _t(((gram + gram.conj().T) / 2).astype(np.complex64))
    v = _t(_randn(rng, (5, 6), True, np.complex64))
    pairs = cuda_lasso.as_pairs(v)
    assert pairs.dtype == torch.float32 and pairs.shape == (5, 12)
    assert torch.equal(pairs[:, 0::2], v.real)
    assert torch.equal(pairs[:, 1::2], v.imag)
    assert torch.equal(cuda_lasso.from_pairs(pairs), v)
    emb = cuda_lasso.embed_gram(gram)
    assert emb.shape == (12, 12) and torch.equal(emb, emb.T)
    got = (pairs.double() @ emb.double()).numpy()
    ref = cuda_lasso.as_pairs(v.to(torch.complex128) @ gram.to(
        torch.complex128)).numpy()
    assert rel_err(got, ref) < 1e-12


def test_solve_rows_complex_refusals():
    m, fc = 4, 6
    c = torch.zeros((m, fc), dtype=torch.complex64)
    g = torch.zeros((fc, fc), dtype=torch.complex64)
    z = torch.zeros(m)
    kw = dict(momentum=False, restart=False, maxiter=1)
    with pytest.raises(texc.DtypeError, match="complex64"):
        cuda_lasso.solve_rows(c.to(torch.complex128), g.to(torch.complex128),
                              c, c, z, z, z, 1.0, 0.1, 0.0, **kw)
    with pytest.raises(texc.DtypeError, match="complex64 gram"):
        cuda_lasso.solve_rows(c, g.real, c, c, z, z, z, 1.0, 0.1, 0.0, **kw)
    with pytest.raises(texc.ShapeError, match="gram"):
        cuda_lasso.solve_rows(c, g[:5], c, c, z, z, z, 1.0, 0.1, 0.0, **kw)
    with pytest.raises(texc.ShapeError, match="entries"):
        cuda_lasso.solve_rows(c, g, c, c, z, z, z, torch.ones(5), 0.1, 0.0,
                              **kw)
    with pytest.raises(texc.ShapeError, match="even F"):
        cuda_lasso.solve_rows(z[:, None].expand(m, 7).contiguous(),
                              torch.zeros((7, 7)), torch.zeros((m, 7)),
                              torch.zeros((m, 7)), z, z, z, 1.0, 0.1, 0.0,
                              group=True, **kw)
    meta = c.to("meta")
    with pytest.raises(texc.DecompError, match="no kernel for device"):
        cuda_lasso.solve_rows(meta, g.to("meta"), meta, meta, z, z, z, 1.0,
                              0.1, 0.0, **kw)


def test_kernel_range_checks_need_no_card():
    """What the kernels refuse is refused before any launch, so the checks
    run on CPU tensors."""
    m = 4
    z = torch.zeros
    # Past the TPU kernel's gate (solve_fits): 1,408 features with
    # momentum, 1,536 without.
    for f, momentum, edge in ((1409, True, 1408), (1537, False, 1536),
                              (2048, True, 1408), (2048, False, 1536)):
        with pytest.raises(texc.ShapeError, match=f"1 <= F <= {edge}"):
            cuda_lasso.check_solve_rows_args(
                z((m, f)), z((f, f)), z((m, f)), z((m, f)), z(m), z(m), z(m),
                10, None, momentum=momentum)
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        cuda_lasso.check_solve_rows_args(
            z((m, 600)), z((600, 600)), z((m, 600)), z((m, 600)), z(m), z(m),
            z(m), 10, 32)
    with pytest.raises(texc.DtypeError):
        cuda_lasso.check_solve_rows_args(
            z((m, 8), dtype=torch.float64), z((8, 8)), z((m, 8)), z((m, 8)),
            z(m), z(m), z(m), 10, None)
    assert cuda_lasso.check_solve_rows_args(
        z((m, 600)), z((600, 600)), z((m, 600)), z((m, 600)), z(m), z(m),
        z(m), 10, None) == 16
    with pytest.raises(texc.ShapeError, match="1 <= F <= 128"):
        cuda_lasso.check_masked_grad_args(z((m, 8)), z((m, 8)), z((m, 129)),
                                          z((129, 8)))
    with pytest.raises(texc.DtypeError):
        cuda_lasso.check_masked_grad_args(
            z((m, 8), dtype=torch.float64), z((m, 8), dtype=torch.float64),
            z((m, 4), dtype=torch.float64), z((4, 8), dtype=torch.float64))
    with pytest.raises(texc.DtypeError):
        cuda_lasso.check_masked_grad_args(z((m, 8)), z((m, 8)),
                                          z((m, 4), dtype=torch.bfloat16),
                                          z((4, 8)))


def test_wrappers_refuse_other_devices():
    t = torch.zeros((4, 4), device="meta")
    with pytest.raises(texc.DecompError, match="no kernel for device"):
        cuda_lasso.masked_grad_rows(t, t, t, t)
    with pytest.raises(texc.DecompError, match="no kernel for device"):
        cuda_lasso.solve_rows(t, t, t, t, t[0], t[0], t[0], 1.0, 0.1, 0.0,
                              momentum=False, restart=False, maxiter=1)
