"""The bit-packed mask of masked KL-MU in the PyTorch port:
``kl_stats_masked``'s packed route (its twin on CPU) against the dense
route and against ``decomp_tpu``'s masked KL Pallas kernel in interpret
mode, the route ``nmf.solve(method='kl-mu')`` takes, and the bf16x6 limb
products of the packed kernel (``split_bf16x3``, and a plain emulation of
the products on log-normal data). The same numpy inputs, made from a seed,
go through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_masked import _heldout_problem, _masked_arrs, _problem
from test_torch_masked_packed import _RouteSpy
from test_torch_nmf import _t

# chip_smoke.py's limit for f32 kernels against their twin (LIMIT[f32]).
_F32_LIMIT = 2e-6


@pytest.mark.parametrize("dtype,m,n,k,block_rows", [
    (torch.float64, 8, 70, 6, None),
    (torch.float64, 33, 257, 7, 16),
    (torch.float32, 70, 45, 6, 16),
    (torch.float32, 72, 129, 1, 24),
    (torch.float32, 40, 31, 3, None),
    (torch.bfloat16, 70, 45, 6, None),
    (torch.bfloat16, 64, 33, 5, 8),
])
def test_packed_twin_is_the_dense_twin(dtype, m, n, k, block_rows):
    """On CPU the packed route unpacks to my's dtype for the twin, so it
    gives the dense mask's bits."""
    my, mask, x, d = (_t(a).to(dtype) for a in _masked_arrs(m, m, n, k))
    got = cuda_mu.kl_stats_masked(my, cuda_mu.pack_mask(mask), x, d, 1e-6,
                                  block_rows=block_rows)
    ref = cuda_mu.kl_stats_masked_plain(my, mask, x, d, 1e-6,
                                        block_rows=block_rows)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


# f64: the Pallas kernel forms the ratio, x_new and the statistics in f32
# even for f64 data (pallas_mu.py:341-367), and the twin mirrors those
# casts, so both agree to f32 summation order: 1e-6 relative, as
# test_torch_kl.py's dense-mask twin.
@pytest.mark.parametrize("m,jax_rows", [(64, 32), (72, 8)])
def test_packed_twin_matches_pallas_f64(m, jax_rows):
    my, mask, x, d = _masked_arrs(m + 3, m, 256, 128)
    sj = pallas_mu.kl_stats_masked(
        jnp.asarray(my), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(d),
        1e-15, block_rows=jax_rows, interpret=True)
    st = cuda_mu.kl_stats_masked(_t(my), cuda_mu.pack_mask(_t(mask)), _t(x),
                                 _t(d), 1e-15)
    for a, b in zip(st, sj):
        assert rel_err(a.numpy(), b) < 1e-6


@pytest.mark.parametrize("shape", [(20, 2), (19, 4), (20, 3), (20,)])
def test_wrapper_refuses_a_packed_mask_of_another_shape(shape):
    my, mask, x, d = (_t(a) for a in _masked_arrs(6, 20, 40, 4))
    assert cuda_mu.pack_mask(mask).shape == (20, 4)
    bad = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(texc.ShapeError):
        cuda_mu.kl_stats_masked(my, bad, x, d, 1e-6)


@pytest.mark.parametrize("dtype,device,want", [
    (torch.float32, "cpu", True),
    (torch.float64, "cpu", True),
    (torch.bfloat16, "cpu", True),
    (torch.float32, "meta", True),
    (torch.bfloat16, "meta", False),
])
def test_kl_takes_packed(dtype, device, want):
    """f32 data on a device with kernels (a meta tensor stands in for the
    card: only the dtype and device type are read), any data on the CPU."""
    my = torch.empty((3, 4), dtype=dtype, device=device)
    assert cuda_mu.kl_takes_packed(my) is want


def test_kl_packed_rows_are_a_function_of_the_shape():
    """Two waves of one block per SM (132 SMs) over 128-column N tiles, in
    whole 32-row stages; nothing but the shape goes in, so the summation
    order is fixed by the shape."""
    assert cuda_mu.kl_packed_block_rows(100_000, 1024) == 3040
    assert cuda_mu.kl_packed_block_rows(65536, 10112) == 16384
    for m, n in ((333, 257), (1, 1), (100_000, 1000), (10 ** 6, 64)):
        rows = cuda_mu.kl_packed_block_rows(m, n)
        assert rows % 32 == 0 and rows >= 32
        assert -(-m // rows) <= 2 * 132


@pytest.mark.parametrize("scale", [1.0, 1e-25, 3e30])
def test_split_bf16x3_gives_back_t(scale):
    """Three bf16 limbs, each the round-to-nearest bf16 of the residual
    left by the ones before it, whose f32 sum gives back t to within
    2^-24 |t| (where the limbs stay normal bf16 numbers, as at these
    scales)."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy((scale * np.exp(np.log(10) * rng.standard_normal(
        (50, 70))) * rng.choice([-1, 1], (50, 70))).astype(np.float32))
    limbs = cuda_mu.split_bf16x3(t)
    assert limbs.shape == (3, 50, 70) and limbs.dtype == torch.bfloat16
    l0, l1, l2 = (a.to(torch.float32) for a in limbs)
    assert torch.equal(limbs[0], t.to(torch.bfloat16))
    assert torch.equal(limbs[1], (t - l0).to(torch.bfloat16))
    assert torch.equal(limbs[2], (t - l0 - l1).to(torch.bfloat16))
    back = (l0.double() + l1.double() + l2.double())
    assert bool(((back - t.double()).abs()
                 <= 2.0 ** -24 * t.double().abs()).all())


def _limb_product(a, b, limbs, a_mask=False, b_mask=False):
    """a @ b as the limb products of a split into ``limbs`` bf16 limbs:
    every product a_i b_j with i + j < limbs, summed exactly (f64); a 0/1
    mask operand is one exact limb."""
    pa = [a.double()] if a_mask else [
        t.double() for t in cuda_mu.split_bf16x3(a)[:limbs]]
    pb = [b.double()] if b_mask else [
        t.double() for t in cuda_mu.split_bf16x3(b)[:limbs]]
    return sum(ai @ bj for i, ai in enumerate(pa) for j, bj in enumerate(pb)
               if i + j < limbs)


def _kl_chain(my, mask, x, d, eps, limbs=None):
    """The masked KL statistics (x_new, numd, dend) with each product as
    limb products (E and x_new stored in f32, as the kernel stores them),
    or all in f64 when ``limbs`` is None."""
    if limbs is None:
        def prod(a, b, **_):
            return a.double() @ b.double()

        def store(t):
            return t
    else:
        def prod(a, b, **kw):
            return _limb_product(a, b, limbs, **kw)

        def store(t):
            return t.to(torch.float32)
    e1 = store(my.double() / (prod(x, d) + eps))
    x_new = store(x.double() * prod(e1, d.T)
                  / (prod(mask, d.T, a_mask=True) + eps))
    e2 = store(my.double() / (prod(x_new, d) + eps))
    return (x_new, prod(x_new.T, e2),
            prod(x_new.T, mask, b_mask=True))


def test_bf16x6_keeps_f32_accuracy_where_bf16x3_does_not():
    """The packed kernel's products, emulated: on log-normal my, x and d
    (values over about six decades, as chip_smoke.py's phase 3c draws
    them) three limbs and six products (bf16x6) keep the KL chain within a
    tenth of the f32 limit of f64; two limbs and three products (bf16x3)
    break the limit, so phase 3c's data would catch that shortcut."""
    rng = np.random.default_rng(0)
    m, n, k, ln10 = 512, 384, 64, np.log(10.0)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    my = mask * np.exp(ln10 * rng.standard_normal((m, n)))
    x = np.exp(ln10 * rng.standard_normal((m, k)))
    d = np.exp(ln10 * rng.standard_normal((k, n)))
    args = [_t(a.astype(np.float32)) for a in (my, mask, x, d)]
    ref = _kl_chain(*args, 1e-6)
    six = [rel_err(a.numpy(), b.numpy())
           for a, b in zip(_kl_chain(*args, 1e-6, limbs=3), ref)]
    three = [rel_err(a.numpy(), b.numpy())
             for a, b in zip(_kl_chain(*args, 1e-6, limbs=2), ref)]
    assert max(six) < _F32_LIMIT / 10
    assert max(three) > _F32_LIMIT


def _jax_kernel_run(y, mask, x0, d0, **kw):
    return decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, method="kl-mu",
                                use_pallas=True, pallas_block_rows=16,
                                _pallas_interpret=True, **kw)


def test_solve_takes_the_packed_route_and_matches_pallas(monkeypatch):
    """A 0/1 mask is packed once per solve and every iteration takes the
    packed route; the result matches the KL Pallas kernel in interpret
    mode (f32, 15 fixed iterations: 1e-4, as test_torch_kl.py)."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = (a.astype(np.float32)
                       for a in _problem(seed=5, m=70, n=50, k=4))
    rj = _jax_kernel_run(y, mask, x0, d0, tol=0.0, maxiter=15)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                    maxiter=15, method="kl-mu", use_kernel=True,
                    kernel_block_rows=16, device="cpu")
    assert spy.packed == [True] and spy.unpacked == 15
    assert rt.niter == 15
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_solve_keeps_a_weighted_mask_dense(monkeypatch):
    """A weighted mask is refused by pack_mask and runs the dense route,
    as before: the same bits as the dense twin's iterations."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = (a.astype(np.float32)
                       for a in _problem(seed=6, m=40, n=30, k=3))
    mask = mask * np.where(np.arange(30) % 2, 0.5, 1.0).astype(np.float32)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                    maxiter=5, method="kl-mu", use_kernel=True, device="cpu")
    assert spy.packed == [False] and spy.unpacked == 0
    my = _t(mask) * _t(y)
    x, d = _t(x0), _t(d0)
    for _ in range(5):
        x, d = cuda_mu.kl_update_masked(my, _t(mask), x, d,
                                        float(np.float32(1e-15)))
    assert torch.equal(rt.x, x) and torch.equal(rt.d, d)


def test_heldout_solve_packs_the_training_mask(monkeypatch):
    """Under stop='heldout' the packed mask is the training mask (observed
    minus the validation reserve): with decomp_tpu's reserve passed in,
    the kernel path stops where the Pallas run in interpret mode stops,
    with a close validation error."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0, val = (a.astype(np.float32)
                            for a in _heldout_problem())
    kw = dict(tol=1e-3, maxiter=3000, check_every=25)
    rj = _jax_kernel_run(y, mask, x0, d0, stop="heldout", random_seed=21,
                         **kw)
    rt = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val), rank=4,
                     method="kl-mu", use_kernel=True, kernel_block_rows=16,
                     **kw)
    assert spy.packed == [True]
    assert rt.niter == int(rj.niter)
    assert bool(rj.converged) == rt.converged
    ej = float(np.asarray(rj.aux["heldout_rel_err"]))
    assert abs(float(rt.aux["heldout_rel_err"]) - ej) < 1e-4 * ej
    assert rel_err(rt.d.numpy(), rj.d) < 1e-3
