"""The bit-packed mask of the masked lasso gradient in the PyTorch port:
``masked_grad_rows``' packed route (its twin on CPU) against the dense
route and against ``decomp_tpu``'s Pallas kernel in interpret mode, its
refusals, the layout of a's limbs (``grad_limbs``), a plain emulation of
the packed kernel's bf16x6 products on log-normal data, the route that
``lasso.solve`` and masked dictionary learning take (one ``pack_mask`` per
solve), and ``use_kernel='auto'``'s f32 gate. The same numpy inputs, made
from a seed, go through both packages. The CUDA kernel itself runs only on
the card (``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.ops import pallas_lasso
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.models import lasso as tl
from decomp_tpu_torch.ops import cuda_lasso, cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_lasso, random_mask, rel_err
from test_torch_lasso_kernels import _grad_inputs, _pad
from test_torch_masked_packed import _RouteSpy

ALPHA = 0.05
# chip_smoke.py's limit for the f32 gradient kernels against their twin
# (GRAD_LIMIT[f32]).
_F32_LIMIT = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed_args(seed, m, n, f, dtype):
    my, mask, x, a = (_t(v).to(dtype) for v in _grad_inputs(seed, m, n, f))
    return my, mask, x, a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,f", [(37, 70, 1), (33, 257, 7), (9, 100, 64),
                                   (70, 129, 128), (5, 31, 65)])
def test_packed_twin_is_the_dense_twin(m, n, f, dtype):
    """On CPU the packed route unpacks to my's dtype for the twin, so it
    gives the dense mask's bits, and launches nothing."""
    my, mask, x, a = _packed_args(m + n + f, m, n, f, dtype)
    before = (cuda_lasso.masked_grad_rows.launches,
              cuda_lasso.masked_grad_rows.packed_launches)
    got = cuda_lasso.masked_grad_rows(my, cuda_mu.pack_mask(mask), x, a)
    ref = cuda_lasso.masked_grad_rows_plain(my, mask, x, a)
    assert got.dtype == ref.dtype == dtype and got.shape == (m, f)
    assert torch.equal(got, ref)
    assert torch.equal(cuda_lasso.masked_grad_rows(my, mask, x, a), ref)
    assert (cuda_lasso.masked_grad_rows.launches,
            cuda_lasso.masked_grad_rows.packed_launches) == before


# f32: 1e-5 relative, the limit test_torch_lasso_kernels.py holds the dense
# twin to the Pallas kernel (tests/test_pallas.py:161's for the TPU kernel
# against the composition).
@pytest.mark.parametrize("m,n,f", [(64, 128, 128), (50, 100, 20),
                                   (13, 257, 1)])
def test_packed_twin_matches_pallas(m, n, f):
    my, mask, x, a = _grad_inputs(2 * m + n + f, m, n, f)
    mp, np_, fp = -(-m // 8) * 8, -(-n // 128) * 128, -(-f // 128) * 128
    ref = pallas_lasso.masked_grad_rows(
        *(jnp.asarray(_pad(v, r, c), jnp.float32) for v, r, c in
          ((my, mp, np_), (mask, mp, np_), (x, mp, fp), (a, fp, np_))),
        block_rows=8, interpret=True)
    got = cuda_lasso.masked_grad_rows(_t(my), cuda_mu.pack_mask(_t(mask)),
                                      _t(x), _t(a))
    assert rel_err(got.numpy(), np.asarray(ref)[:m, :f]) < 1e-5


@pytest.mark.parametrize("shape", [(20, 2), (19, 4), (20, 3), (20,)])
def test_wrapper_refuses_a_packed_mask_of_another_shape(shape):
    my, mask, x, a = _packed_args(1, 20, 40, 4, torch.float32)
    assert cuda_mu.pack_mask(mask).shape == (20, 4)
    with pytest.raises(texc.ShapeError):
        cuda_lasso.masked_grad_rows(my, torch.zeros(shape, dtype=torch.int32),
                                    x, a)


def test_wrapper_refuses_a_packed_mask_on_another_device():
    my, mask, x, a = _packed_args(2, 20, 40, 4, torch.float32)
    bits = torch.zeros((20, 4), dtype=torch.int32, device="meta")
    with pytest.raises(texc.DecompError, match="packed mask is on meta"):
        cuda_lasso.masked_grad_rows(my, bits, x, a)


@pytest.mark.parametrize("change,error", [
    (dict(my=torch.bfloat16), texc.DtypeError),
    (dict(my=torch.float64), texc.DtypeError),
    (dict(x=torch.float64), texc.DtypeError),
    (dict(a=torch.bfloat16), texc.DtypeError),
    # just past the gate (grad_fits) at N = 40, f32
    (dict(f=10113), texc.ShapeError),
    (dict(x_rows=19), texc.ShapeError),
    (dict(limbs=(40, 3 * 128)), texc.ShapeError),
    (dict(limbs=(41, 3 * 64)), texc.ShapeError),
    (dict(limbs_dtype=torch.float32), texc.ShapeError),
])
def test_packed_kernel_refusals(change, error):
    """What the packed kernel does not take is refused before any launch
    (the card's checks, run here on CPU tensors): data other than f32,
    F past the gate, shapes that do not fit, a's limbs not in grad_limbs'
    shape."""
    f = change.get("f", 4)
    if f > 4:
        assert cuda_lasso.grad_fits(40, f - 1, 4)
        assert not cuda_lasso.grad_fits(40, f, 4)
    my, mask, x, a = _packed_args(3, 20, 40, f, torch.float32)
    my, x, a = (t.to(change.get(k, torch.float32))
                for k, t in (("my", my), ("x", x), ("a", a)))
    x = x[:change.get("x_rows", 20)]
    limbs = None
    if "limbs" in change or "limbs_dtype" in change:
        limbs = torch.zeros(change.get("limbs", (40, 3 * 64)),
                            dtype=change.get("limbs_dtype", torch.bfloat16))
    with pytest.raises(error):
        cuda_lasso.check_packed_grad_args(my, cuda_mu.pack_mask(mask), x, a,
                                          limbs)


@pytest.mark.parametrize("f", [1, 64, 65, 128])
def test_packed_kernel_takes_what_it_should(f):
    my, mask, x, a = _packed_args(4, 20, 40, f, torch.float32)
    bits = cuda_mu.pack_mask(mask)
    cuda_lasso.check_packed_grad_args(my, bits, x, a)
    cuda_lasso.check_packed_grad_args(my, bits, x, a,
                                      cuda_lasso.grad_limbs(a))


@pytest.mark.parametrize("f,kt", [(1, 64), (64, 64), (65, 128), (128, 128)])
def test_grad_limbs_layout(f, kt):
    """a (F, N) as the kernel reads it: (N, 3 KT) bf16, row n the three
    limbs of a[:, n] side by side, each zero past F."""
    rng = np.random.default_rng(f)
    a = _t((np.exp(np.log(10) * rng.standard_normal((f, 37)))
            * rng.choice([-1, 1], (f, 37))).astype(np.float32))
    out = cuda_lasso.grad_limbs(a)
    assert cuda_lasso.grad_tile(f) == kt
    assert out.shape == (37, 3 * kt) and out.dtype == torch.bfloat16
    assert out.is_contiguous()
    limbs = cuda_mu.split_bf16x3(a)
    rows = out.view(37, 3, kt)
    for l in range(3):
        assert torch.equal(rows[:, l, :f], limbs[l].T)
        assert not rows[:, l, f:].any()


def _limb_product(u, v, limbs):
    """u @ v as the limb products of each f32 operand split into
    ``limbs`` bf16 limbs: every product u_i v_j with i + j < limbs, summed
    exactly (f64)."""
    pu = [t.double() for t in cuda_mu.split_bf16x3(u)[:limbs]]
    pv = [t.double() for t in cuda_mu.split_bf16x3(v)[:limbs]]
    return sum(ui @ vj for i, ui in enumerate(pu) for j, vj in enumerate(pv)
               if i + j < limbs)


def _grad_chain(my, mask, x, a, limbs=None):
    """The masked gradient with each product as limb products and E formed
    in f32 (as the kernel forms it), or all in f64 when ``limbs`` is
    None."""
    if limbs is None:
        r = x.double() @ a.double()
        return (mask.double() * r - my.double()) @ a.double().T
    r = _limb_product(x, a, limbs).to(torch.float32)
    e = mask * r - my
    return _limb_product(e, a.T, limbs)


def test_bf16x6_keeps_f32_accuracy_where_bf16x3_does_not():
    """The packed kernel's products, emulated: on log-normal my, x and a
    (values over about six decades, as chip_smoke.py's phase 9 draws them)
    three limbs and six products (bf16x6) keep the gradient within a tenth
    of the f32 limit of f64; two limbs and three products (bf16x3) break
    the limit, so phase 9's data would catch that shortcut."""
    rng = np.random.default_rng(0)
    m, n, f, ln10 = 256, 384, 64, np.log(10.0)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    my = mask * np.exp(ln10 * rng.standard_normal((m, n)))
    x = np.exp(ln10 * rng.standard_normal((m, f)))
    a = np.exp(ln10 * rng.standard_normal((f, n)))
    args = [_t(v.astype(np.float32)) for v in (my, mask, x, a)]
    ref = _grad_chain(*args).numpy()
    six = rel_err(_grad_chain(*args, limbs=3).numpy(), ref)
    three = rel_err(_grad_chain(*args, limbs=2).numpy(), ref)
    assert six < _F32_LIMIT / 10
    assert three > _F32_LIMIT


def _masked_problem(seed):
    y, a, _ = planted_lasso(seed=seed, n_samples=24, n_features=20,
                            n_channels=36)
    mask = random_mask(seed + 1, y.shape).astype(np.float32)
    return (y * mask).astype(np.float32), a.astype(np.float32), mask


@pytest.mark.parametrize("method", ["fista", "parallel_cd"])
def test_solve_takes_the_packed_route_and_matches_pallas(monkeypatch,
                                                         method):
    """A 0/1 mask is packed once per solve and every gradient takes the
    packed route (on CPU: its twin, after unpacking); the result matches
    the Pallas route in interpret mode (f32, 30 fixed iterations: 1e-5, as
    test_torch_lasso.py's dense kernel route)."""
    spy = _RouteSpy(monkeypatch)
    y, a, mask = _masked_problem(50)
    kw = dict(method=method, tol=0.0, maxiter=30)
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, mask=mask, use_pallas=True,
                                _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, mask=_t(mask), use_kernel=True,
                  device="cpu", **kw)
    assert spy.packed == [True] and spy.unpacked == 30
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5
    dense = tl._solve(_t(y), _t(a), torch.tensor(ALPHA), None, _t(mask),
                      None, 0.0, record_objective=False, use_kernel=True,
                      **{k: v for k, v in kw.items() if k != "tol"})
    assert torch.equal(rt.x, dense.x)


def test_solve_keeps_a_weighted_mask_dense(monkeypatch):
    """A weighted mask is refused by pack_mask and the gradient reads the
    dense mask, as before."""
    spy = _RouteSpy(monkeypatch)
    y, a, mask = _masked_problem(52)
    mask = mask * np.where(np.arange(36) % 2, 0.5, 1.0).astype(np.float32)
    kw = dict(method="fista", tol=0.0, maxiter=10)
    rt = tl.solve(_t(y), _t(a), ALPHA, mask=_t(mask), use_kernel=True,
                  device="cpu", **kw)
    assert spy.packed == [False] and spy.unpacked == 0
    ref = tl.solve(_t(y), _t(a), ALPHA, mask=_t(mask), use_kernel=False,
                   device="cpu", **kw)
    assert rel_err(rt.x.numpy(), ref.x.numpy()) < 1e-6


def test_solve_streaming_packs_once_per_chunk(monkeypatch):
    """Each host chunk is one lasso.solve, which packs its rows' mask
    once where the masked kernel route runs (forced here: on the CPU
    'auto' takes no kernel)."""
    calls = []
    pack = cuda_mu.pack_mask

    def spy(mask):
        calls.append(tuple(mask.shape))
        return pack(mask)

    monkeypatch.setattr(cuda_mu, "pack_mask", spy)
    monkeypatch.setattr(tl, "_kernel_mode",
                        lambda *a, **k: "masked" if a[2] is not None
                        else None)
    y, a, mask = _masked_problem(54)
    res = tl.solve_streaming(y, a, ALPHA, mask=mask, chunk_rows=10,
                             tol=0.0, maxiter=5, device="cpu")
    assert calls == [(10, 36), (10, 36), (4, 36)]
    assert res.x.shape == (24, 20)


@pytest.mark.parametrize("heldout", [False, True])
def test_masked_dictionary_learning_packs_once_per_solve(monkeypatch,
                                                         heldout):
    """Masked dictionary learning on the kernel route packs the (training)
    mask once per solve, not once per outer iteration, and every inner
    gradient and every dictionary gradient takes the packed route (on CPU
    each twin unpacks: 5 inner and 1 dictionary gradient per outer
    iteration)."""
    spy = _RouteSpy(monkeypatch)
    rng = np.random.default_rng(56)
    m, n, k = 60, 24, 6
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    y = (rng.normal(size=(m, n)) * mask).astype(np.float32)
    d0 = rng.normal(size=(k, n)).astype(np.float32)
    kw = dict(tol=0.0, maxiter=4, lasso_iter=5, lasso_tol=0.0,
              use_kernel=True, device="cpu")
    if heldout:
        kw.update(stop="heldout", maxiter=12)
    res = tdl.solve(_t(y), _t(d0), ALPHA, mask=_t(mask), **kw)
    assert spy.packed == [True]
    assert spy.unpacked == res.niter * 6
    if not heldout:
        ref = tdl.solve(_t(y), _t(d0), ALPHA, mask=_t(mask),
                        **{**kw, "use_kernel": False})
        assert rel_err(res.d.numpy(), ref.d.numpy()) < 1e-5


@pytest.mark.parametrize("dtype,binary,want", [
    (torch.bfloat16, True, True),
    (torch.bfloat16, False, True),
    (torch.float32, True, True),
    (torch.float32, False, True),
    (torch.float64, True, False),
])
def test_auto_gate_for_masked_data(dtype, binary, want):
    """use_kernel='auto' on masked data on the card takes the masked
    kernels where the card measured them faster than the composition
    (PERF.md §6, phases 11 and 15): bf16 and f32 data, a 0/1 mask on the
    packed route and a weighted one on the weighted instances alike; f64
    runs the composition. _kernel_mask gives the solve's kernel mask, or
    None for the composition."""
    assert tl._auto_takes_masked(dtype) is want
    y = torch.ones((4, 40), dtype=dtype)
    mask = (torch.arange(160).reshape(4, 40) % 3 > 0).to(dtype)
    if not binary:
        mask = 0.5 * mask
    assert (tl._kernel_mask(mask, y, True) is not None) is want


@pytest.mark.parametrize("dtype,device,want", [
    (torch.float32, "cpu", True),
    (torch.float64, "cpu", True),
    (torch.bfloat16, "cpu", True),
    (torch.float32, "meta", True),
    (torch.bfloat16, "meta", True),
    (torch.float64, "meta", False),
])
def test_grad_takes_packed(dtype, device, want):
    """f32 and bf16 data on a device with kernels (a meta tensor stands in
    for the card: only the dtype and device type are read), any data on
    the CPU; f64 on the card keeps the dense mask."""
    my = torch.empty((3, 4), dtype=dtype, device=device)
    assert cuda_lasso.grad_takes_packed(my) is want


def test_kernel_mask_under_auto():
    """_kernel_mask, the mask a solve's kernel route reads: bits for a
    0/1 mask, the dense mask for a weighted one, under 'auto' too (the
    weighted instances run it)."""
    y = torch.ones((4, 40))
    mask = (torch.arange(160).reshape(4, 40) % 3 > 0).float()
    bits = tl._kernel_mask(mask, y, True)
    assert bits.dtype == torch.int32
    assert torch.equal(bits, cuda_mu.pack_mask(mask))
    weighted = 0.5 * mask
    assert tl._kernel_mask(weighted, y, True) is weighted
    assert tl._kernel_mask(weighted, y, False) is weighted
