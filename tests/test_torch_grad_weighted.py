"""The masked gradients on a weighted mask in the PyTorch port: the dense
route of ``masked_grad_rows`` and ``masked_grad_dict``, which on the card
runs the weighted instances of ``csrc/lasso_grad_packed.cu`` and
``csrc/grad_dict_packed.cu`` (the weights streamed beside my in the data's
dtype). On the CPU the wrappers run their twins, held here against
``decomp_tpu``'s Pallas kernels in interpret mode on weights in [0.5, 1)
and log-normal over four decades, f32 and bf16, at ragged shapes; then a
weighted masked lasso and dictionary learning through ``use_kernel=True``
against ``decomp_tpu``'s Pallas route, the weighted launches' refusals, and
the routes with the card's launches faked. The same numpy inputs, made
from a seed, go through both packages. The CUDA kernels themselves run
only on the card (``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.ops import pallas_lasso
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.models import lasso as tl
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err

ALPHA = 0.05
_BF16, _F32 = torch.bfloat16, torch.float32
# f32: 1e-5 relative, the limit test_torch_lasso_kernels.py holds the twin
# to the Pallas kernel (tests/test_pallas.py:161's for the TPU kernel
# against the composition). bf16: E is rounded to bf16 before the second
# product and the rows gradient is stored in bf16, so a one-ulp f32
# difference of x a flips a rounding: 1e-3, test_torch_lasso_kernels.py's
# bf16 limit (measured here: <= 3.9e-5 for the rows gradient, <= 1.5e-7
# for every other case).
_LIMIT = {_F32: 1e-5, _BF16: 1e-3}
_SHAPES = [(37, 70, 1), (33, 257, 7), (9, 100, 64), (70, 129, 128),
           (5, 31, 65)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, shape, kind):
    """Weights on every entry: uniform in [0.5, 1), or log-normal
    e^(ln 10 z / 1.5), 99.7% of them within 10^-2 .. 10^2."""
    if kind == "uniform":
        return rng.uniform(0.5, 1.0, shape)
    return np.exp(np.log(10.0) / 1.5 * rng.standard_normal(shape))


def _inputs(seed, m, n, f, kind):
    """f32 numpy (my, mask, x, a): a weighted mask, 0 on the 30% missing
    entries, my = mask * y; x and a normal, a scaled by 1/sqrt(N)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3) * _weights(rng, (m, n), kind)
    y = rng.normal(size=(m, n))
    x = rng.normal(size=(m, f))
    a = rng.normal(size=(f, n)) / np.sqrt(n)
    return tuple(v.astype(np.float32) for v in (y * mask, mask, x, a))


def _pad(v, rows, cols):
    return np.pad(v, ((0, rows - v.shape[0]), (0, cols - v.shape[1])))


def _pallas(fn, arrays, dtype):
    """decomp_tpu's ``fn`` (masked_grad_rows or masked_grad_dict) in
    interpret mode on zero-padded inputs (N and F in multiples of 128, M in
    whole 16-row blocks; a padded entry has weight 0 and my 0, so E is 0
    there), in ``dtype``, cut back."""
    my, mask, x, a = arrays
    (m, n), f = my.shape, a.shape[0]
    mp, np_, fp = -(-m // 16) * 16, -(-n // 128) * 128, -(-f // 128) * 128
    jdt = jnp.float32 if dtype == _F32 else jnp.bfloat16
    out = fn(*(jnp.asarray(_pad(v, r, c), jdt) for v, r, c in
               ((my, mp, np_), (mask, mp, np_), (x, mp, fp), (a, fp, np_))),
             block_rows=16, interpret=True)
    out = np.asarray(out, np.float32)
    return out[:m, :f] if fn is pallas_lasso.masked_grad_rows else out[:f, :n]


@pytest.mark.parametrize("kind", ["uniform", "lognormal"])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("m,n,f", _SHAPES)
def test_rows_twin_matches_pallas(m, n, f, dtype, kind):
    """masked_grad_rows on a weighted mask (on CPU: its twin, the function
    the weighted instance is held to on the card) against decomp_tpu's
    masked_grad_rows in interpret mode: g in the data's dtype."""
    arrays = _inputs(m * n + f, m, n, f, kind)
    ref = _pallas(pallas_lasso.masked_grad_rows, arrays, dtype)
    my, mask, x, a = (_t(v).to(dtype) for v in arrays)
    got = cuda_lasso.masked_grad_rows(my, mask, x, a)
    assert got.dtype == dtype and got.shape == (m, f)
    assert rel_err(got.to(_F32).numpy(), ref) < _LIMIT[dtype]


@pytest.mark.parametrize("kind", ["uniform", "lognormal"])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("m,n,k", _SHAPES)
def test_dict_twin_matches_pallas(m, n, k, dtype, kind):
    """masked_grad_dict on a weighted mask against decomp_tpu's
    masked_grad_dict in interpret mode: G in f32."""
    arrays = _inputs(m * n + k + 1, m, n, k, kind)
    ref = _pallas(pallas_lasso.masked_grad_dict, arrays, dtype)
    my, mask, x, d = (_t(v).to(dtype) for v in arrays)
    got = cuda_dl.masked_grad_dict(my, mask, x, d)
    assert got.dtype == _F32 and got.shape == (k, n)
    assert rel_err(got.numpy(), ref) < _LIMIT[dtype]


def _problem(seed, m=40, n=36, f=12, kind="uniform"):
    """A weighted masked lasso (or dictionary) problem in f32 numpy. The
    weights are scaled to at most 1, as the solvers' steps assume (their
    Lipschitz constant leaves the mask out: a weight above 1 can make the
    iteration diverge), so log-normal ones span (1e-4, 1]."""
    rng = np.random.default_rng(seed)
    w = _weights(rng, (m, n), kind)
    mask = ((rng.random((m, n)) >= 0.3) * w / max(1.0, w.max())).astype(
        np.float32)
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    y = rng.normal(size=(m, n)).astype(np.float32)
    return y, a, mask


@pytest.mark.parametrize("kind", ["uniform", "lognormal"])
@pytest.mark.parametrize("method", ["fista", "parallel_cd"])
def test_weighted_lasso_matches_pallas(method, kind):
    """A weighted masked lasso through use_kernel=True (each gradient on
    the weighted route; on CPU its twin) against decomp_tpu's Pallas route
    in interpret mode, f32, 30 fixed iterations: 1e-5, as
    test_torch_lasso_packed.py's 0/1 mask."""
    y, a, mask = _problem(70, kind=kind)
    kw = dict(method=method, tol=0.0, maxiter=30)
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, mask=mask, use_pallas=True,
                                _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, mask=_t(mask), use_kernel=True,
                  device="cpu", **kw)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


@pytest.mark.parametrize("kind", ["uniform", "lognormal"])
def test_weighted_dictionary_learning_matches_pallas(kind):
    """Weighted masked dictionary learning through use_kernel=True (both
    gradients on the weighted routes) against decomp_tpu's Pallas route in
    interpret mode from the same x and d, f32, 4 outer x 5 inner
    iterations: 1e-5, as test_torch_grad_dict_packed.py's 0/1 mask. At 64
    x 128 with 128 atoms (the kernels' widest tile) the Pallas route pads
    nothing; padded atoms and channels move its trajectory away from
    decomp_tpu's own composition (by 4e-6 at 60 x 24, 6 atoms)."""
    y, d0, mask = _problem(71, m=64, n=128, f=128, kind=kind)
    rng = np.random.default_rng(72)
    x0 = (rng.normal(size=(64, 128)) * (rng.random((64, 128)) < 0.3)
          ).astype(np.float32)
    kw = dict(tol=0.0, maxiter=4, lasso_iter=5, lasso_tol=0.0)
    rj = decomp_tpu.dictionary_learning.solve(
        y, d0, ALPHA, x=x0, mask=mask, use_pallas=True,
        _pallas_interpret=True, **kw)
    rt = tdl.solve(_t(y), _t(d0), ALPHA, x=_t(x0), mask=_t(mask),
                   use_kernel=True, device="cpu", **kw)
    assert rt.niter == 4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


@pytest.fixture
def no_build(monkeypatch):
    """Any reach for a kernel library fails the test: a refusal must come
    before the launch."""
    def refuse(*args):
        raise AssertionError(f"a kernel was reached: {args[:2]}")
    for module in (cuda_lasso, cuda_dl):
        monkeypatch.setattr(module, "_c_function", refuse)


@pytest.mark.parametrize("change,error", [
    (dict(my=torch.float64, mask=torch.float64, x=torch.float64,
          a=torch.float64), texc.DtypeError),
    (dict(x=_BF16), texc.DtypeError),
    (dict(mask=_BF16), texc.DtypeError),
    (dict(mask=torch.int32), texc.DtypeError),
    (dict(shape=(20, 39)), texc.ShapeError),
    (dict(device="meta"), texc.DecompError),
    # just past the gate (grad_fits) at N = 40, f32
    (dict(f=10113), texc.ShapeError),
    (dict(f=0), texc.ShapeError),
])
@pytest.mark.parametrize("launch", ["rows", "dict"])
def test_weighted_launch_refusals(no_build, launch, change, error):
    """What the weighted instances do not take is refused before any
    launch: f64, mixed dtypes (x, or the weights, in another dtype than
    my), a mask of another shape or on another device, F or K outside
    1 .. the gate (grad_fits)."""
    f = change.get("f", 4)
    if f > 4:
        assert cuda_lasso.grad_fits(40, f - 1, 4)
        assert not cuda_lasso.grad_fits(40, f, 4)
    my, mask, x, a = (_t(v) for v in _inputs(3, 20, 40, max(f, 1),
                                             "uniform"))
    if f == 0:
        x, a = x[:, :0], a[:0]
    my, mask, x, a = (t.to(change.get(k, _F32)) for k, t in
                      (("my", my), ("mask", mask), ("x", x), ("a", a)))
    if "shape" in change:
        mask = torch.zeros(change["shape"])
    if "device" in change:
        mask = mask.to(change["device"])
    with pytest.raises(error):
        if launch == "rows":
            cuda_lasso._grad_weighted_launch(my, mask, x, a, None)
        else:
            cuda_dl._grad_dict_weighted_launch(my, mask, x, a)


def test_weighted_launch_refuses_a_limbs_of_another_shape(no_build):
    """a's limbs given to the weighted rows launch must be grad_limbs(a)'s
    layout: the f32 (three-limb) width for bf16 data is refused."""
    my, mask, x, a = (_t(v).to(_BF16) for v in _inputs(4, 20, 40, 4,
                                                        "uniform"))
    with pytest.raises(texc.ShapeError):
        cuda_lasso._grad_weighted_launch(
            my, mask, x, a, torch.zeros((40, 3 * 64), dtype=_BF16))


@pytest.fixture
def on_card(monkeypatch):
    """Both masked gradients as if their data lay on the card: each launch
    of a route is recorded (wrapper, route, mask dtype) and replaced by the
    twin; the first designs fail if reached."""
    calls = []

    def launch(wrapper, route, plain):
        def run(my, mask, x, a, *limbs):
            calls.append((wrapper, route, mask.dtype))
            return plain(my, mask, x, a)
        return run

    def first(*args):
        raise AssertionError("a first design was launched on a route")

    for module, short, wrapper, plain in (
            (cuda_lasso, "grad", "masked_grad_rows",
             cuda_lasso.masked_grad_rows_plain),
            (cuda_dl, "grad_dict", "masked_grad_dict",
             cuda_dl.masked_grad_dict_plain)):
        monkeypatch.setattr(module, "_runs_plain", lambda t: False)
        monkeypatch.setattr(module, f"_{short}_weighted_launch",
                            launch(wrapper, "weighted", plain))
        monkeypatch.setattr(module, f"_{short}_dense_mma_launch", first)
        w = getattr(module, wrapper)
        for name in ("launches", "packed_launches", "dense_launches"):
            monkeypatch.setattr(w, name, 0)
    return calls


@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_weighted_gradients_route_as_on_the_card(on_card, dtype):
    """On the card a weighted mask sends each masked gradient to its
    weighted instance, counted in .dense_launches and .launches, never to
    the first designs; the route gives the twin's function."""
    my, mask, x, a = (_t(v).to(dtype) for v in _inputs(5, 30, 50, 9,
                                                       "lognormal"))
    g = cuda_lasso.masked_grad_rows(my, mask, x, a)
    gd = cuda_dl.masked_grad_dict(my, mask, x, a)
    rows, dic = cuda_lasso.masked_grad_rows, cuda_dl.masked_grad_dict
    assert on_card == [
        ("masked_grad_rows", "weighted", dtype),
        ("masked_grad_dict", "weighted", dtype)]
    assert (rows.packed_launches, rows.dense_launches, rows.launches) == (
        0, 1, 1)
    assert (dic.packed_launches, dic.dense_launches, dic.launches) == (
        0, 1, 1)
    assert torch.equal(g, cuda_lasso.masked_grad_rows_plain(my, mask, x, a))
    assert torch.equal(gd, cuda_dl.masked_grad_dict_plain(my, mask, x, a))


@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_weighted_solves_route_as_on_the_card(on_card, dtype):
    """Masked lasso.solve and dictionary_learning.solve on a weighted mask
    with the card's routes faked: every gradient of both takes the
    weighted instances (.dense_launches)."""
    y, a, mask = (_t(v).to(dtype) for v in _problem(73, kind="lognormal"))
    res = tl.solve(y, a, ALPHA, mask=mask, method="fista", tol=0.0,
                   maxiter=7, use_kernel=True, device="cpu")
    assert res.niter == 7
    assert on_card == [("masked_grad_rows", "weighted", dtype)] * 7
    del on_card[:]
    rows, dic = cuda_lasso.masked_grad_rows, cuda_dl.masked_grad_dict
    rows.dense_launches = 0
    d0 = a[:6]
    res = tdl.solve(y, d0, ALPHA, mask=mask, use_kernel=True, device="cpu",
                    tol=0.0, maxiter=4, lasso_iter=3, lasso_tol=0.0)
    assert res.niter == 4
    assert ((rows.packed_launches, rows.dense_launches),
            (dic.packed_launches, dic.dense_launches)) == ((0, 12), (0, 4))
    assert set(on_card) == {
        ("masked_grad_rows", "weighted", dtype),
        ("masked_grad_dict", "weighted", dtype)}
