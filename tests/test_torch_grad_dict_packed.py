"""The masked dictionary gradient's f32 route in the PyTorch port,
``csrc/grad_dict_packed.cu`` (a packed 0/1 mask, bf16x6 limb products on
``wgmma``): a plain emulation of the kernel's arithmetic against the
full-f32 twin and f64, the route ``masked_grad_dict`` takes by the mask's
form, the layout of x's limbs, the shape-only partial count, the twin on
an unpacked mask against ``decomp_tpu``'s Pallas kernel in interpret mode,
and masked ``dictionary_learning.solve`` handing the packed mask to the
dictionary gradient, against ``decomp_tpu``'s masked solve. The same numpy
inputs, made from a seed, go through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.ops import pallas_lasso
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_dl import _heldout_problem, _jax_reserve
from test_torch_kl_dense_packed import _prod
from test_torch_masked_packed import _RouteSpy

# chip_smoke.py's limit for f32 kernels against their twin (GRAD_LIMIT[f32]).
_F32_LIMIT = 2e-6
_F32 = torch.float32
ALPHA = 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, m, n, k, kind="normal", missing=0.3):
    """f32 (my, mask, x, d): a 0/1 mask with a share ``missing`` of zeros;
    my, x and d normal, uniform in [0, 1), or log-normal e^(ln 10 z) over
    about six decades (chip_smoke.py's phase 13 draws them so)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= missing).astype(np.float32)
    shapes = ((m, n), (m, k), (k, n))
    if kind == "lognormal":
        ln10 = np.log(10.0)
        y, x, d = (np.exp(ln10 * rng.standard_normal(s)) for s in shapes)
    elif kind == "uniform":
        y, x, d = (rng.random(s) for s in shapes)
    else:
        y, x, d = (rng.normal(size=s) for s in shapes)
    return tuple(_t(a.astype(np.float32)) for a in (y * mask, mask, x, d))


def _kernel_chain(my, mask, x, d, limbs=3):
    """The kernel's arithmetic in plain torch: per row chunk
    (``grad_dict_packed_rows``), 32-row stages with the roles of the KL
    statistics pass (R'^T = d^T x_s^T with big chains per 64-deep block,
    E^T = mask_s^T R'^T - my_s^T in f32, G^T += E^T x_s per stage), then
    the chunks' partials summed in chunk order."""
    m, n = my.shape
    rows = cuda_dl.grad_dict_packed_rows(m, n)
    g = None
    for c0 in range(0, m, rows):
        acc_t = torch.zeros((n, d.shape[0]), dtype=_F32)
        for r in range(c0, min(c0 + rows, m), 32):
            sl = slice(r, min(r + 32, c0 + rows, m))
            xs = x[sl]
            e_t = mask[sl].T * _prod(d.T, xs.T, limbs, 64) - my[sl].T
            acc_t = acc_t + _prod(e_t, xs, limbs, 32)
        g = acc_t.T if g is None else g + acc_t.T
    return g


def _f64(my, mask, x, d):
    my, mask, x, d = (v.double() for v in (my, mask, x, d))
    return x.T @ (mask * (x @ d) - my)


@pytest.mark.parametrize("kind", ["normal", "uniform", "lognormal"])
@pytest.mark.parametrize("m,n,k", [(256, 320, 64), (160, 200, 96),
                                   (333, 257, 7)])
def test_emulated_kernel_keeps_f32_accuracy(m, n, k, kind):
    """bf16x6 with per-stage big chains keeps G within chip_smoke.py's f32
    limit of the full-f32 twin and of f64, on normal, uniform and
    log-normal data (about six decades)."""
    args = _inputs(m + n + k, m, n, k, kind)
    got = _kernel_chain(*args)
    twin = cuda_dl.masked_grad_dict_plain(*args)
    ref = _f64(*args)
    assert rel_err(got.double().numpy(), twin.double().numpy()) < _F32_LIMIT
    assert rel_err(got.double().numpy(), ref.numpy()) < _F32_LIMIT
    assert rel_err(twin.double().numpy(), ref.numpy()) < _F32_LIMIT


def test_bf16x3_shortcut_breaks_the_limit():
    """Two limbs and three products (bf16x3) break the f32 limit on the
    log-normal data that bf16x6 keeps well within it, so phase 13's
    log-normal shape would catch that shortcut."""
    args = _inputs(0, 256, 320, 64, "lognormal")
    ref = _f64(*args).numpy()
    assert rel_err(_kernel_chain(*args).double().numpy(), ref) \
        < _F32_LIMIT / 4
    assert rel_err(_kernel_chain(*args, limbs=2).double().numpy(), ref) \
        > _F32_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(96, 130, 10), (333, 257, 7)])
def test_packed_mask_on_cpu_gives_the_dense_twins_bits(m, n, k, dtype):
    """On a CPU tensor a packed mask is unpacked to my's dtype and the twin
    runs on it: the dense twin's bits, and no launch is counted."""
    my, mask, x, d = (v.to(dtype) for v in _inputs(k, m, n, k))
    before = (cuda_dl.masked_grad_dict.launches,
              cuda_dl.masked_grad_dict.packed_launches)
    got = cuda_dl.masked_grad_dict(my, cuda_mu.pack_mask(mask), x, d)
    assert torch.equal(got, cuda_dl.masked_grad_dict(my, mask, x, d))
    assert torch.equal(got, cuda_dl.masked_grad_dict_plain(my, mask, x, d))
    assert (cuda_dl.masked_grad_dict.launches,
            cuda_dl.masked_grad_dict.packed_launches) == before


@pytest.fixture
def on_card(monkeypatch):
    """masked_grad_dict as if its data lay on the card: each launch is
    recorded (route, the mask's dtype) and replaced by the twin on the
    dense mask."""
    calls = []

    def launch(route):
        def run(my, mask, x, d):
            calls.append((route, mask.dtype))
            if route == "packed":
                mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
            return cuda_dl.masked_grad_dict_plain(my, mask, x, d)
        return run

    monkeypatch.setattr(cuda_dl, "_runs_plain", lambda t: False)
    monkeypatch.setattr(cuda_dl, "_grad_dict_packed_launch",
                        launch("packed"))
    monkeypatch.setattr(cuda_dl, "_grad_dict_weighted_launch",
                        launch("dense"))
    for name in ("launches", "packed_launches", "dense_launches"):
        monkeypatch.setattr(cuda_dl.masked_grad_dict, name, 0)
    return calls


@pytest.mark.parametrize("packed", [True, False])
def test_route_by_the_masks_form(on_card, packed):
    """On the card a packed mask takes csrc/grad_dict_packed.cu's bits
    instance and a dense one its weighted instance, each counted apart and
    both in .launches; the two give the same function."""
    my, mask, x, d = _inputs(3, 70, 90, 12)
    got = cuda_dl.masked_grad_dict(
        my, cuda_mu.pack_mask(mask) if packed else mask, x, d)
    w = cuda_dl.masked_grad_dict
    assert on_card == [("packed", torch.int32) if packed
                       else ("dense", _F32)]
    assert (w.packed_launches, w.dense_launches, w.launches) == (
        (1, 0, 1) if packed else (0, 1, 1))
    assert torch.equal(got, cuda_dl.masked_grad_dict_plain(my, mask, x, d))


def test_packed_route_refuses_before_any_launch():
    """What csrc/grad_dict_packed.cu does not take raises before a build or
    a launch: mixed f32 and bf16 data, K just past the gate (grad_fits), a
    packed mask of another shape."""
    my, mask, x, d = _inputs(4, 40, 70, 8)
    bits = cuda_mu.pack_mask(mask)
    bf = torch.bfloat16
    with pytest.raises(texc.DtypeError):
        cuda_dl._grad_dict_packed_launch(my.to(bf), bits, x, d.to(bf))
    # just past the gate at N = 70, f32
    assert cuda_lasso.grad_fits(70, 10112, 4)
    assert not cuda_lasso.grad_fits(70, 10113, 4)
    wide_x, wide_d = torch.zeros((40, 10113)), torch.zeros((10113, 70))
    with pytest.raises(texc.ShapeError):
        cuda_dl._grad_dict_packed_launch(my, bits, wide_x, wide_d)
    with pytest.raises(texc.ShapeError):
        cuda_dl.masked_grad_dict(my, bits[:, :2].contiguous(), x, d)
    with pytest.raises(texc.ShapeError):
        cuda_dl.masked_grad_dict(my[:39], bits, x[:39], d)


@pytest.mark.parametrize("m,k", [(5, 64), (7, 1), (9, 7), (33, 100),
                                 (4, 128)])
def test_x_limbs_layout(m, k):
    """x's limbs as the kernel streams them, for KT = 64 (K <= 64) and 128:
    (M, 3 KT) bf16, row m = [limb 0 | limb 1 | limb 2] of x[m] in
    split_bf16x3's round-to-nearest limbs, zero past K; the card's split
    launch is held to this function bit for bit (chip_smoke.py phase
    13)."""
    rng = np.random.default_rng(m + k)
    x = _t(np.exp(3 * rng.standard_normal((m, k))).astype(np.float32))
    kt = cuda_lasso.grad_tile(k)
    got = cuda_dl._split_rows(x, kt)
    assert got.shape == (m, 3 * kt) and got.dtype == torch.bfloat16
    limbs = cuda_mu.split_bf16x3(x)
    for l in range(3):
        assert torch.equal(got[:, l * kt:l * kt + k], limbs[l])
        assert not bool(got[:, l * kt + k:(l + 1) * kt].any())
    back = sum(got[:, l * kt:l * kt + k].to(_F32) for l in range(3))
    assert rel_err(back.numpy(), x.numpy()) < 2 ** -20


@pytest.mark.parametrize("m,n,rows,chunks", [
    (100_000, 1024, 3040, 33),
    (333, 257, 32, 11),
    (1000, 1000, 32, 32),
    (65536, 10112, 16384, 4),
    (1, 1, 32, 1),
])
def test_partials_are_a_function_of_the_shape(m, n, rows, chunks):
    """Row chunks of the kernel's grid (dense KL's statistics grid: two
    waves of 128-column N tiles over the H100's 132 SMs, whole 32-row
    stages): nothing but the shape goes in, so neither does the summation
    order."""
    got = cuda_dl.grad_dict_packed_rows(m, n)
    assert got == rows and got % 32 == 0 and -(-m // got) == chunks
    assert got == cuda_mu.kl_packed_block_rows(m, n)


def _padded_pallas(my, mask, x, d, mp, np_, kp, block_rows):
    """decomp_tpu's masked_grad_dict in interpret mode on zero-padded
    inputs (it takes N and K in multiples of 128 and M in whole blocks;
    a padded entry has mask 0 and my 0, so E = 0 there), cut back."""
    m, n = my.shape
    k = d.shape[0]

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[:a.shape[0], :a.shape[1]] = a.numpy()
        return jnp.asarray(out)

    g = pallas_lasso.masked_grad_dict(
        pad(my, (mp, np_)), pad(mask, (mp, np_)), pad(x, (mp, kp)),
        pad(d, (kp, np_)), block_rows=block_rows, interpret=True)
    return np.asarray(g)[:k, :n]


@pytest.mark.parametrize("m,n,k,padded", [
    (333, 257, 7, (352, 384, 128)),
    (160, 256, 128, (160, 256, 128)),
    (96, 128, 100, (96, 128, 128)),
])
def test_twin_on_unpacked_mask_matches_pallas(m, n, k, padded):
    """masked_grad_dict on a packed 0/1 mask (on CPU: the twin on the
    unpacked mask, the function the kernel is held to on the card) against
    decomp_tpu's masked_grad_dict in interpret mode, f32, at ragged and
    aligned shapes: both sum f32 products in another order, within the f32
    limit."""
    my, mask, x, d = _inputs(m * n + k, m, n, k)
    ref = _padded_pallas(my, mask, x, d, *padded, block_rows=32)
    got = cuda_dl.masked_grad_dict(my, cuda_mu.pack_mask(mask), x, d)
    assert got.dtype == _F32 and got.shape == ref.shape
    assert rel_err(got.numpy(), ref) < _F32_LIMIT


class _DictSpy:
    """The mask dtype of every masked_grad_dict call."""

    def __init__(self, monkeypatch):
        self.masks = []
        inner = cuda_dl.masked_grad_dict

        def spy(my, mask, x, d):
            self.masks.append(mask.dtype)
            return inner(my, mask, x, d)

        monkeypatch.setattr(cuda_dl, "masked_grad_dict", spy)


def _dl_problem(seed, m=60, n=24, k=6):
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    y = (rng.normal(size=(m, n)) * mask).astype(np.float32)
    x0 = (rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.3)).astype(
        np.float32)
    d0 = rng.normal(size=(k, n)).astype(np.float32)
    return y, mask, x0, d0


def test_solve_hands_the_packed_mask_to_the_dictionary_gradient(
        monkeypatch):
    """Masked dictionary learning on f32 data, use_kernel=True: the mask is
    packed once per solve, masked_grad_dict receives the bits once per
    outer iteration (its twin unpacks them, as each of the 5 inner
    gradients' does), and the result matches decomp_tpu's masked solve
    from the same explicit x and d (f32: 1e-5, as test_torch_dl.py's
    masked kernel route)."""
    spy, dspy = _RouteSpy(monkeypatch), _DictSpy(monkeypatch)
    y, mask, x0, d0 = _dl_problem(90)
    kw = dict(tol=0.0, maxiter=4, lasso_iter=5, lasso_tol=0.0)
    rt = tdl.solve(_t(y), _t(d0), ALPHA, x=_t(x0), mask=_t(mask),
                   use_kernel=True, device="cpu", **kw)
    rj = decomp_tpu.dictionary_learning.solve(y, d0, ALPHA, x=x0, mask=mask,
                                              **kw)
    assert rt.niter == 4
    assert dspy.masks == [torch.int32] * 4
    assert spy.packed == [True] and spy.unpacked == 4 * 6
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


def test_heldout_solve_hands_the_training_bits_to_the_dictionary_gradient(
        monkeypatch):
    """Under stop='heldout' with decomp_tpu's reserve passed in, the kernel
    route packs the training mask once and the dictionary gradient gets
    its bits every outer iteration; niter, converged, the held-out error
    and d match decomp_tpu's (f32: 1e-5)."""
    spy, dspy = _RouteSpy(monkeypatch), _DictSpy(monkeypatch)
    y, mask, d0 = (v.astype(np.float32) for v in _heldout_problem(91))
    kw = dict(tol=1e-3, maxiter=300, lasso_iter=6)
    rj = decomp_tpu.dictionary_learning.solve(
        y, d0, 0.02, mask=mask, stop="heldout", random_seed=5, **kw)
    val = _jax_reserve(y, mask, 0.05, 5)
    rt = tdl._solve(_t(y), _t(d0), None, _t(mask), _t(val),
                    torch.tensor(0.02), lasso_tol=1e-6, forget=0.9,
                    lasso_method="fista", minibatch=None,
                    record_objective=False, kernel="masked", **kw)
    assert rt.niter == int(rj.niter) and rt.converged == bool(rj.converged)
    assert dspy.masks == [torch.int32] * rt.niter
    assert spy.packed == [True]
    ej = float(np.asarray(rj.aux["heldout_rel_err"]))
    assert abs(float(rt.aux["heldout_rel_err"]) - ej) <= 1e-5 * ej
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5


@pytest.mark.parametrize("dtype,routes", [(torch.float32, (4, 0)),
                                          (torch.bfloat16, (4, 0))])
def test_solve_routes_as_on_the_card(monkeypatch, on_card, dtype, routes):
    """With the card's routes faked (f32 and bf16 take bits, as
    cuda_lasso.grad_takes_packed says on the card), masked dictionary
    learning launches masked_grad_dict once per outer iteration, all on the
    packed route (chip_smoke.py phase 15's check)."""
    monkeypatch.setattr(cuda_lasso, "grad_takes_packed",
                        lambda my: my.dtype in (torch.float32,
                                                torch.bfloat16))
    y, mask, x0, d0 = _dl_problem(92)
    res = tdl.solve(_t(y).to(dtype), _t(d0).to(dtype), ALPHA,
                    x=_t(x0).to(dtype), mask=_t(mask).to(dtype),
                    use_kernel=True, device="cpu", tol=0.0, maxiter=4,
                    lasso_iter=3, lasso_tol=0.0)
    w = cuda_dl.masked_grad_dict
    assert res.niter == 4
    assert (w.packed_launches, w.dense_launches, w.launches) == routes + (4,)
    assert [m for _, m in on_card] == [torch.int32] * 4
