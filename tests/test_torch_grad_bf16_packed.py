"""The masked gradients on bf16 data with a bit-packed 0/1 mask in the
PyTorch port: ``masked_grad_rows`` and ``masked_grad_dict`` on the bf16
(one-limb) instances of ``csrc/lasso_grad_packed.cu`` and
``csrc/grad_dict_packed.cu``. On the CPU the wrappers run their twins on the
unpacked mask, held here against ``decomp_tpu``'s Pallas kernels in
interpret mode; a plain emulation of the kernels' bf16 sum order (64-deep
chunks of R added in f32, E rounded to bf16, g summed stage by stage) is
held against the twins on normal and log-normal data; then the one-limb
layout of the operands, the argument checks, and the routes that masked
``lasso.solve`` and ``dictionary_learning.solve`` take with the card's
launches faked. The same numpy inputs, made from a seed, go through both
packages. The CUDA kernels themselves run only on the card
(``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decomp_tpu.ops import pallas_lasso
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.models import lasso as tl
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_masked_packed import _RouteSpy

# chip_smoke.py's limit for the bf16 gradient kernels against their twin
# (GRAD_LIMIT[bf16]): E is rounded to bf16 before the second product, so a
# one-ulp f32 difference of R flips a rounding, and g is stored in bf16.
_BF16_LIMIT = 2.5e-4
_BF16, _F32 = torch.bfloat16, torch.float32
ALPHA = 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, m, n, f, kind="normal"):
    """f32 numpy (my, mask, x, a): a 0/1 mask with 30% zeros; my, x and a
    normal (a scaled by 1/sqrt(N)) or log-normal e^(ln 10 z) over about six
    decades (chip_smoke.py's log-normal shapes draw them so)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    shapes = ((m, n), (m, f), (f, n))
    if kind == "lognormal":
        ln10 = np.log(10.0)
        y, x, a = (np.exp(ln10 * rng.standard_normal(s)) for s in shapes)
    else:
        y, x, a = (rng.normal(size=s) for s in shapes)
        a = a / np.sqrt(n)
    return tuple(v.astype(np.float32) for v in (y * mask, mask, x, a))


def _bf16(arrays):
    """The numpy arrays as bf16 tensors (round to nearest even, the bits
    jnp.asarray(v, jnp.bfloat16) gives)."""
    return tuple(_t(v).to(_BF16) for v in arrays)


def _f32(t):
    return t.to(_F32).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_against_pallas(seed):
    """masked_grad_rows on bf16 data and the packed mask (on the CPU: the
    twin on the unpacked mask) against decomp_tpu's masked_grad_rows in
    interpret mode, 256 x 256, F = 128: both sum f32 products in another
    order and round E and g to bf16, within the bf16 limit."""
    arrays = _inputs(seed, 256, 256, 128)
    ref = pallas_lasso.masked_grad_rows(
        *(jnp.asarray(v, jnp.bfloat16) for v in arrays), block_rows=64,
        interpret=True)
    my, mask, x, a = _bf16(arrays)
    got = cuda_lasso.masked_grad_rows(my, cuda_mu.pack_mask(mask), x, a)
    assert got.dtype == _BF16 and got.shape == (256, 128)
    assert rel_err(_f32(got), np.asarray(ref, np.float32)) < _BF16_LIMIT


@pytest.mark.parametrize("seed", [0, 1])
def test_dict_against_pallas(seed):
    """masked_grad_dict on bf16 data and the packed mask against decomp_tpu's
    masked_grad_dict in interpret mode, 256 x 256, K = 128: G in f32 from
    bf16-rounded residuals, within the bf16 limit."""
    arrays = _inputs(seed + 10, 256, 256, 128)
    ref = pallas_lasso.masked_grad_dict(
        *(jnp.asarray(v, jnp.bfloat16) for v in arrays), block_rows=64,
        interpret=True)
    my, mask, x, d = _bf16(arrays)
    got = cuda_dl.masked_grad_dict(my, cuda_mu.pack_mask(mask), x, d)
    assert got.dtype == _F32 and got.shape == (128, 256)
    assert rel_err(got.numpy(), np.asarray(ref)) < _BF16_LIMIT


def _chunked(u, v, depth=64):
    """u @ v in f32, summed per ``depth``-deep chunk and the chunks added
    in f32 (round to nearest): the kernels' big chain."""
    out = None
    for k0 in range(0, u.shape[1], depth):
        part = u[:, k0:k0 + depth] @ v[k0:k0 + depth]
        out = part if out is None else out + part
    return out


def _rows_emulation(my, mask, x, a):
    """csrc/lasso_grad_packed.cu's bf16 instance in plain torch: 64-column
    stages; R = x a_s per 64-feature chunk added in f32; E = bf16(f32(mask)
    R - f32(my)); g += E a_s^T in f32 stage by stage; g stored in bf16."""
    xf, af = x.to(_F32), a.to(_F32)
    g = torch.zeros((my.shape[0], a.shape[0]), dtype=_F32)
    for s0 in range(0, my.shape[1], 64):
        cols = slice(s0, s0 + 64)
        r = _chunked(xf, af[:, cols])
        e = (mask[:, cols].to(_F32) * r - my[:, cols].to(_F32)).to(_BF16)
        g = g + e.to(_F32) @ af[:, cols].T
    return g.to(_BF16)


def _dict_emulation(my, mask, x, d):
    """csrc/grad_dict_packed.cu's bf16 instance in plain torch: per row
    chunk (``grad_dict_packed_rows``), 32-row stages with R = x_s d per
    64-deep chunk added in f32, E = bf16(f32(mask) R - f32(my)), G += x_s^T
    E in f32 stage by stage; the chunks' partials summed in chunk order."""
    m, n = my.shape
    rows = cuda_dl.grad_dict_packed_rows(m, n)
    xf, df = x.to(_F32), d.to(_F32)
    g = None
    for c0 in range(0, m, rows):
        acc = torch.zeros(d.shape, dtype=_F32)
        for r0 in range(c0, min(c0 + rows, m), 32):
            sl = slice(r0, min(r0 + 32, c0 + rows, m))
            r = _chunked(xf[sl], df)
            e = (mask[sl].to(_F32) * r - my[sl].to(_F32)).to(_BF16)
            acc = acc + xf[sl].T @ e.to(_F32)
        g = acc if g is None else g + acc
    return g


@pytest.mark.parametrize("kind", ["normal", "lognormal"])
@pytest.mark.parametrize("m,n,f", [(256, 320, 128), (333, 257, 7),
                                   (160, 200, 96)])
def test_emulated_rows_kernel_within_the_bf16_limit(m, n, f, kind):
    """The bf16 rows kernel's sum order keeps g within the bf16 limit of
    the twin, on normal and on log-normal data (about six decades)."""
    args = _bf16(_inputs(m + n + f, m, n, f, kind))
    got = _rows_emulation(*args)
    twin = cuda_lasso.masked_grad_rows_plain(*args)
    assert got.dtype == twin.dtype == _BF16
    assert rel_err(_f32(got), _f32(twin)) < _BF16_LIMIT


@pytest.mark.parametrize("kind", ["normal", "lognormal"])
@pytest.mark.parametrize("m,n,k", [(256, 320, 128), (333, 257, 7),
                                   (160, 200, 96)])
def test_emulated_dict_kernel_within_the_bf16_limit(m, n, k, kind):
    """The bf16 dictionary kernel's sum order keeps G within the bf16 limit
    of the twin, on normal and on log-normal data."""
    args = _bf16(_inputs(m * n + k, m, n, k, kind))
    got = _dict_emulation(*args)
    twin = cuda_dl.masked_grad_dict_plain(*args)
    assert rel_err(got.numpy(), twin.numpy()) < _BF16_LIMIT


@pytest.mark.parametrize("f,kt", [(1, 64), (7, 64), (64, 64), (65, 128),
                                  (128, 128)])
def test_one_limb_layout(f, kt):
    """bf16 a (F, N) as the bf16 kernels read it: grad_limbs and
    column_limbs(.., limbs=1) give (N, KT) bf16, row n = a[:, n] with zeros
    past F; the f32 layout keeps its three limbs."""
    rng = np.random.default_rng(f)
    a = _t(rng.normal(size=(f, 37)).astype(np.float32)).to(_BF16)
    out = cuda_lasso.grad_limbs(a)
    assert cuda_lasso.grad_limb_count(a.dtype) == 1
    assert out.shape == (37, kt) and out.dtype == _BF16
    assert out.is_contiguous()
    assert torch.equal(out[:, :f], a.T)
    assert not out[:, f:].any()
    assert torch.equal(cuda_mu.column_limbs(a, kt, 1), out)
    assert torch.equal(cuda_mu.column_limbs(a, kt, 3)[:, :kt], out)
    assert cuda_lasso.grad_limbs(a.to(_F32)).shape == (37, 3 * kt)


@pytest.mark.parametrize("f", [1, 64, 65, 128])
def test_all_bf16_is_taken(f):
    my, mask, x, a = _bf16(_inputs(4, 20, 40, f))
    bits = cuda_mu.pack_mask(mask)
    cuda_lasso.check_packed_grad_args(my, bits, x, a)
    cuda_lasso.check_packed_grad_args(my, bits, x, a,
                                      cuda_lasso.grad_limbs(a))


@pytest.mark.parametrize("change,error", [
    (dict(x=_F32), texc.DtypeError),
    (dict(a=_F32), texc.DtypeError),
    (dict(my=_F32), texc.DtypeError),
    (dict(my=torch.float64, x=torch.float64, a=torch.float64),
     texc.DtypeError),
    # just past the gate (grad_fits) at N = 40, bf16
    (dict(f=20353), texc.ShapeError),
    (dict(limbs=(40, 3 * 64)), texc.ShapeError),
])
def test_bf16_refusals(change, error):
    """What the bf16 instances do not take is refused before any launch:
    mixed dtypes, f64, F just past the gate, a's limbs in the f32
    (three-limb) shape."""
    if change.get("f", 4) > 4:
        assert cuda_lasso.grad_fits(40, change["f"] - 1, 2)
        assert not cuda_lasso.grad_fits(40, change["f"], 2)
    my, mask, x, a = _bf16(_inputs(5, 20, 40, change.get("f", 4)))
    my, x, a = (t.to(change.get(k, _BF16))
                for k, t in (("my", my), ("x", x), ("a", a)))
    limbs = None
    if "limbs" in change:
        limbs = torch.zeros(change["limbs"], dtype=_BF16)
    with pytest.raises(error):
        cuda_lasso.check_packed_grad_args(my, cuda_mu.pack_mask(mask), x, a,
                                          limbs)


@pytest.fixture
def on_card(monkeypatch):
    """Both masked gradients as if their data lay on the card: the route
    predicate answers as on the card (a meta tensor of the data's dtype),
    and each launch is recorded as (wrapper, route, mask dtype) and
    replaced by the twin on the dense mask."""
    calls = []
    takes = cuda_lasso.grad_takes_packed
    monkeypatch.setattr(
        cuda_lasso, "grad_takes_packed",
        lambda my: takes(torch.empty(0, dtype=my.dtype, device="meta")))

    def launch(wrapper, route, plain):
        def run(my, mask, x, a, *limbs):
            calls.append((wrapper, route, mask.dtype))
            if route == "packed":
                mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
            return plain(my, mask, x, a)
        return run

    for module, wrapper, plain in (
            (cuda_lasso, "masked_grad_rows",
             cuda_lasso.masked_grad_rows_plain),
            (cuda_dl, "masked_grad_dict", cuda_dl.masked_grad_dict_plain)):
        monkeypatch.setattr(module, "_runs_plain", lambda t: False)
        short = "grad" if module is cuda_lasso else "grad_dict"
        for route, kind in (("packed", "packed"), ("dense", "weighted")):
            monkeypatch.setattr(module, f"_{short}_{kind}_launch",
                                launch(wrapper, route, plain))
        w = getattr(module, wrapper)
        for name in ("launches", "packed_launches", "dense_launches"):
            monkeypatch.setattr(w, name, 0)
    return calls


def _lasso_problem(seed, m=40, n=48, f=12, weighted=False):
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    if weighted:
        mask = mask * rng.uniform(0.5, 1.0, (m, n)).astype(np.float32)
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    y = (rng.normal(size=(m, n)) * mask).astype(np.float32)
    return (_t(v).to(_BF16) for v in (y, a, mask))


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_lasso_routes_as_on_the_card(monkeypatch, on_card, weighted):
    """Masked bf16 lasso.solve with the card's routes faked: a 0/1 mask is
    packed once per solve and every gradient launch counts as packed; a
    weighted mask is refused by pack_mask and every launch stays dense."""
    spy = _RouteSpy(monkeypatch)
    y, a, mask = _lasso_problem(60, weighted=weighted)
    res = tl.solve(y, a, ALPHA, mask=mask, method="fista", tol=0.0,
                   maxiter=7, use_kernel=True, device="cpu")
    w = cuda_lasso.masked_grad_rows
    assert res.niter == 7
    assert spy.packed == [not weighted]
    routes = (0, 7) if weighted else (7, 0)
    assert (w.packed_launches, w.dense_launches, w.launches) == routes + (7,)
    want = ("dense", _BF16) if weighted else ("packed", torch.int32)
    assert [c[1:] for c in on_card] == [want] * 7


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_dictionary_learning_routes_as_on_the_card(monkeypatch, on_card,
                                                        weighted):
    """Masked bf16 dictionary_learning.solve with the card's routes faked:
    a 0/1 mask is packed once per solve, and each outer iteration's 3 inner
    gradients and its dictionary gradient all count as packed; a weighted
    mask keeps every launch of both on the dense routes."""
    spy = _RouteSpy(monkeypatch)
    rng = np.random.default_rng(61)
    y, _, mask = _lasso_problem(62, m=60, n=24, weighted=weighted)
    d0 = _t(rng.normal(size=(6, 24)).astype(np.float32)).to(_BF16)
    res = tdl.solve(y, d0, ALPHA, mask=mask, use_kernel=True, device="cpu",
                    tol=0.0, maxiter=4, lasso_iter=3, lasso_tol=0.0)
    assert res.niter == 4
    assert spy.packed == [not weighted]
    rows, dic = cuda_lasso.masked_grad_rows, cuda_dl.masked_grad_dict
    got = ((rows.packed_launches, rows.dense_launches),
           (dic.packed_launches, dic.dense_launches))
    want = (((0, 12), (0, 4)) if weighted else ((12, 0), (4, 0)))
    assert got == want
    route = ("dense", _BF16) if weighted else ("packed", torch.int32)
    assert {c[1:] for c in on_card} == {route}
