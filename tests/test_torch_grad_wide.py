"""The masked gradients above 128 features in the PyTorch port: the wide
route of ``masked_grad_rows`` and ``masked_grad_dict``, which on the card
runs ``csrc/grad_wide.cu`` (f32 data as bf16x6, bf16 in one limb, on packed
and weighted masks) for every F and K inside the TPU kernels' gate
(``cuda_lasso.grad_fits``). On the CPU the wrappers run their twins, held
here against ``decomp_tpu``'s Pallas kernels in interpret mode at ragged
shapes with F = K in {129, 200, 256, 300}; then the gate against
``pallas_lasso.fits_vmem``, the wide limbs' layout, a plain emulation of
the kernels' sum order on log-normal data, masked ``lasso.solve`` and
``dictionary_learning.solve`` with 256 atoms through ``use_kernel=True``
against ``decomp_tpu``'s Pallas route, and the routes with the card's
launches faked (in core, streamed and sharded on a gloo world of 1). The
same numpy inputs, made from a seed, go through both packages. The CUDA
kernels themselves run only on the card (``chip_smoke.py`` phases 9 and
13, ``tools/grad_wide_turns.py``)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import decomp_tpu
from decomp_tpu.ops import pallas_lasso
from decomp_tpu_torch import dictionary_learning as tdl_api
from decomp_tpu_torch import parallel
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.models import lasso as tl
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err

ALPHA = 0.05
_BF16, _F32 = torch.bfloat16, torch.float32
# The twins against the Pallas kernels: 1e-5 f32, 1e-3 bf16, the limits of
# tests/test_torch_grad_weighted.py (E is rounded to bf16 before the second
# product, and g stored in bf16, so a one-ulp f32 difference flips a
# rounding).
_LIMIT = {_F32: 1e-5, _BF16: 1e-3}
# chip_smoke.py's limit for the f32 kernels against their twin.
_F32_KERNEL_LIMIT = 2e-6
_SHAPES = [(37, 70, 129), (33, 257, 200), (9, 100, 256), (70, 129, 300)]
_MASKS = ["packed", "binary", "uniform", "lognormal"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, m, n, f, kind):
    """f32 numpy (my, mask, x, a): a 0/1 mask (``packed``, ``binary``) or
    weights on the observed entries (uniform in [0.5, 1), or log-normal
    over four decades), 30% missing; my = mask * y; x and a normal, a
    scaled by 1/sqrt(N)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    if kind == "uniform":
        mask *= rng.uniform(0.5, 1.0, (m, n))
    elif kind == "lognormal":
        mask *= np.exp(np.log(10.0) / 1.5 * rng.standard_normal((m, n)))
    y = rng.normal(size=(m, n))
    x = rng.normal(size=(m, f))
    a = rng.normal(size=(f, n)) / np.sqrt(n)
    return tuple(v.astype(np.float32) for v in (y * mask, mask, x, a))


def _pad(v, rows, cols):
    return np.pad(v, ((0, rows - v.shape[0]), (0, cols - v.shape[1])))


def _pallas(fn, arrays, dtype):
    """decomp_tpu's ``fn`` in interpret mode on zero-padded inputs (N and F
    in multiples of 128, M in whole 16-row blocks; a padded entry has mask
    0 and my 0, so E is 0 there), in ``dtype``, cut back."""
    my, mask, x, a = arrays
    (m, n), f = my.shape, a.shape[0]
    mp, np_, fp = -(-m // 16) * 16, -(-n // 128) * 128, -(-f // 128) * 128
    jdt = jnp.float32 if dtype == _F32 else jnp.bfloat16
    out = fn(*(jnp.asarray(_pad(v, r, c), jdt) for v, r, c in
               ((my, mp, np_), (mask, mp, np_), (x, mp, fp), (a, fp, np_))),
             block_rows=16, interpret=True)
    out = np.asarray(out, np.float32)
    return out[:m, :f] if fn is pallas_lasso.masked_grad_rows else out[:f, :n]


def _port_args(arrays, dtype, kind):
    my, mask, x, a = (_t(v).to(dtype) for v in arrays)
    if kind == "packed":
        mask = cuda_mu.pack_mask(mask)
        assert mask.dtype == torch.int32
    return my, mask, x, a


@pytest.mark.parametrize("kind", _MASKS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("m,n,f", _SHAPES)
def test_rows_twin_matches_pallas(m, n, f, dtype, kind):
    """masked_grad_rows above 128 features (on CPU: its twin, the function
    the wide kernel is held to on the card; a packed mask unpacked first)
    against decomp_tpu's masked_grad_rows in interpret mode: g (M, F) in
    the data's dtype."""
    arrays = _inputs(m * n + f, m, n, f, kind)
    ref = _pallas(pallas_lasso.masked_grad_rows, arrays, dtype)
    got = cuda_lasso.masked_grad_rows(*_port_args(arrays, dtype, kind))
    assert got.dtype == dtype and got.shape == (m, f)
    assert rel_err(got.to(_F32).numpy(), ref) < _LIMIT[dtype]


@pytest.mark.parametrize("kind", _MASKS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("m,n,k", _SHAPES)
def test_dict_twin_matches_pallas(m, n, k, dtype, kind):
    """masked_grad_dict above 128 atoms against decomp_tpu's
    masked_grad_dict in interpret mode: G (K, N) in f32."""
    arrays = _inputs(m * n + k + 1, m, n, k, kind)
    ref = _pallas(pallas_lasso.masked_grad_dict, arrays, dtype)
    got = cuda_dl.masked_grad_dict(*_port_args(arrays, dtype, kind))
    assert got.dtype == _F32 and got.shape == (k, n)
    assert rel_err(got.numpy(), ref) < _LIMIT[dtype]


# The gate's corners (f32 / bf16 at N = 1,024 and at N <= 128), one past
# each, and shapes between.
@pytest.mark.parametrize("n,f,itemsize", [
    (1024, 1152, 4), (1024, 1153, 4), (1024, 2432, 2), (1024, 2433, 2),
    (128, 10112, 4), (128, 10113, 4), (128, 20352, 2), (128, 20353, 2),
    (1, 10112, 4), (100, 20353, 2), (129, 5056, 4), (129, 5057, 4),
    (1024, 256, 4), (100_000, 1, 4), (100_000, 1, 2), (2048, 576, 4),
    (2049, 512, 4), (1000, 129, 2),
])
def test_grad_fits_is_the_pallas_gate(n, f, itemsize):
    """cuda_lasso.grad_fits is decomp_tpu's fits_vmem on the padding of
    kernel_alignment (N and F rounded up to 128)."""
    _, n_pad, f_pad, _ = pallas_lasso.kernel_alignment(64, n, f, itemsize)
    assert cuda_lasso.grad_fits(n, f, itemsize) == pallas_lasso.fits_vmem(
        n_pad, f_pad, itemsize)


def test_gate_corners():
    """The corners the wide route must take, and one past each."""
    for n, f, itemsize in ((1024, 1152, 4), (1024, 2432, 2), (128, 10112, 4),
                           (128, 20352, 2)):
        assert cuda_lasso.grad_fits(n, f, itemsize)
        assert not cuda_lasso.grad_fits(n, f + 1, itemsize)
    assert cuda_lasso.grad_route(128) == "fused"
    assert cuda_lasso.grad_route(129) == "wide"
    assert [cuda_lasso.grad_width(f) for f in (1, 64, 65, 128, 129, 256,
                                               257, 10112)] == [
        64, 64, 128, 128, 256, 256, 384, 10112]


def _split_layout(t, width, limbs):
    """(N, limbs width) bf16 from split_bf16x3 by hand: row n = [limb 0 of
    t[:, n] | limb 1 | limb 2], each zero past K."""
    k, n = t.shape
    parts = cuda_mu.split_bf16x3(t)[:limbs]
    out = torch.zeros((n, limbs * width), dtype=_BF16)
    for l in range(limbs):
        out[:, l * width:l * width + k] = parts[l].T
    return out


@pytest.mark.parametrize("k", [129, 200, 256, 300])
def test_wide_limbs_layout(k):
    """The wide route's limbs bit for bit against split_bf16x3: a's and
    d's (grad_limbs, column_limbs at grad_width(K)), three limbs for f32
    and bf16 a itself (one limb), and x's as the split launch writes them
    (cuda_dl._split_rows: on CPU column_limbs(x^T, width))."""
    rng = np.random.default_rng(k)
    n, m = 70, 33
    width = cuda_lasso.grad_width(k)
    assert width == -(-k // 128) * 128
    a = _t(np.exp(np.log(10.0) * rng.standard_normal((k, n))).astype(
        np.float32))
    x = _t(rng.normal(size=(m, k)).astype(np.float32))
    assert torch.equal(cuda_lasso.grad_limbs(a), _split_layout(a, width, 3))
    assert torch.equal(cuda_mu.column_limbs(a, width, 3),
                       _split_layout(a, width, 3))
    ab = a.to(_BF16)
    assert torch.equal(cuda_lasso.grad_limbs(ab), _split_layout(ab, width, 1))
    assert torch.equal(cuda_lasso.grad_limbs(ab)[:, :k], ab.T)
    assert torch.equal(cuda_dl._split_rows(x, width),
                       _split_layout(x.T, width, 3))


def _wide_prod(a, b, limbs):
    """a @ b as wide_resid sums R: per 64-deep chunk the big chain a0 b0
    and the small chain (every other a_i b_j with i + j < limbs), each in
    f32, their sum added to R with f32 adds, chunk by chunk."""
    pa = [t.to(_F32) for t in cuda_mu.split_bf16x3(a)[:limbs]]
    pb = [t.to(_F32) for t in cuda_mu.split_bf16x3(b)[:limbs]]
    r = torch.zeros((a.shape[0], b.shape[1]), dtype=_F32)
    for c in range(0, a.shape[1], 64):
        sl = slice(c, c + 64)
        big = pa[0][:, sl] @ pb[0][sl]
        small = sum(pa[i][:, sl] @ pb[j][sl] for i in range(limbs)
                    for j in range(limbs) if 0 < i + j < limbs)
        r = r + (big + small)
    return r


def _stage_prod(a, b, limbs, depth):
    """a @ b as the rows and dictionary kernels sum it: per ``depth``-deep
    stage the big and the small chains in f32, added stage by stage."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=_F32)
    for c in range(0, a.shape[1], depth):
        out = out + _wide_prod(a[:, c:c + depth], b[c:c + depth], limbs)
    return out


def _emulate(kind, my, mask, x, b, limbs):
    """The wide route's f32 arithmetic in plain torch: E = mask R - my from
    _wide_prod, then g = E b^T over 32-column stages, or G^T = E^T x over
    32-row stages of each row chunk (grad_wide_dict_rows), the chunks'
    partials summed in order."""
    e = mask * _wide_prod(x, b, limbs) - my
    if kind == "rows":
        return _stage_prod(e, b.T, limbs, 32)
    m, n = my.shape
    rows = cuda_dl.grad_wide_dict_rows(m, n, b.shape[0])
    g = None
    for c0 in range(0, m, rows):
        sl = slice(c0, c0 + rows)
        part = _stage_prod(e[sl].T, x[sl], limbs, 32).T
        g = part if g is None else g + part
    return g


@pytest.mark.parametrize("kind", ["rows", "dict"])
@pytest.mark.parametrize("f", [300, 1152])
def test_bf16x6_emulation_on_lognormal_data(kind, f):
    """The wide route's sum order, emulated in plain torch on log-normal
    my, x and b over six decades (F = K up to the f32 corner at N = 1,024:
    the chain of R is 18 chunk adds): bf16x6 stays within chip_smoke.py's
    f32 limit of the full-f32 twin and of f64, two limbs (bf16x3) do not."""
    rng = np.random.default_rng(f)
    m, n = 96, 64
    ln10 = np.log(10.0)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    y, x, b = (np.exp(ln10 * rng.standard_normal(s)).astype(np.float32)
               for s in ((m, n), (m, f), (f, n)))
    my, mask, x, b = (_t(v) for v in (y * mask, mask, x, b))
    plain = (cuda_lasso.masked_grad_rows_plain if kind == "rows"
             else cuda_dl.masked_grad_dict_plain)
    twin = plain(my, mask, x, b)
    xd, bd = x.double(), b.double()
    e64 = mask.double() * (xd @ bd) - my.double()
    exact = e64 @ bd.T if kind == "rows" else xd.T @ e64
    six = _emulate(kind, my, mask, x, b, 3)
    three = _emulate(kind, my, mask, x, b, 2)
    assert rel_err(six.numpy(), twin.numpy()) < _F32_KERNEL_LIMIT
    assert rel_err(six.numpy(), exact.numpy()) < _F32_KERNEL_LIMIT
    assert rel_err(three.numpy(), twin.numpy()) > _F32_KERNEL_LIMIT


def _masked_problem(seed, m, n, f):
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    y = rng.normal(size=(m, n)).astype(np.float32)
    return y, a, mask


def test_masked_lasso_with_256_features_matches_pallas():
    """A masked lasso with 256 features through use_kernel=True (every
    gradient on the wide route; on CPU its twin) against decomp_tpu's
    Pallas route in interpret mode, f32, 10 fixed iterations: 1e-5. N =
    128 and F = 256, so the Pallas route pads nothing."""
    y, a, mask = _masked_problem(80, 40, 128, 256)
    kw = dict(method="fista", tol=0.0, maxiter=10)
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, mask=mask, use_pallas=True,
                                _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, mask=_t(mask), use_kernel=True,
                  device="cpu", **kw)
    assert rt.niter == 10
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


def test_masked_dictionary_learning_with_256_atoms_matches_pallas():
    """Masked dictionary learning with 256 atoms through use_kernel=True
    (both gradients on the wide route) against decomp_tpu's Pallas route
    in interpret mode from the same x and d, f32, 3 outer x 3 inner
    iterations: 1e-5. 64 x 128 data and 256 atoms: nothing padded."""
    y, d0, mask = _masked_problem(81, 64, 128, 256)
    rng = np.random.default_rng(82)
    x0 = (rng.normal(size=(64, 256)) * (rng.random((64, 256)) < 0.3)
          ).astype(np.float32)
    kw = dict(tol=0.0, maxiter=3, lasso_iter=3, lasso_tol=0.0)
    rj = decomp_tpu.dictionary_learning.solve(
        y, d0, ALPHA, x=x0, mask=mask, use_pallas=True,
        _pallas_interpret=True, **kw)
    rt = tdl.solve(_t(y), _t(d0), ALPHA, x=_t(x0), mask=_t(mask),
                   use_kernel=True, device="cpu", **kw)
    assert rt.niter == 3
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


@pytest.fixture
def on_card(monkeypatch):
    """Both masked gradients as if their data lay on the card: each launch
    of a route runs that route's own argument checks, is recorded (wrapper,
    route, mask dtype) and replaced by the twin (a packed mask unpacked
    first); the first designs fail if reached."""
    calls = []

    def launch(wrapper, route, plain):
        def run(my, mask, x, a, *limbs):
            if route == "wide":
                cuda_lasso.check_wide_args(my, mask, x, a, *limbs)
            elif route == "packed":
                cuda_lasso.check_packed_grad_args(my, mask, x, a, *limbs)
            else:
                cuda_lasso.check_weighted_grad_args(my, mask, x, a)
            calls.append((wrapper, route, mask.dtype))
            if mask.dtype == torch.int32:
                mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
            return plain(my, mask, x, a)
        return run

    def first(*args):
        raise AssertionError("a first design was launched on a route")

    for module, wrapper, plain, launches in (
            (cuda_lasso, "masked_grad_rows", cuda_lasso.masked_grad_rows_plain,
             {"_grad_wide_rows_launch": "wide",
              "_grad_packed_launch": "packed",
              "_grad_weighted_launch": "weighted"}),
            (cuda_dl, "masked_grad_dict", cuda_dl.masked_grad_dict_plain,
             {"_grad_dict_wide_launch": "wide",
              "_grad_dict_packed_launch": "packed",
              "_grad_dict_weighted_launch": "weighted"})):
        monkeypatch.setattr(module, "_runs_plain", lambda t: False)
        for name, route in launches.items():
            monkeypatch.setattr(module, name, launch(wrapper, route, plain))
        short = "grad" if module is cuda_lasso else "grad_dict"
        monkeypatch.setattr(module, f"_{short}_dense_mma_launch", first)
        w = getattr(module, wrapper)
        for name in ("launches", "packed_launches", "dense_launches",
                     "wide_launches"):
            monkeypatch.setattr(w, name, 0)
    return calls


def _counts():
    return tuple((w.wide_launches, w.packed_launches, w.dense_launches,
                  w.launches)
                 for w in (cuda_lasso.masked_grad_rows,
                           cuda_dl.masked_grad_dict))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_gradients_route_wide_as_on_the_card(on_card, dtype, weighted):
    """On the card F = K = 129 sends each masked gradient, on bits or on
    weights, to the wide route (.wide_launches and .launches), never to the
    fused kernels or the first designs; the route gives the twin's
    function."""
    arrays = _inputs(7, 30, 50, 129, "uniform" if weighted else "binary")
    args = _port_args(arrays, dtype, "uniform" if weighted else "packed")
    g = cuda_lasso.masked_grad_rows(*args)
    gd = cuda_dl.masked_grad_dict(*args)
    mdt = dtype if weighted else torch.int32
    assert on_card == [("masked_grad_rows", "wide", mdt),
                       ("masked_grad_dict", "wide", mdt)]
    assert _counts() == ((1, 0, 0, 1), (1, 0, 0, 1))
    my, mask, x, a = (_t(v).to(dtype) for v in arrays)
    assert torch.equal(g, cuda_lasso.masked_grad_rows_plain(my, mask, x, a))
    assert torch.equal(gd, cuda_dl.masked_grad_dict_plain(my, mask, x, a))


def test_fused_widths_stay_on_the_fused_route(on_card):
    """F = K = 128 stays on the fused kernels: the wide route starts past
    their tile."""
    args = _port_args(_inputs(8, 30, 50, 128, "binary"), _F32, "packed")
    cuda_lasso.masked_grad_rows(*args)
    cuda_dl.masked_grad_dict(*args)
    assert [c[1] for c in on_card] == ["packed", "packed"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_fused_widths_take_any_n(on_card, dtype, weighted):
    """The gate is the wide route's alone: at F = K = 128 the fused kernels
    take N = 32,768, where grad_fits refuses every width of either dtype,
    so masked lasso.solve and dictionary_learning.solve through
    use_kernel=True run every gradient on the fused route, a's limbs and
    each launch's checks included; one feature more, on the wide route, is
    refused there."""
    n = 32_768
    kind = "uniform" if weighted else "binary"
    y, a, mask = (_t(v).to(dtype) for v in _masked_problem(85, 6, n, 128))
    if weighted:
        mask = mask * _t(_inputs(85, 6, n, 1, "uniform")[1]).to(dtype)
    assert not cuda_lasso.grad_fits(n, 128, dtype.itemsize)
    limbs = cuda_lasso.grad_limbs(a)
    assert limbs.shape == (n, cuda_lasso.grad_limb_count(dtype) * 128)
    route = "weighted" if weighted else "packed"
    res = tl.solve(y, a, ALPHA, mask=mask, method="fista", tol=0.0,
                   maxiter=3, use_kernel=True, device="cpu")
    assert res.niter == 3 and [c[1] for c in on_card] == [route] * 3
    del on_card[:]
    res = tdl.solve(y, a, ALPHA, mask=mask, use_kernel=True, device="cpu",
                    tol=0.0, maxiter=2, lasso_iter=2, lasso_tol=0.0)
    assert res.niter == 2 and {c[1] for c in on_card} == {route}
    assert sum(c[0] == "masked_grad_dict" for c in on_card) == 2
    args = _port_args(_inputs(86, 4, n, 129, kind), dtype,
                      kind if weighted else "packed")
    assert not cuda_lasso.grad_fits(n, 129, dtype.itemsize)
    with pytest.raises(texc.ShapeError, match="grad_fits"):
        cuda_lasso.masked_grad_rows(*args)
    with pytest.raises(texc.ShapeError, match="grad_fits"):
        cuda_dl.masked_grad_dict(*args)


@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_solves_route_wide_as_on_the_card(on_card, dtype):
    """Masked lasso.solve, dictionary_learning.solve and
    dictionary_learning.solve_streaming with 256 atoms, use_kernel=True,
    with the card's launches faked: every gradient of each takes the wide
    route on the bits of the 0/1 mask (packed once per solve, or per
    chunk), none a fused kernel or a first design."""
    y, a, mask = (_t(v).to(dtype) for v in _masked_problem(83, 40, 96, 256))
    bits = ("masked_grad_rows", "wide", torch.int32)
    res = tl.solve(y, a, ALPHA, mask=mask, method="fista", tol=0.0,
                   maxiter=5, use_kernel=True, device="cpu")
    assert res.niter == 5 and on_card == [bits] * 5
    del on_card[:]
    res = tdl.solve(y, a, ALPHA, mask=mask, use_kernel=True, device="cpu",
                    tol=0.0, maxiter=3, lasso_iter=2, lasso_tol=0.0)
    assert res.niter == 3
    assert sorted(set(on_card)) == [
        ("masked_grad_dict", "wide", torch.int32), bits]
    assert _counts() == ((11, 0, 0, 11), (3, 0, 0, 3))
    del on_card[:]
    res = tdl_api.solve_streaming(
        y.numpy() if dtype == _F32 else y.float().numpy(),
        a.float().numpy(), ALPHA, mask=mask.float().numpy(), chunk_rows=16,
        tol=0.0, maxiter=2, lasso_iter=2, lasso_tol=0.0, use_kernel=True,
        device="cpu")
    assert res.niter == 2 and on_card
    assert {c[1] for c in on_card} == {"wide"}


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, and its mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


def test_sharded_solves_route_wide(on_card, world_of_one):
    """The sharded masked lasso and dictionary learning on a gloo world of
    1 (use_kernel=True, the card's launches faked): every gradient on the
    wide route, and the one-process solve's bits."""
    y, a, mask = (_t(v) for v in _masked_problem(84, 40, 96, 200))
    kw = dict(method="fista", tol=0.0, maxiter=4, mask=mask,
              use_kernel=True)
    res = parallel.lasso.solve(y, a, ALPHA, mesh=world_of_one, **kw)
    assert res.niter == 4
    assert {c[1] for c in on_card} == {"wide"} and len(on_card) == 4
    ref = tl.solve(y, a, ALPHA, device="cpu", **kw)
    assert torch.equal(res.x, ref.x)
    del on_card[:]
    res = parallel.dictionary_learning.solve(
        y, a, ALPHA, mesh=world_of_one, mask=mask, use_kernel=True, tol=0.0,
        maxiter=2, lasso_iter=2, lasso_tol=0.0)
    assert res.niter == 2
    assert {c[1] for c in on_card} == {"wide"}
    assert sum(c[0] == "masked_grad_dict" for c in on_card) == 2


@pytest.mark.parametrize("n,f", [(1024, 256), (1024, 1152), (1024, 2432),
                                 (128, 10112), (1024, 2433), (96, 128),
                                 (16_384, 128), (64, 256), (256, 256)])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_auto_rule_for_wide_masks(n, f, dtype):
    """use_kernel='auto' on masked data on the card: F <= 128 always takes
    the fused kernels; above it the wide route inside the gate for the
    dtypes and widths where the card measured it faster than the
    composition (lasso._AUTO_WIDE_DTYPES, N >= lasso._AUTO_WIDE_MIN_N: not
    config 3's N = 64), else the composition. lasso.solve's and
    dictionary_learning.solve's routing, which the streamed and sharded
    solves call, follow the one rule."""
    card = types.SimpleNamespace(is_cuda=True, shape=(10, n))
    want = f <= 128 or (dtype in tl._AUTO_WIDE_DTYPES and n >= 256
                        and cuda_lasso.grad_fits(n, f, dtype.itemsize))
    assert tl._AUTO_WIDE_MIN_N == 256
    assert tl._auto_width(n, f, dtype) is want
    got = tl._kernel_mode("auto", card, object(), "fista", dtype, f, False,
                          False, "highest", torch.tensor(0.1))
    assert (got == "masked") is want
    got = tdl._kernel_mode("auto", card, object(), dtype, f, None, "highest",
                           torch.tensor(0.1))
    assert (got == "masked") is want
