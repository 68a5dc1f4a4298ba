"""KL-MU above rank 128 in the PyTorch port: the wide route of
``kl_stats_dense`` and ``kl_stats_masked``, which on the card runs
``csrc/mu_wide.cu``'s KL entries (f32 data as bf16x6, bf16 in one limb, on
packed and weighted masks) for every rank inside the TPU kernels' KL gate
(``cuda_mu.rank_fits`` with ``kl_dense`` / ``kl_masked``). On the CPU the
wrappers run their twins, held here against ``decomp_tpu``'s Pallas KL
kernels in interpret mode on zero-padded inputs at K = 129, 200 and 256
(one Pallas reference per case, kept by a module-scoped fixture); then the
gate's KL corners, the routes with the card's launches faked (in core,
streamed in loader mode and sharded on a gloo world of 1), ``nmf.solve``
at rank 200 through ``use_kernel=True`` against ``decomp_tpu``'s Pallas
route, and a plain emulation of the wide route's sum order on log-normal
data against f64. The same numpy inputs, made from a seed, go through both
packages. The CUDA kernels themselves run only on the card
(``chip_smoke.py`` phase 4d, ``tools/kl_wide_turns.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import decomp_tpu
from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch import parallel
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.models import nmf_streaming as tns
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_grad_wide import _stage_prod, _wide_prod

_BF16, _F32 = torch.bfloat16, torch.float32
EPS = 1e-6
# The twins against the Pallas kernels: 1e-5 f32 (both sum in f32, in
# other orders), 1e-3 bf16 (the ratio, x_new and cdt(x_new) are rounded to
# bf16, so a one-ulp f32 difference flips a rounding), the limits of
# tests/test_torch_mu_wide.py.
_LIMIT = {_F32: 1e-5, _BF16: 1e-3}
# chip_smoke.py's limit for the f32 kernels against their twin.
_F32_KERNEL_LIMIT = 2e-6
_RANKS = [129, 200, 256]
_M, _N = 40, 130
_KINDS = ["dense", "binary", "weighted"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, m, n, k, kind):
    """f32 numpy (y or my, mask, x, d): y uniform in [0, 1); masked kinds
    with 30% missing, my = mask * y, the mask 0/1 (``binary``) or its
    observed entries weighted in [0.5, 1) (``weighted``); x and d in
    [0.1, 1.1)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    if kind == "weighted":
        mask *= rng.uniform(0.5, 1.0, (m, n))
    y = rng.random((m, n))
    if kind != "dense":
        y *= mask
    x = 0.1 + rng.random((m, k))
    d = 0.1 + rng.random((k, n))
    return tuple(v.astype(np.float32) for v in (y, mask, x, d))


def _pad(v, rows, cols):
    return np.pad(v, ((0, rows - v.shape[0]), (0, cols - v.shape[1])))


def _pallas(kind, arrays, dtype):
    """decomp_tpu's kl_stats_dense or kl_stats_masked in interpret mode on
    zero-padded inputs (N and K in multiples of 128, M in whole 16-row
    blocks; zero rows and atoms stay zero and add nothing to the
    statistics), every input in ``dtype`` (the KL kernels take x in the
    data's dtype), cut back."""
    y, mask, x, d = arrays
    (m, n), k = y.shape, d.shape[0]
    mp, np_, kp = -(-m // 16) * 16, -(-n // 128) * 128, -(-k // 128) * 128
    jdt = jnp.float32 if dtype == _F32 else jnp.bfloat16
    yj, mj, xj, dj = (jnp.asarray(_pad(v, r, c), jdt) for v, r, c in
                      ((y, mp, np_), (mask, mp, np_), (x, mp, kp),
                       (d, kp, np_)))
    if kind == "dense":
        out = pallas_mu.kl_stats_dense(yj, xj, dj, EPS, block_rows=16,
                                       interpret=True)
    else:
        out = pallas_mu.kl_stats_masked(yj, mj, xj, dj, EPS, block_rows=16,
                                        interpret=True)
    x_new, numd, last = (np.asarray(o, np.float32) for o in out)
    return (x_new[:m, :k], numd[:k, :n],
            last[:, :k] if kind == "dense" else last[:k, :n])


@pytest.fixture(scope="module")
def pallas_ref():
    """(kind, dtype, K) -> (inputs, Pallas outputs), each case's Pallas
    reference computed once for the module."""
    cache = {}

    def get(kind, dtype, k):
        key = (kind, dtype, k)
        if key not in cache:
            arrays = _inputs(k + 7 * _KINDS.index(kind), _M, _N, k, kind)
            cache[key] = (arrays, _pallas(kind, arrays, dtype))
        return cache[key]

    return get


def _port(kind, arrays, dtype):
    """The port's wrapper on the CPU (its twin; a 0/1 mask as its bits),
    every input in ``dtype``."""
    y, mask, x, d = (_t(v).to(dtype) for v in arrays)
    if kind == "dense":
        return cuda_mu.kl_stats_dense(y, x, d, EPS)
    if kind == "binary":
        mask = cuda_mu.pack_mask(mask)
        assert mask.dtype == torch.int32
    return cuda_mu.kl_stats_masked(y, mask, x, d, EPS)


@pytest.mark.parametrize("out", ["x_new", "numd", "xsum or dend"])
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("k", _RANKS)
def test_twins_match_pallas(pallas_ref, k, dtype, kind, out):
    """kl_stats_dense and kl_stats_masked above rank 128 (on CPU: the
    twins, the functions the wide kernels are held to on the card) against
    decomp_tpu's kernels in interpret mode, f32 and bf16, dense, on a 0/1
    mask's bits and on weights: each output."""
    arrays, ref = pallas_ref(kind, dtype, k)
    got = _port(kind, arrays, dtype)
    i = ["x_new", "numd", "xsum or dend"].index(out)
    assert got[i].shape == ref[i].shape
    assert got[i].dtype == (dtype if i == 0 else _F32)
    assert rel_err(got[i].float().numpy(), ref[i]) < _LIMIT[dtype]


# The largest rank the KL gate takes, (N, itemsize) -> (dense, masked);
# None where it takes no rank above 128 (the fused kernels' 128 stays).
# Every N <= 128 at the 128 row.
_KL_CORNERS = {(128, 4): (4480, 3456), (256, 4): (2176, 1664),
               (512, 4): (1024, 768), (1024, 4): (512, 384),
               (2048, 4): (None, None), (4096, 4): (None, None),
               (128, 2): (4864, 3712), (256, 2): (2432, 1792),
               (512, 2): (1152, 896), (1024, 2): (512, 384),
               (2048, 2): (256, None), (4096, 2): (None, None)}


@pytest.mark.parametrize("n,itemsize", sorted(_KL_CORNERS))
def test_kl_gate_corners(n, itemsize):
    """The KL corners of rank_fits (kl_dense / kl_masked, as decomp_tpu's
    solve passes them) that the wide route must take, the next padded rank
    refused, and kernel_takes_rank('kl-mu') on them: every N <= 128 at N =
    128's corner."""
    dt = _F32 if itemsize == 4 else _BF16
    for masked, k in zip((False, True), _KL_CORNERS[n, itemsize]):
        for n_ in ((1, 64, n) if n == 128 else (n,)):
            if k is None:
                assert not cuda_mu.rank_fits(n_, 129, itemsize, True,
                                             kl_masked=masked,
                                             kl_dense=not masked)
                assert not cuda_mu.kernel_takes_rank("kl-mu", n_, 129, dt,
                                                     masked)
                assert cuda_mu.kernel_takes_rank("kl-mu", n_, 128, dt,
                                                 masked)
                continue
            assert cuda_mu.rank_fits(n_, k, itemsize, True, kl_masked=masked,
                                     kl_dense=not masked)
            assert not cuda_mu.rank_fits(n_, k + 1, itemsize, True,
                                         kl_masked=masked,
                                         kl_dense=not masked)
            assert cuda_mu.kernel_takes_rank("kl-mu", n_, k, dt, masked)
            assert not cuda_mu.kernel_takes_rank("kl-mu", n_, k + 1, dt,
                                                 masked)


@pytest.fixture
def on_card(monkeypatch):
    """The KL wrappers as if their data lay on the card: each launch (the
    wide ones and the fused ones) runs its route's own argument checks, is
    recorded (wrapper, route, mask dtype) and replaced by the twin (a
    packed mask unpacked first); nmf.solve packs a 0/1 mask where the card
    would (f32 data, ``kl_takes_packed``); no library is built or
    called."""
    calls = []

    def no_build(*_):
        raise AssertionError("a kernel library was reached")

    def dense(route, gate):
        def run(my, x, d, eps, block_rows=None):
            cuda_mu._check_kernel_args(my, x, d, 1, 256, wide_x=False,
                                       gate=gate, method="kl-mu")
            calls.append(("kl_stats_dense", route, None))
            return cuda_mu.kl_stats_dense_plain(my, x, d, eps)
        return run

    def masked(route, gate):
        def run(my, mask, x, d, eps, block_rows=None):
            kw = {} if mask.dtype == torch.int32 else {"mask": mask}
            if mask.dtype == torch.int32:
                cuda_mu._check_packed(my, mask)
            cuda_mu._check_kernel_args(my, x, d, 1, 256, wide_x=False,
                                       gate=gate, method="kl-mu", **kw)
            calls.append(("kl_stats_masked", route, mask.dtype))
            if mask.dtype == torch.int32:
                mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
            return cuda_mu.kl_stats_masked_plain(my, mask, x, d, eps)
        return run

    dense_mask = masked("dense", None)

    def masked_launch(wrapper, *a):
        assert wrapper is cuda_mu.kl_stats_masked
        wrapper.launches += 1
        return dense_mask(*a)

    card_route = cuda_mu.kl_dense_route
    monkeypatch.setattr(cuda_mu, "_c_function", no_build)
    monkeypatch.setattr(cuda_mu, "_runs_plain", lambda t: False)
    monkeypatch.setattr(cuda_mu, "kl_dense_route",
                        lambda dtype, device: card_route(dtype, "cuda"))
    monkeypatch.setattr(cuda_mu, "kl_takes_packed",
                        lambda my: my.dtype == torch.float32)
    monkeypatch.setattr(cuda_mu, "_kl_dense_wide_launch",
                        dense("wide", "dense"))
    monkeypatch.setattr(cuda_mu, "_kl_dense_packed_launch",
                        dense("packed", None))
    monkeypatch.setattr(cuda_mu, "_kl_dense_mu_launch", dense("mu_kl", None))
    monkeypatch.setattr(cuda_mu, "_kl_masked_wide_launch",
                        masked("wide", "masked"))
    monkeypatch.setattr(cuda_mu, "_kl_packed_launch", masked("packed", None))
    monkeypatch.setattr(cuda_mu, "_masked_launch", masked_launch)
    for w, names in ((cuda_mu.kl_stats_dense, ("launches", "packed_launches",
                                               "mu_kl_launches",
                                               "wide_launches")),
                     (cuda_mu.kl_stats_masked, ("launches", "packed_launches",
                                                "dense_launches",
                                                "wide_launches"))):
        for name in names:
            monkeypatch.setattr(w, name, 0)
    return calls


def _port_args(kind, seed, m, n, k, dtype):
    y, mask, x, d = (_t(v).to(dtype) for v in _inputs(seed, m, n, k, kind))
    if kind == "binary":
        mask = cuda_mu.pack_mask(mask)
    return y, mask, x, d


def _call(kind, y, mask, x, d):
    if kind == "dense":
        return cuda_mu.kl_stats_dense(y, x, d, EPS)
    return cuda_mu.kl_stats_masked(y, mask, x, d, EPS)


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_rank_129_takes_the_wide_route(on_card, dtype, kind):
    """On the card K = 129 sends kl_stats_dense and kl_stats_masked, on
    bits or on a dense mask, to the wide launch (.wide_launches and
    .launches), never to a fused route; the route gives the twin's
    function."""
    y, mask, x, d = _port_args(kind, 3, 30, 50, 129, dtype)
    out = _call(kind, y, mask, x, d)
    if kind == "dense":
        w = cuda_mu.kl_stats_dense
        ref = cuda_mu.kl_stats_dense_plain(y, x, d, EPS)
    else:
        w = cuda_mu.kl_stats_masked
        dense_mask = (cuda_mu.unpack_mask(mask, 50, dtype)
                      if kind == "binary" else mask)
        ref = cuda_mu.kl_stats_masked_plain(y, dense_mask, x, d, EPS)
    assert [c[1] for c in on_card] == ["wide"]
    assert (w.wide_launches, w.launches) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_rank_128_stays_fused(on_card, dtype, kind):
    """K = 128 stays on the fused KL routes (f32 dense: kl_dense_packed.cu,
    bf16 dense: mu_kl_stats.cu; bits: kl_masked_packed.cu; a dense mask:
    mu_kl_stats.cu), through the wrappers and through
    nmf.solve(method='kl-mu', use_kernel=True); none reaches the wide
    launch."""
    y, mask, x, d = _port_args(kind, 4, 20, 60, 128, dtype)
    want = {"dense": "packed" if dtype == _F32 else "mu_kl",
            "binary": "packed", "weighted": "dense"}[kind]
    if kind == "binary" and dtype == _BF16:
        # nmf.solve keeps bf16's 0/1 mask dense (kl_takes_packed).
        want = "dense"
        mask = cuda_mu.unpack_mask(mask, 60, dtype)
    _call(kind, y, mask, x, d)
    assert [c[1] for c in on_card] == [want]
    del on_card[:]
    dense_mask = None
    if kind != "dense":
        dense_mask = (cuda_mu.unpack_mask(mask, 60, dtype)
                      if mask.dtype == torch.int32 else mask)
    res = tnmf.solve(y, d, x=x, mask=dense_mask, method="kl-mu", tol=0.0,
                     maxiter=2, use_kernel=True)
    assert res.niter == 2 and [c[1] for c in on_card] == [want] * 2


@pytest.mark.parametrize("masked", [False, True])
def test_past_the_gate_refused_or_composed(on_card, masked):
    """Past the KL gate (N = 2,048, f32, K = 129: rank_fits takes no KL rank
    above 128 there) use_kernel=True raises ShapeError before any launch,
    in nmf.solve, loader mode's gate and the wrappers; 'auto' keeps the
    composition there (nmf._auto_rank, loader mode's gate)."""
    n, k = 2048, 129
    kind = "binary" if masked else "dense"
    y, mask, x, d = _port_args(kind, 5, 8, n, k, _F32)
    dense_mask = cuda_mu.unpack_mask(mask, n, _F32) if masked else None
    with pytest.raises(texc.ShapeError, match="rank_fits"):
        tnmf.solve(y, d, x=x, mask=dense_mask, method="kl-mu", tol=0.0,
                   maxiter=2, use_kernel=True)
    with pytest.raises(texc.ShapeError, match="rank_fits"):
        _call(kind, y, mask, x, d)
    with pytest.raises(texc.ShapeError, match="rank_fits"):
        tns._chunk_kernel_gate(
            True, on_cuda=True, method="kl-mu", mixed=False,
            record_objective=False, rank=k, n=n, y_dtype=_F32, fdt=_F32,
            masked=masked, inner_iter=1)
    assert on_card == []
    assert not tnmf._auto_rank("kl-mu", n, k, _F32, masked, _F32)
    assert not tns._chunk_kernel_gate(
        "auto", on_cuda=True, method="kl-mu", mixed=False,
        record_objective=False, rank=k, n=n, y_dtype=_F32, fdt=_F32,
        masked=masked, inner_iter=1)
    assert tnmf._auto_rank("kl-mu", n, 128, _F32, masked, _F32)
    res = tnmf.solve(y, d, x=x, mask=dense_mask, method="kl-mu", tol=0.0,
                     maxiter=2)
    assert res.niter == 2 and on_card == []


@pytest.mark.parametrize("kind", _KINDS)
def test_loader_mode_takes_the_wide_route(on_card, kind):
    """Loader mode's solve_streaming(method='kl-mu', use_kernel=True) at
    rank 200 launches every chunk's wrapper on the wide route (a 0/1 mask
    as bits, weights as they are), and no fused route."""
    y, mask, x, d = _inputs(7, 48, 60, 200, kind)
    yy = _inputs(7, 48, 60, 200, "dense")[0]
    name = "kl_stats_dense" if kind == "dense" else "kl_stats_masked"
    res = tns.solve_streaming(
        lambda lo, hi: yy[lo:hi], d, x=x,
        mask=None if kind == "dense" else (lambda lo, hi: mask[lo:hi]),
        rank=200, n_samples=48, n_channels=60, chunk_rows=16, tol=0.0,
        maxiter=2, method="kl-mu", x_device=True, jit_loader=True,
        use_kernel=True, dtype=_F32, device="cpu")
    assert res.niter == 2 and len(on_card) == 6
    assert {c[:2] for c in on_card} == {(name, "wide")}


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, and its mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("masked", [False, True])
def test_sharded_solve_takes_the_wide_route(on_card, world_of_one, masked):
    """parallel.nmf.solve(method='kl-mu') on a gloo world of 1, rank 200,
    use_kernel=True (the card's launches faked): every iteration on the
    wide route, the one-process solve's bits; past the gate ShapeError."""
    kind = "binary" if masked else "dense"
    y, mask, x, d = (_t(v) for v in _inputs(8, 40, 70, 200, kind))
    mask = mask if masked else None
    kw = dict(tol=0.0, maxiter=3, mask=mask, method="kl-mu", use_kernel=True)
    res = parallel.nmf.solve(y, d, x=x, mesh=world_of_one, **kw)
    assert res.niter == 3 and {c[1] for c in on_card} == {"wide"}
    assert len(on_card) == 3
    ref = tnmf.solve(y, d, x=x, **kw)
    assert torch.equal(res.x, ref.x) and torch.equal(res.d, ref.d)
    y2, m2, x2, d2 = (_t(v) for v in _inputs(9, 8, 2048, 129, kind))
    with pytest.raises(texc.ShapeError):
        parallel.nmf.solve(y2, d2, x=x2, mesh=world_of_one, tol=0.0,
                           maxiter=1, mask=m2 if masked else None,
                           method="kl-mu", use_kernel=True)


@pytest.mark.parametrize("masked", [False, True])
def test_solve_rank_200_matches_pallas(masked):
    """nmf.solve(method='kl-mu', rank=200, use_kernel=True) on the CPU
    (every iteration through the KL twin, the wide kernels' function; a
    0/1 mask as its bits) against decomp_tpu's Pallas route in interpret
    mode from the same x and d, f32, 6 fixed iterations: 1e-4, the limit
    of tests/test_torch_mu_wide.py's solve test."""
    kind = "binary" if masked else "dense"
    y, mask, x0, d0 = _inputs(10 + masked, 48, 128, 200, kind)
    mask = mask if masked else None
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, method="kl-mu",
                              tol=0.0, maxiter=6, use_pallas=True,
                              pallas_block_rows=16, _pallas_interpret=True)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0),
                    mask=None if mask is None else _t(mask), method="kl-mu",
                    tol=0.0, maxiter=6, use_kernel=True,
                    kernel_block_rows=16)
    assert rt.niter == 6 and rt.x.shape == (48, 200)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def _emulate(kind, my, mask, x, d, limbs):
    """The wide KL route's f32 arithmetic in plain torch, in its sum order:
    the ratio's products as wide_resid sums them (64-deep chunks, the big
    and the small chains added chunk by chunk), num = E1 d^T and den = mask
    d^T over 32-column stages (wide_rows), the statistics over 32-row
    stages of each row chunk (cuda_mu.wide_dict_rows), the chunks'
    partials summed in order, xsum over row chunks (cuda_mu.wide_sum_rows)
    summed in order. Each division rounded as f32 does."""
    m, n = my.shape
    kp = -(-d.shape[0] // 128) * 128

    def stat(e, xn):
        rows = cuda_mu.wide_dict_rows(m, e.shape[1], kp)
        g = None
        for c0 in range(0, m, rows):
            sl = slice(c0, c0 + rows)
            part = _stage_prod(e[sl].T, xn[sl], limbs, 32).T
            g = part if g is None else g + part
        return g

    def ratio(xc):
        return my / (_wide_prod(xc, d, limbs) + EPS)

    num = _stage_prod(ratio(x), d.T, limbs, 32)
    den = (cuda_mu._dsum(d) if kind == "dense"
           else _stage_prod(mask, d.T, limbs, 32))
    xn = x * num / (den + EPS)
    if kind == "dense":
        rows = cuda_mu.wide_sum_rows(m, kp)
        last = sum(xn[c0:c0 + rows].sum(0, keepdim=True)
                   for c0 in range(0, m, rows))
    else:
        last = stat(mask, xn)
    return xn, stat(ratio(xn), xn), last


def _f64(kind, my, mask, x, d):
    """The KL step in f64 throughout."""
    my, mask, x, d = (t.double() for t in (my, mask, x, d))
    num = (my / (x @ d + EPS)) @ d.T
    den = d.sum(1)[None, :] if kind == "dense" else mask @ d.T
    xn = x * num / (den + EPS)
    numd = xn.T @ (my / (xn @ d + EPS))
    return xn, numd, (xn.sum(0, keepdim=True) if kind == "dense"
                      else xn.T @ mask)


@pytest.mark.parametrize("kind", ["dense", "binary"])
@pytest.mark.parametrize("k", [200, 640])
def test_bf16x6_emulation_on_lognormal_data(kind, k):
    """The wide KL route's sum order, emulated in plain torch on log-normal
    my, x and d over six decades: bf16x6 stays within chip_smoke.py's f32
    limit of f64 and of the full-f32 twin; two limbs (bf16x3) do not."""
    rng = np.random.default_rng(k + 1)
    m, n = 96, 64
    ln10 = np.log(10.0)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    y, x, d = (np.exp(ln10 * rng.standard_normal(s)).astype(np.float32)
               for s in ((m, n), (m, k), (k, n)))
    if kind != "dense":
        y = y * mask
    y, mask, x, d = (_t(v) for v in (y, mask, x, d))
    ref = _f64(kind, y, mask, x, d)
    if kind == "dense":
        twin = cuda_mu.kl_stats_dense_plain(y, x, d, EPS)
    else:
        twin = cuda_mu.kl_stats_masked_plain(y, mask, x, d, EPS)
    six = _emulate(kind, y, mask, x, d, 3)
    three = _emulate(kind, y, mask, x, d, 2)
    errs6 = [rel_err(a.numpy(), b.numpy()) for a, b in zip(six, ref)]
    errs_twin = [rel_err(a.numpy(), b.numpy()) for a, b in zip(six, twin)]
    errs3 = [rel_err(a.numpy(), b.numpy()) for a, b in zip(three, ref)]
    assert max(errs6) < _F32_KERNEL_LIMIT, errs6
    assert max(errs_twin) < _F32_KERNEL_LIMIT, errs_twin
    assert max(errs3) > _F32_KERNEL_LIMIT, errs3
