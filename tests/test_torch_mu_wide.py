"""MU above rank 128 in the PyTorch port: the wide route of
``mu_stats_dense`` and ``mu_stats_masked``, which on the card runs
``csrc/mu_wide.cu`` (f32 data as bf16x6, bf16 in one limb, on packed and
weighted masks) for every rank inside the TPU kernels' gate
(``cuda_mu.rank_fits``). On the CPU the wrappers run their twins, held
here against ``decomp_tpu``'s Pallas kernels in interpret mode on
zero-padded inputs at K = 129, 200 and 256 (one Pallas reference per case,
kept by a module-scoped fixture); then the gate against
``pallas_mu.fits_vmem`` and its corners, the routes with the card's
launches faked (in core, streamed and sharded on a gloo world of 1),
``nmf.solve`` and ``masked_completion`` at rank 200 through
``use_kernel=True`` against ``decomp_tpu``'s Pallas route, the 'auto'
rule, and a plain emulation of the wide route's sum order on log-normal
data. The same numpy inputs, made from a seed, go through both packages.
The CUDA kernels themselves run only on the card (``chip_smoke.py`` phase
4c, ``tools/mu_wide_turns.py``)."""

import contextlib

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
# other orders), 1e-3 bf16 (the masked reconstruction and cdt(x_new) are
# rounded to bf16, so a one-ulp f32 difference flips a rounding), the
# limits of tests/test_torch_grad_wide.py.
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
    """decomp_tpu's mu_stats_dense (inner_iter 3) or mu_stats_masked in
    interpret mode on zero-padded inputs (N and K in multiples of 128, M in
    whole 16-row blocks; zero rows and atoms stay zero and add nothing to
    the statistics), the data and d in ``dtype``, x in f32, cut back."""
    y, mask, x, d = arrays
    (m, n), k = y.shape, d.shape[0]
    mp, np_, kp = -(-m // 16) * 16, -(-n // 128) * 128, -(-k // 128) * 128
    jdt = jnp.float32 if dtype == _F32 else jnp.bfloat16
    yj, mj, dj = (jnp.asarray(_pad(v, r, c), jdt) for v, r, c in
                  ((y, mp, np_), (mask, mp, np_), (d, kp, np_)))
    xj = jnp.asarray(_pad(x, mp, kp), jnp.float32)
    if kind == "dense":
        out = pallas_mu.mu_stats_dense(yj, xj, dj, EPS, block_rows=16,
                                       interpret=True, inner_iter=3)
    else:
        out = pallas_mu.mu_stats_masked(yj, mj, xj, dj, EPS, block_rows=16,
                                        interpret=True)
    x_new, numd, last = (np.asarray(o, np.float32) for o in out)
    return x_new[:m, :k], numd[:k, :n], last[:k, :k if kind == "dense" else n]


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
    """The port's wrapper on the CPU (its twin; a 0/1 mask as its bits)."""
    y, mask, x, d = (_t(v) for v in arrays)
    y, d = y.to(dtype), d.to(dtype)
    if kind == "dense":
        return cuda_mu.mu_stats_dense(y, x, d, EPS, inner_iter=3)
    mask = mask.to(dtype)
    if kind == "binary":
        mask = cuda_mu.pack_mask(mask)
        assert mask.dtype == torch.int32
    return cuda_mu.mu_stats_masked(y, mask, x, d, EPS)


@pytest.mark.parametrize("out", ["x_new", "numd", "gram or dend"])
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("k", _RANKS)
def test_twins_match_pallas(pallas_ref, k, dtype, kind, out):
    """mu_stats_dense (inner_iter 3) and mu_stats_masked above rank 128 (on
    CPU: the twins, the functions the wide kernel is held to on the card)
    against decomp_tpu's kernels in interpret mode, f32 and bf16 data with
    f32 x, dense, on a 0/1 mask's bits and on weights: each output."""
    arrays, ref = pallas_ref(kind, dtype, k)
    got = _port(kind, arrays, dtype)
    i = ["x_new", "numd", "gram or dend"].index(out)
    assert got[i].dtype == _F32
    assert got[i].shape == ref[i].shape
    assert rel_err(got[i].numpy(), ref[i]) < _LIMIT[dtype]


def _round128(v):
    return -(-v // 128) * 128


# (masked, kl_masked, kl_dense) as decomp_tpu's solve passes them to
# fits_vmem: masked for a mask or any KL ("kl_like").
_FLAGS = [(False, False, False), (True, False, False), (True, True, False),
          (True, False, True)]


@pytest.mark.parametrize("flags", _FLAGS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rank_fits_is_the_pallas_gate(itemsize, flags):
    """cuda_mu.rank_fits is decomp_tpu's fits_vmem on N and K rounded up
    to 128, at the stripe 'auto' uses, over a grid of widths and ranks."""
    masked, kl_masked, kl_dense = flags
    for n in (1, 64, 100, 128, 129, 256, 1000, 1024, 2048, 2816, 4096, 4097,
              10_112, 20_000):
        for k in (1, 128, 129, 256, 257, 384, 640, 641, 768, 1280, 1281,
                  1536, 6272, 6273, 7040, 10_624, 10_625, 12_800, 12_801):
            assert cuda_mu.rank_fits(
                n, k, itemsize, masked, kl_masked=kl_masked,
                kl_dense=kl_dense) == pallas_mu.fits_vmem(
                    _round128(n), _round128(k), itemsize, masked,
                    kl_masked=kl_masked, kl_dense=kl_dense), (n, k)


# The largest rank the gate takes, (N, itemsize, masked) -> K: every N <=
# 128 at the 128 row.
_CORNERS = {(128, 4, False): 10_624, (128, 4, True): 6272,
            (128, 2, False): 12_800, (128, 2, True): 7040,
            (1024, 4, False): 1280, (1024, 4, True): 640,
            (1024, 2, False): 1536, (1024, 2, True): 768,
            (4096, 4, False): 256, (4096, 4, True): 128,
            (4096, 2, False): 256, (4096, 2, True): 128}


@pytest.mark.parametrize("n,itemsize,masked", sorted(_CORNERS))
def test_gate_corners(n, itemsize, masked):
    """The corners the wide route must take, and the next padded rank
    refused; every N <= 128 at N = 128's corner; the route by K alone."""
    k = _CORNERS[n, itemsize, masked]
    for n_ in ((1, 64, n) if n == 128 else (n,)):
        assert cuda_mu.rank_fits(n_, k, itemsize, masked)
        assert not cuda_mu.rank_fits(n_, k + 1, itemsize, masked)
    dt = _F32 if itemsize == 4 else _BF16
    assert cuda_mu.kernel_takes_rank("mu", n, k, dt, masked)
    assert not cuda_mu.kernel_takes_rank("mu", n, k + 1, dt, masked)
    assert cuda_mu.kernel_takes_rank("kl-mu", n, 128, dt, masked)
    assert cuda_mu.kernel_takes_rank("kl-mu", n, 129, dt, masked) == (
        cuda_mu.rank_fits(n, 129, itemsize, True, kl_masked=masked,
                          kl_dense=not masked))
    assert [cuda_mu.rank_route(v) for v in (1, 128, 129, k)] == [
        "fused", "fused", "wide", "wide" if k > 128 else "fused"]


@pytest.fixture
def on_card(monkeypatch):
    """The MU and KL wrappers as if their data lay on the card: each MU
    launch and each KL wide launch runs its route's own argument checks,
    is recorded (wrapper, route, mask dtype) and replaced by the twin (a
    packed mask unpacked first); the fused KL launches run their real
    checks, and no library is built or called."""
    calls = []
    card_route = cuda_mu.dense_route

    def no_build(*_):
        raise AssertionError("a kernel library was reached")

    def dense(route, gate):
        def run(y, x, d, eps, block_rows=None, inner_iter=1):
            cuda_mu._check_kernel_args(y, x, d, inner_iter, 256, gate=gate)
            calls.append(("mu_stats_dense", route, None))
            return cuda_mu.mu_stats_dense_plain(y, x, d, eps,
                                                inner_iter=inner_iter)
        return run

    def masked(route, gate, method="mu"):
        kw = {"wide_x": False, "method": method} if method != "mu" else {}
        name = "mu_stats_masked" if method == "mu" else "kl_stats_masked"
        plain = (cuda_mu.mu_stats_masked_plain if method == "mu"
                 else cuda_mu.kl_stats_masked_plain)

        def run(my, mask, x, d, eps, block_rows=None):
            if mask.dtype == torch.int32:
                cuda_mu._check_packed(my, mask)
                cuda_mu._check_kernel_args(my, x, d, 1, 256, gate=gate, **kw)
            else:
                cuda_mu._check_kernel_args(my, x, d, 1, 256, mask=mask,
                                           gate=gate, **kw)
            calls.append((name, route, mask.dtype))
            if mask.dtype == torch.int32:
                mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
            return plain(my, mask, x, d, eps)
        return run

    def kl_dense(my, x, d, eps, block_rows=None):
        cuda_mu._check_kernel_args(my, x, d, 1, 256, wide_x=False,
                                   gate="dense", method="kl-mu")
        calls.append(("kl_stats_dense", "wide", None))
        return cuda_mu.kl_stats_dense_plain(my, x, d, eps)

    weighted = masked("dense", None)

    def dense_mask(wrapper, *a):
        if wrapper is not cuda_mu.mu_stats_masked:
            return real_masked_launch(wrapper, *a)
        wrapper.launches += 1
        return weighted(*a)

    real_masked_launch = cuda_mu._masked_launch
    monkeypatch.setattr(cuda_mu, "_c_function", no_build)
    monkeypatch.setattr(cuda_mu, "_runs_plain", lambda t: False)
    monkeypatch.setattr(cuda_mu, "dense_route",
                        lambda dtype, device: card_route(dtype, "cuda"))
    monkeypatch.setattr(cuda_mu, "kl_dense_route",
                        lambda dtype, device: "packed")
    monkeypatch.setattr(cuda_mu, "_dense_wide_launch", dense("wide", "dense"))
    monkeypatch.setattr(cuda_mu, "_dense_packed_launch", dense("packed", None))
    monkeypatch.setattr(cuda_mu, "_dense_tma_launch", dense("tma", None))
    monkeypatch.setattr(cuda_mu, "_masked_wide_launch",
                        masked("wide", "masked"))
    monkeypatch.setattr(cuda_mu, "_masked_f32_launch", masked("f32", None))
    monkeypatch.setattr(cuda_mu, "_masked_bf16_launch", masked("bf16", None))
    monkeypatch.setattr(cuda_mu, "_masked_launch", dense_mask)
    monkeypatch.setattr(cuda_mu, "_kl_dense_wide_launch", kl_dense)
    monkeypatch.setattr(cuda_mu, "_kl_masked_wide_launch",
                        masked("wide", "masked", "kl-mu"))
    for w, names in ((cuda_mu.mu_stats_dense, ("launches", "tma_launches",
                                               "packed_launches",
                                               "wide_launches")),
                     (cuda_mu.mu_stats_masked, ("launches", "packed_launches",
                                                "f32_launches",
                                                "dense_launches",
                                                "wide_launches")),
                     (cuda_mu.kl_stats_dense, ("launches", "wide_launches")),
                     (cuda_mu.kl_stats_masked, ("launches",
                                                "wide_launches"))):
        for name in names:
            monkeypatch.setattr(w, name, 0)
    return calls


def _port_args(kind, seed, m, n, k, dtype):
    y, mask, x, d = (_t(v) for v in _inputs(seed, m, n, k, kind))
    y, mask, d = y.to(dtype), mask.to(dtype), d.to(dtype)
    if kind == "binary":
        mask = cuda_mu.pack_mask(mask)
    return y, mask, x, d


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_rank_129_takes_the_wide_route(on_card, dtype, kind):
    """On the card K = 129 sends mu_stats_dense and mu_stats_masked, on
    bits or on weights, to the wide launch (.wide_launches and .launches),
    never to a fused route; the route gives the twin's function."""
    y, mask, x, d = _port_args(kind, 3, 30, 50, 129, dtype)
    if kind == "dense":
        w = cuda_mu.mu_stats_dense
        out = w(y, x, d, EPS)
        ref = cuda_mu.mu_stats_dense_plain(y, x, d, EPS)
    else:
        w = cuda_mu.mu_stats_masked
        out = w(y, mask, x, d, EPS)
        dense_mask = (cuda_mu.unpack_mask(mask, 50, dtype)
                      if kind == "binary" else mask)
        ref = cuda_mu.mu_stats_masked_plain(y, dense_mask, x, d, EPS)
    assert [c[1] for c in on_card] == ["wide"]
    assert (w.wide_launches, w.launches) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("kind", _KINDS)
def test_rank_128_stays_fused_outside_the_gate(on_card, kind):
    """The gate is the wide route's alone: K = 128 at N = 10,112 f32,
    where rank_fits refuses it, stays on the fused routes, through the
    wrappers and through nmf.solve(use_kernel=True)."""
    n = 10_112
    assert not cuda_mu.rank_fits(n, 128, 4, kind != "dense")
    y, mask, x, d = _port_args(kind, 4, 6, n, 128, _F32)
    want = {"dense": "packed", "binary": "f32", "weighted": "dense"}[kind]
    if kind == "dense":
        cuda_mu.mu_stats_dense(y, x, d, EPS)
    else:
        cuda_mu.mu_stats_masked(y, mask, x, d, EPS)
    assert [c[1] for c in on_card] == [want]
    del on_card[:]
    dense_mask = None
    if kind == "binary":
        dense_mask = cuda_mu.unpack_mask(mask, n, _F32)
    elif kind == "weighted":
        dense_mask = mask
    y_full = y if dense_mask is None else _t(_inputs(4, 6, n, 128,
                                                     "dense")[0])
    res = tnmf.solve(y_full, d, x=x, mask=dense_mask, tol=0.0, maxiter=2,
                     use_kernel=True)
    assert res.niter == 2 and [c[1] for c in on_card] == [want] * 2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_past_the_gate_refused_or_composed(on_card, dtype, masked):
    """Past the gate (N = 128: the corner's next padded rank) use_kernel=True
    raises ShapeError before any launch, in nmf.solve, loader mode and the
    wide launch itself; 'auto' keeps the composition there (nmf._auto_rank,
    loader mode's gate)."""
    corner = _CORNERS[128, dtype.itemsize, masked]
    k = corner + 1
    kind = "binary" if masked else "dense"
    y, mask, x, d = _port_args(kind, 5, 8, 128, k, dtype)
    dense_mask = (cuda_mu.unpack_mask(mask, 128, dtype) if masked
                  else None)
    with pytest.raises(texc.ShapeError, match="rank_fits"):
        tnmf.solve(y, d, x=x, mask=dense_mask, tol=0.0, maxiter=2,
                   use_kernel=True)
    with pytest.raises(texc.ShapeError, match="rank_fits"):
        if masked:
            cuda_mu.mu_stats_masked(y, mask, x, d, EPS)
        else:
            cuda_mu.mu_stats_dense(y, x, d, EPS)
    with pytest.raises(texc.ShapeError, match="rank_fits"):
        tns._chunk_kernel_gate(
            True, on_cuda=True, method="mu", mixed=False,
            record_objective=False, rank=k, n=128, y_dtype=dtype, fdt=_F32,
            masked=masked, inner_iter=1)
    assert on_card == []
    assert not tnmf._auto_rank("mu", 128, k, dtype, masked, _F32)
    assert not tns._chunk_kernel_gate(
        "auto", on_cuda=True, method="mu", mixed=dtype != _F32,
        record_objective=False, rank=k, n=128, y_dtype=dtype, fdt=_F32,
        masked=masked, inner_iter=1)
    assert tnmf._auto_rank("mu", 128, 128, dtype, masked, _F32)
    res = tnmf.solve(y, d, x=x, mask=dense_mask, tol=0.0, maxiter=2)
    assert res.niter == 2 and on_card == []


@pytest.mark.parametrize("masked", [False, True])
def test_kl_kernels_take_rank_129(on_card, masked):
    """The KL kernels take rank 129 on their wide route: the wrappers on
    the card and nmf.solve(method='kl-mu', use_kernel=True) at K = 129
    reach the wide launch (the mask as its bits), counted in
    .wide_launches, and give the twin's function."""
    kind = "binary" if masked else "dense"
    y, mask, x, d = _port_args(kind, 6, 12, 40, 129, _F32)
    name = "kl_stats_masked" if masked else "kl_stats_dense"
    w = getattr(cuda_mu, name)
    mdt = torch.int32 if masked else None
    dense_mask = cuda_mu.unpack_mask(mask, 40, _F32) if masked else None
    if masked:
        out = w(y, mask, x, d, EPS)
        ref = cuda_mu.kl_stats_masked_plain(y, dense_mask, x, d, EPS)
    else:
        out = w(y, x, d, EPS)
        ref = cuda_mu.kl_stats_dense_plain(y, x, d, EPS)
    assert on_card == [(name, "wide", mdt)]
    assert (w.wide_launches, w.launches) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    del on_card[:]
    res = tnmf.solve(y, d, x=x, mask=dense_mask, method="kl-mu", tol=0.0,
                     maxiter=2, use_kernel=True)
    assert res.niter == 2 and on_card == [(name, "wide", mdt)] * 2


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_solves_take_the_wide_route(on_card, dtype, kind):
    """nmf.solve(rank=200, use_kernel=True) on bf16 or f32 data with f32
    factors, dense or masked (a 0/1 mask packed once, as bits; weights as
    they are), and loader mode's solve_streaming, launch every iteration's
    (every chunk's) wrapper on the wide route, and no fused route."""
    y, mask, x, d = (_t(v) for v in _inputs(7, 48, 60, 200, kind))
    mask = None if kind == "dense" else mask.to(dtype)
    yy = _t(_inputs(7, 48, 60, 200, "dense")[0]).to(dtype)
    name = "mu_stats_dense" if kind == "dense" else "mu_stats_masked"
    mdt = {"dense": None, "binary": torch.int32, "weighted": dtype}[kind]
    res = tnmf.solve(yy, d, x=x, mask=mask, tol=0.0, maxiter=3,
                     use_kernel=True, factor_dtype=_F32)
    assert res.niter == 3 and on_card == [(name, "wide", mdt)] * 3
    del on_card[:]
    y_np = yy.float().numpy()
    m_np = None if mask is None else mask.float().numpy()
    res = tns.solve_streaming(
        lambda lo, hi: y_np[lo:hi], d.numpy(), x=x.numpy(),
        mask=None if m_np is None else (lambda lo, hi: m_np[lo:hi]),
        rank=200, n_samples=48, n_channels=60, chunk_rows=16, tol=0.0,
        maxiter=2, x_device=True, jit_loader=True, use_kernel=True,
        dtype=dtype, factor_dtype=_F32, device="cpu")
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
    """parallel.nmf.solve on a gloo world of 1, rank 200, use_kernel=True
    (the card's launches faked): every iteration on the wide route, the
    one-process solve's bits; past the gate ShapeError."""
    kind = "binary" if masked else "dense"
    y, mask, x, d = (_t(v) for v in _inputs(8, 40, 70, 200, kind))
    mask = mask if masked else None
    kw = dict(tol=0.0, maxiter=3, mask=mask, use_kernel=True)
    res = parallel.nmf.solve(y, d, x=x, mesh=world_of_one, **kw)
    assert res.niter == 3 and {c[1] for c in on_card} == {"wide"}
    assert len(on_card) == 3
    ref = tnmf.solve(y, d, x=x, **kw)
    assert torch.equal(res.x, ref.x) and torch.equal(res.d, ref.d)
    k = _CORNERS[128, 4, masked] + 1
    y2, m2, x2, d2 = (_t(v) for v in _inputs(9, 8, 128, k, kind))
    with pytest.raises(texc.ShapeError):
        parallel.nmf.solve(y2, d2, x=x2, mesh=world_of_one, tol=0.0,
                           maxiter=1, mask=m2 if masked else None,
                           use_kernel=True)


def test_solve_rank_200_matches_pallas():
    """nmf.solve(rank=200, use_kernel=True) on the CPU (every iteration
    through mu_stats_dense's twin, the wide kernel's function) against
    decomp_tpu's Pallas route in interpret mode from the same x and d,
    f32, 6 fixed iterations: 1e-4, the limit of tests/test_torch_nmf.py's
    kernel-path test."""
    y, _, x0, d0 = _inputs(10, 48, 128, 200, "dense")
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=6,
                              use_pallas=True, pallas_block_rows=16,
                              _pallas_interpret=True)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), tol=0.0, maxiter=6,
                    use_kernel=True, kernel_block_rows=16)
    assert rt.niter == 6 and rt.x.shape == (48, 200)
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_masked_completion_rank_200_matches_pallas():
    """nmf.masked_completion(rank=200, use_kernel=True) on the CPU (every
    iteration through mu_stats_masked's twin on the training mask's bits)
    against decomp_tpu's masked Pallas route in interpret mode on the same
    training mask (the observed entries less the port's held-out reserve)
    from the same x and d, f32, 6 iterations (no held-out check before
    the 25th): 1e-4."""
    my, mask, x0, d0 = _inputs(11, 48, 128, 200, "binary")
    val = tnmf._heldout_reserve(_t(mask), 0.05, 0).numpy()
    rt = tnmf.masked_completion(_t(my), _t(mask), d=_t(d0), x=_t(x0),
                                tol=0.0, maxiter=6, use_kernel=True)
    rj = decomp_tpu.nmf.solve(my, d0, x=x0, mask=mask - val, tol=0.0,
                              maxiter=6, use_pallas=True,
                              pallas_block_rows=16, _pallas_interpret=True)
    assert rt.niter == 6
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


@pytest.mark.parametrize("n,k", [(1024, 256), (1024, 1280), (4096, 256),
                                 (64, 256), (128, 256), (128, 10_624),
                                 (256, 256), (1024, 1281), (1024, 128)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,fdt", [(_F32, _F32), (_BF16, _F32),
                                       (_BF16, _BF16)])
def test_auto_rule_for_wide_ranks(n, k, dtype, fdt, masked):
    """use_kernel='auto' on the card: rank <= 128 always takes the fused
    kernels; above it MU takes the wide route inside the gate for the
    (data, factor) dtypes and widths where the card measured it no slower
    than the composition (nmf._AUTO_WIDE_RANK_MIN_N: f32 from N = 256, bf16
    data with f32 factors at every N), else the composition; KL-MU by its
    own entries, inside its own gate. Loader mode's gate follows the same
    rule."""
    min_n = tnmf._AUTO_WIDE_RANK_MIN_N.get(("mu", dtype, fdt))
    assert tnmf._AUTO_WIDE_RANK_MIN_N["mu", _F32, _F32] == 256
    want = k <= 128 or (min_n is not None and n >= min_n
                        and cuda_mu.rank_fits(n, k, dtype.itemsize, masked))
    assert tnmf._auto_rank("mu", n, k, dtype, masked, fdt) is want
    min_kl = tnmf._AUTO_WIDE_RANK_MIN_N.get(("kl-mu", dtype, fdt))
    want_kl = k <= 128 or (min_kl is not None and n >= min_kl
                           and cuda_mu.kernel_takes_rank("kl-mu", n, k, dtype,
                                                         masked))
    assert tnmf._auto_rank("kl-mu", n, k, dtype, masked, fdt) is want_kl
    got = tns._chunk_kernel_gate(
        "auto", on_cuda=True, method="mu", mixed=dtype != fdt,
        record_objective=False, rank=k, n=n, y_dtype=dtype, fdt=fdt,
        masked=masked, inner_iter=1)
    assert got is want


def _emulate(kind, y, mask, x, d, limbs):
    """The wide route's f32 arithmetic in plain torch, in its sum order:
    the wide_resid products (64-deep chunks, the big and the small chains
    added chunk by chunk); dense: num by wide_rows over 32-column stages,
    the statistics by wide_dict over 32-row stages of each row chunk
    (cuda_mu.wide_dict_rows); masked: num and den by the merged x update
    over 32-column stages, numd and dend by the merged statistics pass
    over 32-row units (two to a 64-row stage) of each row chunk
    (cuda_mu.wide_mstats_rows, whole 64-row stages); the chunks' partials
    summed in order."""
    m, n = y.shape
    k = d.shape[0]
    kp = _round128(k)

    def stat(e, xn):
        rows = (cuda_mu.wide_dict_rows(m, e.shape[1], kp) if kind == "dense"
                else cuda_mu.wide_mstats_rows(m, n, kp))
        g = None
        for c0 in range(0, m, rows):
            sl = slice(c0, c0 + rows)
            part = _stage_prod(e[sl].T, xn[sl], limbs, 32).T
            g = part if g is None else g + part
        return g

    num = _stage_prod(y, d.T, limbs, 32)
    if kind == "dense":
        den = _wide_prod(x, cuda_mu.gram_rows(d), limbs)
    else:
        den = _stage_prod(mask * _wide_prod(x, d, limbs), d.T, limbs, 32)
    xn = x * num / (den + EPS)
    last = (stat(xn, xn) if kind == "dense"
            else stat(mask * _wide_prod(xn, d, limbs), xn))
    return xn, stat(y, xn), last


@pytest.mark.parametrize("kind", ["bits", "weights"])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_masked_wide_launch_plan(monkeypatch, dtype, kind):
    """_masked_wide_launch with csrc/mu_wide.cu's C entries stubbed (no
    library built; each launch recorded): six launches in order, the prep
    (no f32 copy of x), E1, the merged x update, E2, the merged
    statistics and the reduction, on bits and on weights, f32 and bf16
    data; no M x kp f32 num buffer; the statistics' chunks from
    wide_mstats_rows in whole 64-row stages, their partials 2 K N a
    chunk, reduced into numd and dend."""
    m, n, k = 300, 70, 200
    kp = 256
    calls, allocs = [], []
    real_f32 = cuda_mu._f32

    def f32(shape, device):
        allocs.append(shape)
        return real_f32(shape, device)

    monkeypatch.setattr(cuda_mu, "_c_function",
                        lambda source, name, argtypes: name)
    monkeypatch.setattr(cuda_mu, "_launch",
                        lambda label, fn, device, *a: calls.append((fn, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(cuda_mu, "_f32", f32)
    y, mask, x, d = _port_args("binary" if kind == "bits" else "weighted",
                               12, m, n, k, dtype)
    x_new, numd, dend = cuda_mu._masked_wide_launch(y, mask, x, d, EPS, None)
    assert [c[0] for c in calls] == [
        "mu_wide_prep_launch", "mu_wide_resid_launch", "mu_wide_mxupd_launch",
        "mu_wide_resid_launch", "mu_wide_mstats_launch",
        "mu_wide_reduce_launch"]
    (_, prep), (_, e1), (_, xupd), (_, e2), (_, st), (_, red) = calls
    limbs = 3 if dtype == _F32 else 1
    assert prep[:5] == (limbs, x.data_ptr(), 0, m, k) and prep[6] == 0
    assert e1 == e2 and e1[:2] == (limbs, int(kind == "weights"))
    assert xupd[6:10] == (m, n, k, kp) and xupd[10] == x.data_ptr()
    rows = cuda_mu.wide_mstats_rows(m, n, kp)
    chunks = -(-m // rows)
    assert rows % 64 == 0 and st[6:11] == (m, n, k, kp, rows)
    assert red[1:3] == (2 * k * n, chunks)
    assert allocs == [chunks * 2 * k * n, 2 * k * n]
    assert (m, kp) not in allocs
    assert x_new.shape == x.shape and x_new.dtype == x.dtype
    assert numd.shape == dend.shape == (k, n)


@pytest.mark.parametrize("m,n,kp", [(100_000, 1024, 256), (100_000, 64, 256),
                                    (32_768, 1024, 640), (4096, 128, 6272),
                                    (300, 70, 256), (7, 1, 128)])
def test_wide_mstats_rows(m, n, kp):
    """The masked statistics pass's row chunks: whole 64-row stages, every
    chunk holding rows, the grid of (64-column N tiles) x (kp / 128) x
    chunks at most 1.5 times the two waves it aims at (unless one chunk is
    all), and a function of the shape alone."""
    rows = cuda_mu.wide_mstats_rows(m, n, kp)
    chunks = -(-m // rows)
    tiles = -(-n // 64) * (kp // 128)
    assert rows % 64 == 0 and (chunks - 1) * rows < m
    assert chunks == 1 or tiles * chunks <= 1.5 * 264
    assert rows == cuda_mu.wide_mstats_rows(m, n, kp)


@pytest.mark.parametrize("kind", ["dense", "binary"])
@pytest.mark.parametrize("k", [200, 640])
def test_bf16x6_emulation_on_lognormal_data(kind, k):
    """The wide route's sum order, emulated in plain torch on log-normal
    y, x and d over six decades: bf16x6 stays within chip_smoke.py's f32
    limit of the full-f32 twin, two limbs (bf16x3) do not."""
    rng = np.random.default_rng(k)
    m, n = 96, 64
    ln10 = np.log(10.0)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float32)
    y, x, d = (np.exp(ln10 * rng.standard_normal(s)).astype(np.float32)
               for s in ((m, n), (m, k), (k, n)))
    if kind != "dense":
        y = y * mask
    y, mask, x, d = (_t(v) for v in (y, mask, x, d))
    if kind == "dense":
        twin = cuda_mu.mu_stats_dense_plain(y, x, d, EPS)
    else:
        twin = cuda_mu.mu_stats_masked_plain(y, mask, x, d, EPS)
    six = _emulate(kind, y, mask, x, d, 3)
    three = _emulate(kind, y, mask, x, d, 2)
    errs6 = [rel_err(a.numpy(), b.numpy()) for a, b in zip(six, twin)]
    errs3 = [rel_err(a.numpy(), b.numpy()) for a, b in zip(three, twin)]
    assert max(errs6) < _F32_KERNEL_LIMIT, errs6
    assert max(errs3) > _F32_KERNEL_LIMIT, errs3
