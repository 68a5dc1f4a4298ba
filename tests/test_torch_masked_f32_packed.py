"""Masked MU's f32 route in the PyTorch port, ``csrc/mu_masked_f32.cu``
(the mask as bits, every f32 product as bf16x6 limb products on
``wgmma``): a plain emulation of the kernel's arithmetic against the
full-f32 twin and f64, the shape-only row chunks, the refusals before any
launch, the routes ``mu_stats_masked``, ``nmf.solve`` and
``masked_completion`` take with the launches faked, and the kernel path
against ``decomp_tpu``'s masked MU Pallas kernel in interpret mode. The
same numpy inputs, made from a seed, go through both packages."""

import numpy as np
import pytest
import torch

from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_kl_dense_packed import _prod
from test_torch_masked import _heldout_problem, _problem
from test_torch_masked_packed import _jax_kernel_run, _RouteSpy
from test_torch_nmf import _t

# chip_smoke.py's limit for f32 kernels against their twin (LIMIT[f32]).
_F32_LIMIT = 2e-6
_F32 = torch.float32


def _inputs(seed, m, n, k, lognormal=False):
    """f32 (my, mask, x, d) with 30% of the entries missing: uniform, or
    log-normal e^(ln 10 z) over about six decades (chip_smoke.py's phase
    3f draws them so)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    if lognormal:
        ln10 = np.log(10.0)
        y, x, d = (np.exp(ln10 * rng.standard_normal(s))
                   for s in ((m, n), (m, k), (k, n)))
    else:
        y, x, d = (rng.uniform(0, 1, (m, n)), rng.uniform(0.1, 1.1, (m, k)),
                   rng.uniform(0.1, 1.1, (k, n)))
    return tuple(_t(a.astype(np.float32)) for a in (mask * y, mask, x, d))


def _kernel_chain(my, mask, x, d, eps, limbs=3):
    """The kernel's arithmetic in plain torch, pass by pass: num = my d^T
    over 32-column stages (each stage's limb products added with a
    round-to-nearest f32 add); den over the same stages, R1 per 64-deep
    chunk and E1 = mask R1 in f32; x_new from the f32 x; then the
    statistics over 32-row stages within the row chunks of
    ``masked_f32_block_rows``, numd^T += my_s^T x_new_s and dend^T +=
    E2^T x_new_s with E2^T = mask^T (d^T x_new_s^T), the chunks' partials
    added in chunk order."""
    eps32 = torch.tensor(eps, dtype=_F32)
    m, n = my.shape
    k = d.shape[0]
    num = torch.zeros((m, k), dtype=_F32)
    den = torch.zeros((m, k), dtype=_F32)
    for s in range(0, n, 32):
        ds = d[:, s:s + 32]
        num = num + _prod(my[:, s:s + 32], ds.T, limbs, 32)
        e1 = mask[:, s:s + 32] * _prod(x, ds, limbs, 64)
        den = den + _prod(e1, ds.T, limbs, 32)
    x_new = x * num / (den + eps32)
    rows = cuda_mu.masked_f32_block_rows(m, n)
    numd_t, dend_t = None, None
    for c in range(0, m, rows):
        pn = torch.zeros((n, k), dtype=_F32)
        pd = torch.zeros((n, k), dtype=_F32)
        for r in range(c, min(c + rows, m), 32):
            xs = x_new[r:min(r + 32, c + rows)]
            rs = slice(r, r + xs.shape[0])
            pn = pn + _prod(my[rs].T, xs, limbs, 32)
            e2_t = mask[rs].T * _prod(d.T, xs.T, limbs, 64)
            pd = pd + _prod(e2_t, xs, limbs, 32)
        numd_t = pn if numd_t is None else numd_t + pn
        dend_t = pd if dend_t is None else dend_t + pd
    return x_new, numd_t.T, dend_t.T


def _f64_chain(my, mask, x, d, eps):
    my, mask, x, d = my.double(), mask.double(), x.double(), d.double()
    x = x * (my @ d.T) / ((mask * (x @ d)) @ d.T + eps)
    return x, x.T @ my, x.T @ (mask * (x @ d))


def _errs(got, ref):
    return [rel_err(a.double().numpy(), b.double().numpy())
            for a, b in zip(got, ref)]


@pytest.mark.parametrize("m,n,k,lognormal,eps", [
    (256, 320, 64, False, 1e-6),
    (256, 320, 64, True, 1e-6),
    (160, 200, 96, False, 1e-6),
    (160, 200, 96, True, 1e-6),
    (333, 257, 7, False, 0.0),      # ragged M, N and K, eps = 0
    (333, 257, 1, True, 1e-6),      # K = 1
    (97, 130, 128, True, 0.0),      # K = 128, ragged M and N
    (65, 33, 64, False, 0.0),       # K = 64: the KT = 64 tile's edge
    (129, 161, 65, True, 1e-6),     # K = 65: the KT = 128 tile
])
def test_emulated_kernel_keeps_f32_accuracy(m, n, k, lognormal, eps):
    """bf16x6 with per-stage big chains keeps x_new, numd and dend within
    chip_smoke.py's f32 limit of the full-f32 twin and of f64, on uniform
    and on log-normal data over about six decades, at ragged shapes and
    eps = 0."""
    args = _inputs(m + n + k, m, n, k, lognormal)
    got = _kernel_chain(*args, eps)
    twin = cuda_mu.mu_stats_masked_plain(*args, eps)
    ref = _f64_chain(*args, eps)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert max(_errs(got, twin)) < _F32_LIMIT
    assert max(_errs(got, ref)) < _F32_LIMIT
    assert max(_errs(twin, ref)) < _F32_LIMIT


def test_bf16x3_shortcut_breaks_the_limit():
    """Two limbs and three products (bf16x3) break the f32 limit on the
    log-normal data that bf16x6 keeps well within it, so phase 3f's
    log-normal shape would catch that shortcut."""
    args = _inputs(0, 256, 320, 64, lognormal=True)
    ref = _f64_chain(*args, 1e-6)
    assert max(_errs(_kernel_chain(*args, 1e-6), ref)) < _F32_LIMIT / 2
    assert max(_errs(_kernel_chain(*args, 1e-6, limbs=2), ref)) \
        > _F32_LIMIT


@pytest.mark.parametrize("m,n,block_rows,rows,chunks", [
    (100_000, 1000, None, 1536, 66),    # config 4: 16 tiles, 1,056 blocks
    (100_000, 1024, None, 1536, 66),
    (262_144, 10112, None, 37472, 7),   # 158 tiles, 1,106 blocks
    (333, 257, None, 32, 11),
    (1, 1, None, 32, 1),
    (1000, 1000, 100, 128, 8),          # 100 rows rounded up to 128
    (1000, 1000, 32, 32, 32),
])
def test_partials_are_a_function_of_the_shape(m, n, block_rows, rows,
                                              chunks):
    """Row chunks of the statistics pass: eight waves of one block per SM
    (132 SMs) over numd's and dend's 128-column N tiles, in whole 32-row
    stages; nothing but the shape and block_rows goes in, so the
    summation order, and every bit of the result, is fixed by them."""
    got = cuda_mu.masked_f32_block_rows(m, n, block_rows)
    assert got == rows == cuda_mu.masked_f32_block_rows(m, n, block_rows)
    assert got % 32 == 0 and -(-m // got) == chunks


@pytest.mark.parametrize("dtype,device,want", [
    (torch.float32, "cpu", True),
    (torch.float64, "cpu", True),
    (torch.bfloat16, "cpu", True),
    (torch.float32, "meta", True),
    (torch.bfloat16, "meta", True),
    (torch.float64, "meta", False),
])
def test_takes_packed(dtype, device, want):
    """f32 and bf16 data on a device with kernels (a meta tensor stands in
    for the card: only the dtype and device type are read), any data on
    the CPU."""
    my = torch.empty((3, 4), dtype=dtype, device=device)
    assert cuda_mu.takes_packed(my) is want


@pytest.mark.parametrize("dtype,counter", [
    (torch.float32, "f32_launches"), (torch.bfloat16, "packed_launches"),
    (torch.float64, "packed_launches")])
def test_packed_route_counter(dtype, counter):
    assert cuda_mu.masked_packed_route(dtype) == counter


def _no_launch(*_):
    raise AssertionError("the kernel was reached")


@pytest.mark.parametrize("case,exc", [
    ("rank 129", texc.ShapeError),
    ("bf16 data", texc.DtypeError),
    ("f64 data", texc.DtypeError),
    ("bf16 x", texc.DtypeError),
    ("dense mask", texc.DtypeError),
    ("packed mask of another shape", texc.ShapeError),
    ("packed mask of another height", texc.ShapeError),
    ("non-contiguous my", texc.DecompError),
    ("misplaced x", texc.DecompError),
    ("misplaced d", texc.DecompError),
])
def test_f32_launch_refuses_before_any_launch(monkeypatch, case, exc):
    """What csrc/mu_masked_f32.cu does not take is refused before the
    library is built or called (checked on CPU tensors, and meta tensors
    for a misplaced operand: the checks do not look at the device type)."""
    monkeypatch.setattr(cuda_mu, "_c_function", _no_launch)
    k = 129 if case == "rank 129" else 4
    my, mask, x, d = _inputs(5, 40, 70, k)
    bits = cuda_mu.pack_mask(mask)
    if case in ("bf16 data", "f64 data"):
        dt = torch.bfloat16 if case == "bf16 data" else torch.float64
        my, x, d = my.to(dt), x.to(dt), d.to(dt)
    elif case == "bf16 x":
        x = x.to(torch.bfloat16)
    elif case == "dense mask":
        bits = mask
    elif case == "packed mask of another shape":
        bits = bits[:, :2].contiguous()
    elif case == "packed mask of another height":
        bits = bits[:39]
    elif case == "non-contiguous my":
        my = my.T.contiguous().T
    elif case == "misplaced x":
        x = x.to("meta")
    elif case == "misplaced d":
        d = d.to("meta")
    with pytest.raises(exc):
        cuda_mu._masked_f32_launch(my, bits, x, d, 1e-6, None)


@pytest.mark.parametrize("case,exc", [
    ("rank 129", texc.ShapeError),
    ("packed mask of another shape", texc.ShapeError),
    ("misplaced x", texc.DecompError),
])
def test_wrapper_refuses_before_any_launch(monkeypatch, case, exc):
    """mu_stats_masked on the card's path (its data taken as the card's)
    refuses what the f32 kernel does not take before a build or a launch,
    and counts nothing. Rank 129 takes the wide route, which refuses it
    past the TPU kernels' gate: at N = 2,816 (cuda_mu.rank_fits)."""
    monkeypatch.setattr(cuda_mu, "_c_function", _no_launch)
    monkeypatch.setattr(cuda_mu, "_runs_plain", lambda t: False)
    w = cuda_mu.mu_stats_masked
    before = (w.launches, w.f32_launches)
    k = 129 if case == "rank 129" else 4
    n = 2816 if case == "rank 129" else 70
    assert not cuda_mu.rank_fits(n, k, 4, True) or k < 129
    my, mask, x, d = _inputs(6, 40, n, k)
    bits = cuda_mu.pack_mask(mask)
    if case == "packed mask of another shape":
        bits = torch.zeros((40, 8), dtype=torch.int32)
    elif case == "misplaced x":
        x = x.to("meta")
    with pytest.raises(exc):
        cuda_mu.mu_stats_masked(my, bits, x, d, 1e-6)
    assert (w.launches, w.f32_launches) == before


@pytest.fixture
def on_card(monkeypatch):
    """mu_stats_masked as if its data lay on the card: each launch is
    recorded by route ('f32': csrc/mu_masked_f32.cu, 'bf16':
    csrc/mu_masked_packed.cu, 'dense': csrc/mu_kl_stats.cu) with the
    mask's dtype, and replaced by the twin on the dense mask."""
    calls = []

    def twin(route, my, mask, x, d, eps, block_rows):
        calls.append((route, mask.dtype))
        if mask.dtype == torch.int32:
            mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
        return cuda_mu.mu_stats_masked_plain(my, mask, x, d, eps,
                                             block_rows=block_rows)

    def packed(route):
        return lambda *a: twin(route, *a)

    def dense(wrapper, *a):
        wrapper.launches += 1
        return twin("dense", *a)

    monkeypatch.setattr(cuda_mu, "_runs_plain", lambda t: False)
    monkeypatch.setattr(cuda_mu, "_masked_f32_launch", packed("f32"))
    monkeypatch.setattr(cuda_mu, "_masked_bf16_launch", packed("bf16"))
    monkeypatch.setattr(cuda_mu, "_masked_launch", dense)
    for name in ("launches", "packed_launches", "f32_launches",
                 "dense_launches"):
        monkeypatch.setattr(cuda_mu.mu_stats_masked, name, 0)
    return calls


def _counts():
    w = cuda_mu.mu_stats_masked
    return w.f32_launches, w.packed_launches, w.dense_launches, w.launches


def _f32_problem(seed, m=70, n=50, k=4):
    return tuple(a.astype(np.float32) for a in _problem(seed=seed, m=m, n=n,
                                                        k=k))


def test_solve_packs_once_and_takes_the_f32_route(monkeypatch, on_card):
    """nmf.solve(mask=0/1) on f32 data packs the mask once per solve and
    launches the f32 route once an iteration, counted in .f32_launches
    and .launches only."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = _f32_problem(31)
    res = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                     maxiter=6, use_kernel=True, device="cpu")
    assert res.niter == 6 and spy.packed == [True]
    assert on_card == [("f32", torch.int32)] * 6
    assert _counts() == (6, 0, 0, 6)


def test_weighted_mask_stays_on_the_dense_route(monkeypatch, on_card):
    """A weighted mask is refused by pack_mask and runs csrc/mu_kl_stats.cu
    on f32 data, as before: the same bits as the dense twin's iterations."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = _f32_problem(32, m=40, n=30, k=3)
    mask = mask * np.where(np.arange(30) % 2, 0.5, 1.0).astype(np.float32)
    res = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                     maxiter=5, use_kernel=True, device="cpu")
    assert spy.packed == [False]
    assert on_card == [("dense", _F32)] * 5
    assert _counts() == (0, 0, 5, 5)
    my, x, d = _t(mask) * _t(y), _t(x0), _t(d0)
    for _ in range(5):
        x, d = cuda_mu.mu_update_masked(my, _t(mask), x, d,
                                        float(np.float32(1e-15)))
    assert torch.equal(res.x, x) and torch.equal(res.d, d)


def test_bf16_data_stay_on_their_packed_route(monkeypatch, on_card):
    """bf16 data with f32 factors take csrc/mu_masked_packed.cu, counted in
    .packed_launches, never the f32 route."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = _f32_problem(33)
    res = tnmf.solve(_t(y).to(torch.bfloat16), _t(d0), x=_t(x0),
                     mask=_t(mask), tol=0.0, maxiter=4, use_kernel=True,
                     factor_dtype=_F32, precision="default", device="cpu")
    assert res.niter == 4 and spy.packed == [True]
    assert on_card == [("bf16", torch.int32)] * 4
    assert _counts() == (0, 4, 0, 4)


@pytest.mark.parametrize("mixed,route", [(False, "f32"), (True, "bf16")])
def test_masked_completion_routes(monkeypatch, on_card, mixed, route):
    """masked_completion(mixed=False) on f32 data keeps f32 and takes the
    f32 route; mixed=True casts to bf16 and takes the bf16 packed route.
    Either packs the training mask once and launches once an iteration."""
    spy = _RouteSpy(monkeypatch)
    y, mask, _, _ = _f32_problem(34, m=120, n=40, k=3)
    res = tnmf.masked_completion(_t(y), _t(mask), rank=3, mixed=mixed,
                                 tol=1e-3, maxiter=60, random_seed=2,
                                 use_kernel=True, device="cpu")
    assert spy.packed == [True]
    assert on_card == [(route, torch.int32)] * res.niter
    counts = _counts()
    assert counts[3] == res.niter
    assert counts[0 if route == "f32" else 1] == res.niter


def test_heldout_solve_packs_the_training_mask(monkeypatch, on_card):
    """Under stop='heldout' the bits the f32 route gets are the training
    mask, the observed entries less the validation reserve."""
    y, mask, x0, d0, val = (a.astype(np.float32)
                            for a in _heldout_problem())
    seen = []
    launch = cuda_mu._masked_f32_launch

    def spy(my, bits, *a):
        seen.append(bits)
        return launch(my, bits, *a)

    monkeypatch.setattr(cuda_mu, "_masked_f32_launch", spy)
    res = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val), rank=4,
                      use_kernel=True, tol=1e-3, maxiter=60,
                      check_every=25)
    assert len(seen) == res.niter > 0
    assert all(b is seen[0] for b in seen)
    train = _t(mask) - _t(val)
    assert torch.equal(cuda_mu.unpack_mask(seen[0], y.shape[1], _F32),
                       train)


def test_solve_f32_route_matches_pallas(monkeypatch, on_card):
    """nmf.solve(mask=) on f32 data through the f32 route (the twin on
    CPU) against decomp_tpu's Pallas kernel in interpret mode, 15 fixed
    iterations at a ragged shape: 1e-4, as test_torch_masked.py."""
    y, mask, x0, d0 = _f32_problem(35, m=77, n=45, k=5)
    rj = _jax_kernel_run(y, mask, x0, d0, tol=0.0, maxiter=15)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                    maxiter=15, use_kernel=True, kernel_block_rows=16,
                    device="cpu")
    assert rt.niter == 15
    assert on_card == [("f32", torch.int32)] * 15
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_heldout_f32_route_stops_where_pallas_stops(on_card):
    """stop='heldout' with decomp_tpu's reserve passed in: the f32 route
    (the twin on CPU) stops on the iteration where the Pallas run in
    interpret mode stops, with a close validation error and d."""
    y, mask, x0, d0, val = (a.astype(np.float32)
                            for a in _heldout_problem(seed=23))
    kw = dict(tol=1e-3, maxiter=3000, check_every=25)
    rj = _jax_kernel_run(y, mask, x0, d0, stop="heldout", random_seed=23,
                         **kw)
    rt = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val), rank=4,
                     use_kernel=True, kernel_block_rows=16, **kw)
    assert bool(rj.converged) and rt.converged
    assert rt.niter == int(rj.niter)
    assert on_card == [("f32", torch.int32)] * rt.niter
    ej = float(np.asarray(rj.aux["heldout_rel_err"]))
    assert abs(float(rt.aux["heldout_rel_err"]) - ej) < 1e-4 * ej
    assert rel_err(rt.d.numpy(), rj.d) < 1e-3
