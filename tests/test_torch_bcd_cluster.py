"""``bcd_sweep``'s cluster route (``csrc/dl_bcd_cluster.cu``) on the CPU: a
plain torch emulation of the kernel's split and summation order held to
the plain twin and to ``decomp_tpu`` (the Pallas BCD sweep in interpret
mode and the JAX composition sweep), the gate ``bcd_fits`` against the TPU
kernel's ``fits_vmem``, the cluster plan, the wrapper's routes with the
launches faked, and ``dictionary_learning.solve`` against ``decomp_tpu``
at a dictionary the first shared-memory design did not take. The kernel
itself runs only on the card (``chip_smoke.py`` phase 13). The same numpy
inputs, made from a seed, go through both packages."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.models.dictionary_learning import _bcd_dict_update
from decomp_tpu.ops.pallas_bcd import fits_vmem
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.ops import cuda_dl
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err

# chip_smoke.py's BCD_LIMIT: relative Frobenius of d after one sweep.
BCD_LIMIT = 5e-6
WARP, WARP_SLOTS = 32, 16


def _fma(a, b, c):
    """f32 fma(a, b, c): the product is exact in f64; the f64 sum may round
    once before the f32 rounding, which no limit here can see."""
    return (a.double() * b.double() + c.double()).float()


def _fold(v):
    """An xor butterfly's sum over dim 0 (xor len/2 first, then halves of
    that): the same tree in every lane."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = v[:h] + v[h:]
    return v[0]


def _layout(plan, n):
    """Column of entry (rank, set, i, c) of the threads' d, -1 where none:
    group g = set + sets i of block ``rank`` holds columns rank nb + 4 g +
    c, while g < nb / 4 and the column < N."""
    c_, s_, i_, q_ = np.meshgrid(np.arange(plan.clusters),
                                 np.arange(plan.sets), np.arange(plan.r),
                                 np.arange(4), indexing="ij")
    g = s_ + plan.sets * i_
    col = c_ * plan.nb + 4 * g + q_
    ok = (g < plan.nb // 4) & (col < n)
    return torch.from_numpy(np.where(ok, col, -1))


def _plan(k, n, clusters=None):
    """The route's plan, or the same split on ``clusters`` blocks."""
    if clusters is None:
        return cuda_dl.bcd_cluster_plan(k, n)
    return cuda_dl._bcd_cluster_plan_at(k, n, clusters)


def emulate_cluster(a, b, d, clusters=None):
    """The cluster route's arithmetic in plain torch f32, on
    ``cuda_dl.bcd_cluster_plan``'s split. Lane p of a set sums its rows p,
    p + P, ... in an FMA chain, and the set's P lane partials meet in an
    xor butterfly; for atom k >= 1 row k - 1 is left out (the chains run
    before that row's division) and its term a_k,k-1 d_k-1 (rounded) is
    added to the butterfly's sum. u = (b - s) + a_kk d_k; lane p = 0 of
    each set sums u^2 over its columns (i, then c) in an FMA chain, a warp
    sums its 32 lanes in a butterfly into slot (rank, warp) of 128 in every
    block, and the 128 slots meet as every warp reads them: lane l adds
    slots 4 l .. 4 l + 3 in order, then a butterfly over the lanes."""
    k, n = d.shape
    plan = _plan(k, n, clusters)
    lanes = plan.lanes
    col = _layout(plan, n)
    ok = col >= 0
    idx = col.clamp(min=0)

    def spread(m):     # (rows, N) -> (rows, clusters, sets, r, 4)
        return torch.where(ok, m[:, idx], torch.zeros(()))

    dd, bb = spread(d), spread(b)
    tiny = torch.tensor(torch.finfo(torch.float32).tiny)
    # Thread t = set * lanes + p of warp t // 32; its partial of u^2 goes to
    # warp slot t // 32 when p == 0.
    warps = plan.threads // WARP
    t_of_set = torch.arange(plan.sets) * lanes
    zero = torch.zeros(())

    def products(arow, skip):
        acc = torch.zeros((lanes,) + dd.shape[1:])
        for m in range(-(-k // lanes)):
            j = torch.arange(lanes) + lanes * m
            live = j < k
            jc = j.clamp(max=k - 1)
            av = torch.where(live & (j != skip), arow[jc], zero)
            new = _fma(av.view(-1, 1, 1, 1, 1), dd[jc], acc)
            acc = torch.where(live.view(-1, 1, 1, 1, 1), new, acc)
        return _fold(acc)

    s = products(a[0], -1)
    for kk in range(k):
        u = torch.where(ok, (bb[kk] - s) + a[kk, kk] * dd[kk], zero)
        q = torch.zeros(u.shape[:2])                   # (clusters, sets)
        for i in range(plan.r):
            for c in range(4):
                q = _fma(u[:, :, i, c], u[:, :, i, c], q)
        lane_q = torch.zeros((plan.clusters, warps * WARP))
        lane_q[:, t_of_set] = q
        slots = torch.zeros((cuda_dl.BCD_CLUSTER_MAX, WARP_SLOTS))
        slots[:plan.clusters, :warps] = _fold(
            lane_q.view(plan.clusters, warps, WARP).permute(2, 0, 1))
        v = slots.reshape(-1).view(WARP, 4)
        ss = _fold(((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3])
        norm = torch.sqrt(ss)
        if norm > tiny:
            dd[kk] = u / torch.maximum(norm, tiny)
        if kk + 1 < k:
            s = products(a[kk + 1], kk) + a[kk + 1, kk] * dd[kk]
    out = torch.zeros((k, n))
    out[:, col[ok]] = dd[:, ok]
    return out


def _inputs(seed, k, n, dead=None, decades=0):
    """A = x^T x and B = x^T y from random x and y (x's columns scaled over
    ``decades`` decades), and unit atoms d; atom ``dead`` gets all-zero
    statistics."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, k)) * np.logspace(0, decades, k)
    y, d = rng.normal(size=(300, n)), rng.normal(size=(k, n))
    if dead is not None:
        x[:, dead] = 0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(v.astype(np.float32) for v in (x.T @ x, x.T @ y, d))


CASES = {
    # Beyond the first design's K x N <= 53,248, at small size.
    "wide_40x1500": dict(seed=1, k=40, n=1500),
    "tall_300x200": dict(seed=2, k=300, n=200),
    # 8 blocks of 12 columns for N = 65: blocks 6 and 7 own none.
    "empty_blocks_450x65": dict(seed=3, k=450, n=65),
    "dead_atom": dict(seed=4, k=96, n=130, dead=7),
    "ill_conditioned": dict(seed=5, k=64, n=200, decades=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_twin_and_jax(case):
    kw = CASES[case]
    a, b, d = _inputs(**kw)
    ta, tb, td = (torch.from_numpy(v) for v in (a, b, d))
    assert cuda_dl.bcd_route(*td.shape) == "cluster"
    got = emulate_cluster(ta, tb, td)
    assert got.dtype == torch.float32 and got.shape == td.shape
    twin = cuda_dl.bcd_sweep_plain(ta, tb, td)
    assert rel_err(got.numpy(), twin.numpy()) < BCD_LIMIT
    ja, jb, jd = (jnp.asarray(v) for v in (a, b, d))
    # The Pallas kernel through the JAX package's own padding (K to 8, N
    # to 128: zero rows and columns are no-ops of the sweep).
    pallas = np.asarray(_bcd_dict_update(ja, jb, jd, bcd_mode="interpret"))
    assert rel_err(got.numpy(), pallas) < BCD_LIMIT
    with jax.default_matmul_precision("highest"):
        composition = np.asarray(_bcd_dict_update(ja, jb, jd))
    assert rel_err(got.numpy(), composition) < BCD_LIMIT
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               rtol=1e-5)
    if "dead" in kw:
        np.testing.assert_array_equal(got.numpy()[kw["dead"]], d[kw["dead"]])


def test_empty_blocks_case_has_blocks_without_columns():
    plan = cuda_dl.bcd_cluster_plan(450, 65)
    assert plan.clusters == 8 and plan.nb == 12
    assert [max(0, min(65, (r + 1) * 12) - r * 12) for r in range(8)] == [
        12, 12, 12, 12, 12, 5, 0, 0]


@pytest.mark.parametrize("clusters", [1, 2, 3, 8])
def test_emulation_holds_at_every_cluster_size(clusters):
    """The split changes only the summation order: every size agrees with
    the twin, and the sizes differ from each other only in rounding."""
    ta, tb, td = (torch.from_numpy(v) for v in _inputs(6, 48, 90))
    got = emulate_cluster(ta, tb, td, clusters)
    twin = cuda_dl.bcd_sweep_plain(ta, tb, td)
    assert rel_err(got.numpy(), twin.numpy()) < BCD_LIMIT


def test_emulation_is_not_the_twin_bit_for_bit():
    """The emulation sums in the kernel's order, not cuBLAS's or the CPU
    twin's: it agrees within the limit but is its own arithmetic (so the
    limit, not equality, is what the card's check can hold)."""
    a, b, d = (torch.from_numpy(v) for v in _inputs(7, 256, 208))
    got, twin = emulate_cluster(a, b, d), cuda_dl.bcd_sweep_plain(a, b, d)
    assert not torch.equal(got, twin)
    assert rel_err(got.numpy(), twin.numpy()) < BCD_LIMIT


# The TPU gate's corners: the largest N at K = 256 and at K <= 8, the
# largest K at N <= 128.
CORNERS = [(256, 3712), (8, 98176), (1736, 128)]
PAST = [(256, 3713), (8, 98177), (1737, 128)]


def _pallas_gate(k, n):
    return fits_vmem(-(-k // 8) * 8, -(-n // 128) * 128)


def test_bcd_fits_takes_every_shape_the_tpu_kernel_takes():
    ks = sorted({1, 2, 7, 8, 9, 16, 63, 64, 65, 128, 255, 256, 257, 300,
                 512, 1000, 1024, 1500, 1735, 1736, 1737, 1744, 2048})
    ns = sorted({1, 5, 64, 65, 127, 128, 129, 208, 209, 777, 1024, 2000,
                 3584, 3712, 3713, 3840, 10_000, 50_000, 98_176, 98_177,
                 98_304})
    for k, n in itertools.product(ks, ns):
        assert cuda_dl.bcd_fits(k, n) == _pallas_gate(k, n), (k, n)
    for (k, n), (kp, np_) in zip(CORNERS, PAST):
        assert cuda_dl.bcd_fits(k, n) and _pallas_gate(k, n)
        assert not cuda_dl.bcd_fits(kp, np_) and not _pallas_gate(kp, np_)
    # Every K at N = 128 and every N at K = 8, in whole padded steps.
    for k in range(8, 1800, 8):
        assert cuda_dl.bcd_fits(k, 128) == _pallas_gate(k, 128) == (
            k <= 1736)
    for n in range(128, 100_000, 128):
        assert cuda_dl.bcd_fits(8, n) == _pallas_gate(8, n) == (n <= 98_176)
    # The first design's old limit, K x N <= 53,248, is long past.
    assert cuda_dl.bcd_fits(256, 209) and cuda_dl.bcd_fits(1000, 100)


def _plans():
    shapes = CORNERS + [(256, 65), (257, 64), (256, 208), (256, 1024),
                        (300, 777), (450, 65), (1, 98176), (1736, 1),
                        (3, 98176), (16, 50_000), (1000, 700), (37, 3000)]
    for k, n in shapes:
        yield k, n, cuda_dl.bcd_cluster_plan(k, n)


def test_cluster_size_is_a_function_of_the_shape_alone():
    for k, n, plan in _plans():
        assert plan.clusters == cuda_dl.bcd_cluster_size(k, n)
        assert 1 <= plan.clusters <= cuda_dl.BCD_CLUSTER_MAX
        assert plan == cuda_dl.bcd_cluster_plan(k, n)
        assert plan == cuda_dl._bcd_cluster_plan_at(k, n, plan.clusters)
    # The same shape gives the same size whatever came before it.
    first = [cuda_dl.bcd_cluster_size(k, n) for k, n in CORNERS]
    cuda_dl.bcd_cluster_size(5, 5)
    assert first == [cuda_dl.bcd_cluster_size(k, n) for k, n in CORNERS]


@pytest.mark.parametrize("clusters", [None, 1, 2, 5, 8])
def test_cluster_plans_fit_the_kernel(clusters):
    """What csrc/dl_bcd_cluster.cu's launch checks, at shapes across the
    gate: the threads, the shared memory, whole warps on chip, the bank
    spread of shared d's rows, and a scratch for the rest."""
    for k, n, _ in _plans():
        if clusters and n > 12_288 * clusters:
            with pytest.raises(texc.ShapeError, match="12,288 columns"):
                _plan(k, n, clusters)
            continue
        p = _plan(k, n, clusters)
        assert p.threads % 32 == 0 and p.threads <= (384 if p.r == 8
                                                     else 512)
        assert p.sets * p.lanes <= p.threads < p.sets * p.lanes + 32
        assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= min(32, k) or (
            p.lanes == 1)
        assert p.r in (1, 2, 4, 8) and 4 * p.r * p.sets >= p.nb
        assert p.r < 4 or p.lanes == 1
        assert p.nb % 4 == 0 and p.clusters * p.nb >= n
        assert p.clusters * p.nb - n < 4 * p.clusters
        assert p.smem_bytes <= 232_448
        assert p.on_sets == p.sets or p.on_sets % (32 // p.lanes) == 0
        assert p.l4 >= p.r * p.on_sets
        if p.on_sets and p.lanes >= 8:
            assert p.l4 % 2 == 1
        elif p.on_sets and p.lanes in (2, 4):
            assert p.l4 % 8 == 8 // p.lanes
        assert p.ldw == 4 * p.r * (p.sets - p.on_sets)
        assert (p.lda, p.ldb) == (-(-k // 4) * 4, -(-n // 4) * 4)
    # d that 8 blocks cannot hold keeps its last sets in the scratch.
    big = cuda_dl.bcd_cluster_plan(256, 3712)
    assert big.clusters == 8 and 0 < big.on_sets < big.sets and big.ldw
    assert cuda_dl.bcd_cluster_plan(256, 1024).ldw == 0


@pytest.fixture
def on_card(monkeypatch):
    """bcd_sweep's routes as on the card, with each launch faked: it
    records its route and returns d."""
    calls = []

    def launch(route):
        def fake(a, b, d):
            calls.append(route)
            return d.clone()
        return fake

    monkeypatch.setattr(cuda_dl, "_runs_plain", lambda t: False)
    monkeypatch.setattr(cuda_dl, "_bcd_registers_launch", launch("registers"))
    monkeypatch.setattr(cuda_dl, "_bcd_cluster_launch", launch("cluster"))
    monkeypatch.setattr(cuda_dl, "_bcd_shared_launch", launch("shared"))
    for name in ("launches", "register_launches", "cluster_launches"):
        monkeypatch.setattr(cuda_dl.bcd_sweep, name, 0)
    return calls


def _sweep(k, n):
    z = torch.zeros
    return cuda_dl.bcd_sweep(z((k, k)), z((k, n)), z((k, n)))


def test_wrapper_counts_each_route_and_never_the_first_design(on_card):
    shapes = [(256, 64), (256, 65), (8, 98176), (37, 50), (300, 777)]
    for k, n in shapes:
        _sweep(k, n)
    assert on_card == ["registers", "cluster", "cluster", "registers",
                       "cluster"]
    w = cuda_dl.bcd_sweep
    assert (w.launches, w.register_launches, w.cluster_launches) == (5, 2, 3)
    assert not hasattr(w, "shared_launches")


def test_a_failed_cluster_launch_raises_and_never_falls_back(on_card,
                                                             monkeypatch):
    def broken(a, b, d):
        raise RuntimeError("bcd_sweep launch failed: cudaError 700")

    monkeypatch.setattr(cuda_dl, "_bcd_cluster_launch", broken)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _sweep(256, 208)
    assert on_card == []      # neither the register route nor dl_bcd.cu
    assert cuda_dl.bcd_sweep.launches == 0
    assert cuda_dl.bcd_sweep.cluster_launches == 0


@pytest.mark.parametrize("k,n", PAST + [(4000, 13)])
def test_shapes_past_the_gate_are_refused_before_launch(on_card, k, n):
    with pytest.raises(texc.ShapeError, match="at most 15 MiB"):
        cuda_dl.check_bcd_args(torch.zeros((k, k)), torch.zeros((k, n)),
                               torch.zeros((k, n)))
    with pytest.raises(texc.ShapeError, match="_bcd_kernel=False"):
        cuda_dl.bcd_sweep(torch.zeros((k, k)), torch.zeros((k, n)),
                          torch.zeros((k, n)))
    assert on_card == []


@pytest.mark.parametrize("k,n", CORNERS)
def test_the_gate_corners_reach_the_cluster_route(on_card, k, n):
    z = torch.zeros
    cuda_dl.bcd_sweep(z((k, k)), z((k, n)), z((k, n)))
    assert on_card == ["cluster"]


# dictionary_learning.solve at K x N = 60 x 1,000 = 60,000, above the first
# design's 53,248, which the cluster route takes. f64 on the CPU (its sweep
# is bcd_sweep's twin, the composition) against decomp_tpu's solve on the
# same data, d0 and x0 to 1e-10 (the f64 composition parity of
# tests/test_torch_dl.py); then f32 with _bcd_kernel=True (bcd_sweep, whose
# twin runs on the CPU) against decomp_tpu's Pallas sweep in interpret mode
# to 1e-5 (tests/test_torch_dl.py's limit for that route), and 'auto' gates
# the shape through bcd_fits.
def test_solve_beyond_the_old_limit_matches_jax():
    rng = np.random.default_rng(23)
    k, n, m = 60, 1000, 90
    d_true = rng.normal(size=(k, n))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    codes = rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.2)
    y = codes @ d_true + 0.01 * rng.normal(size=(m, n))
    d0 = d_true + 0.3 * rng.normal(size=(k, n))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    x0 = 0.1 * rng.normal(size=(m, k))
    assert k * n > 53_248 and cuda_dl.bcd_fits(k, n)
    assert cuda_dl.bcd_route(k, n) == "cluster"
    kw = dict(tol=0.0, maxiter=5, lasso_iter=6, record_objective=True)
    rj = decomp_tpu.dictionary_learning.solve(y, d0, 0.05, x0, **kw)
    rt = tdl.solve(torch.from_numpy(y), torch.from_numpy(d0), 0.05,
                   torch.from_numpy(x0), **kw)
    assert rt.d.dtype == torch.float64
    assert rel_err(rt.d.numpy(), np.asarray(rj.d)) < 1e-10
    assert rel_err(rt.x.numpy(), np.asarray(rj.x)) < 1e-10
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-9)
    y32, d32, x32 = (v.astype(np.float32) for v in (y, d0, x0))
    kw = dict(tol=0.0, maxiter=3, lasso_iter=4)
    rj = decomp_tpu.dictionary_learning.solve(y32, d32, 0.05, x32,
                                              _bcd_pallas="interpret", **kw)
    before = cuda_dl.bcd_sweep.launches
    rt = tdl.solve(torch.from_numpy(y32), torch.from_numpy(d32), 0.05,
                   torch.from_numpy(x32), _bcd_kernel=True, **kw)
    assert cuda_dl.bcd_sweep.launches == before      # CPU: the twin ran
    assert rel_err(rt.d.numpy(), np.asarray(rj.d)) < 1e-5
    assert rel_err(rt.x.numpy(), np.asarray(rj.x)) < 1e-5
    assert tdl._bcd_mode(None, None, torch.from_numpy(y32), k, n) is False
    assert tdl._bcd_mode(True, None, torch.from_numpy(y32), k, n) is True
