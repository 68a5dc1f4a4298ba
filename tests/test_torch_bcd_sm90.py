"""``bcd_sweep``'s register route (``csrc/dl_bcd_sm90.cu``) on the CPU: a
plain torch emulation of the kernel's summation order held to the plain
twin and to ``decomp_tpu`` (the Pallas BCD sweep in interpret mode and the
JAX composition sweep), the route predicate, the row strides and padding
the wrapper hands the kernel, and the wrapper's routes with the launches
faked. The kernel itself runs only on the card (``chip_smoke.py`` phase
13). The same numpy inputs, made from a seed, go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decomp_tpu.models.dictionary_learning import _bcd_dict_update
from decomp_tpu_torch.ops import cuda_dl
from problems import rel_err

# chip_smoke.py's BCD_LIMIT: relative Frobenius of d after one sweep.
BCD_LIMIT = 5e-6
LANES, ROWS, COLS, WARPS = 32, 8, 4, 16


def _fma(a, b, c):
    """f32 fma(a, b, c): the product is exact in f64; the f64 sum may round
    once before the f32 rounding, which no limit here can see."""
    return (a.double() * b.double() + c.double()).float()


def _lane_products(arow, dd, skip=None):
    """Each lane's 8-row FMA chains of a d[:, c], (32, N4); ``skip`` =
    (lane, register): that lane's term of that row is zero in its chain."""
    a8 = arow.view(LANES, ROWS, 1).clone()
    if skip is not None:
        a8[skip] = 0
    d8 = dd.view(LANES, ROWS, -1)
    acc = a8[:, 0] * d8[:, 0]
    for j in range(1, ROWS):
        acc = _fma(a8[:, j], d8[:, j], acc)
    return acc


def _fold(acc):
    """The reduce-scatter's tree over the 32 lane partials (xor 16, 8, 4,
    2, 1: halves folded in that order)."""
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return acc[0]


def emulate_sm90(a, b, d):
    """The register route's arithmetic in plain torch f32. Lane l of a warp
    holds rows 8 l .. 8 l + 7 of the warp's 4 columns: each lane sums its
    rows in an FMA chain, and the 32 lane partials of a column meet in the
    reduce-scatter's tree; for atom k >= 1 the lane that holds row k - 1
    leaves it out (the chains run before that row's division), and its
    term a_k,k-1 d_k-1 (rounded) is added to the tree's sum. u = (b - s) +
    a_kk d_k; each warp sums u^2 over its 4 columns in an FMA chain, and
    the 16 warp partials (0 past the last warp) meet in block_norm2's
    pairwise tree."""
    k, n = d.shape
    n4 = -(-n // COLS) * COLS
    tiny = torch.tensor(torch.finfo(torch.float32).tiny)
    dd = torch.zeros((LANES * ROWS, n4))
    dd[:k, :n] = d
    bb = torch.zeros((k, n4))
    bb[:, :n] = b
    arows = torch.zeros((k, LANES * ROWS))
    arows[:, :k] = a
    s = _fold(_lane_products(arows[0], dd))
    for kk in range(k):
        u = (bb[kk] - s) + a[kk, kk] * dd[kk]
        u[n:] = 0
        uw = u.view(-1, COLS)
        q = torch.zeros(uw.shape[0])
        for c in range(COLS):
            q = _fma(uw[:, c], uw[:, c], q)
        p = torch.zeros(WARPS)
        p[:q.shape[0]] = q
        s4 = (p[0::4] + p[1::4]) + (p[2::4] + p[3::4])
        norm = torch.sqrt((s4[0] + s4[1]) + (s4[2] + s4[3]))
        if norm > tiny:
            dd[kk] = u / torch.maximum(norm, tiny)
        if kk + 1 < k:
            owner = (kk // ROWS, kk % ROWS)
            s = (_fold(_lane_products(arows[kk + 1], dd, skip=owner))
                 + arows[kk + 1, kk] * dd[kk])
    return dd[:k, :n].clone()


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
    "config3_256x64": dict(seed=1, k=256, n=64),
    "ragged_37x50": dict(seed=2, k=37, n=50),
    "dead_atom": dict(seed=3, k=256, n=64, dead=7),
    "ill_conditioned": dict(seed=4, k=64, n=48, decades=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_twin_and_jax(case):
    kw = CASES[case]
    a, b, d = _inputs(**kw)
    ta, tb, td = (torch.from_numpy(v) for v in (a, b, d))
    got = emulate_sm90(ta, tb, td)
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


def test_emulation_is_not_the_twin_bit_for_bit():
    """The emulation sums in the kernel's order, not cuBLAS's or the CPU
    twin's: it agrees within the limit but is its own arithmetic (so the
    limit, not equality, is what the card's check can hold)."""
    a, b, d = (torch.from_numpy(v) for v in _inputs(5, 256, 64))
    got, twin = emulate_sm90(a, b, d), cuda_dl.bcd_sweep_plain(a, b, d)
    assert not torch.equal(got, twin)
    assert rel_err(got.numpy(), twin.numpy()) < BCD_LIMIT


@pytest.mark.parametrize("k,n,route", [
    (256, 64, "registers"),      # BASELINE config 3
    (37, 50, "registers"),
    (1, 1, "registers"),
    (256, 1, "registers"),
    (1, 64, "registers"),
    (256, 65, "cluster"),
    (257, 64, "cluster"),
    (256, 208, "cluster"),       # phase 14b's dictionary
    (16, 3000, "cluster"),
    (1024, 52, "cluster"),
])
def test_route_by_shape(k, n, route):
    assert cuda_dl.bcd_route(k, n) == route
    assert cuda_dl.bcd_fits(k, n)     # both routes take only what fits


def test_register_route_limits_and_bcd_fits_unchanged():
    assert (cuda_dl.BCD_REG_MAX_ATOMS, cuda_dl.BCD_REG_MAX_CHANNELS) == (256, 64)
    # 512 threads x 32 registers of d hold the largest register shape.
    assert 512 * ROWS * COLS == 256 * 64
    # bcd_fits is the TPU kernel's gate: the first design's K x N <=
    # 53,248 no longer bounds it, the padded working set does.
    assert cuda_dl.bcd_fits(256, 209) and cuda_dl.bcd_fits(256, 3712)
    assert not cuda_dl.bcd_fits(256, 3713) and not cuda_dl.bcd_fits(2048, 26)
    assert cuda_dl.bcd_route(256, 209) == "cluster"


@pytest.mark.parametrize("k,n,strides", [
    (256, 64, (256, 64)), (37, 50, (40, 52)), (1, 1, (8, 4)),
    (250, 61, (256, 64)), (8, 4, (8, 4))])
def test_register_strides(k, n, strides):
    assert cuda_dl.bcd_reg_strides(k, n) == strides


def test_rows_are_padded_only_where_needed():
    a = torch.randn(37, 37)
    pa = cuda_dl._bcd_rows(a, 40)
    assert pa.shape == (37, 40) and pa.is_contiguous()
    assert torch.equal(pa[:, :37], a) and not pa[:, 37:].any()
    b = torch.randn(256, 64)
    assert cuda_dl._bcd_rows(b, 64) is b
    view = torch.randn(300, 65)[:, 1:]         # not contiguous
    pv = cuda_dl._bcd_rows(view, 64)
    assert pv is not view and torch.equal(pv, view) and pv.is_contiguous()
    off = torch.randn(4 * 64 + 1)[1:].view(4, 64)  # 4 bytes past alignment
    assert off.data_ptr() % 16 and cuda_dl._bcd_rows(off, 64) is not off


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


def test_wrapper_counts_each_route(on_card):
    for k, n in ((256, 64), (37, 50), (256, 208), (256, 64), (16, 3000)):
        _sweep(k, n)
    assert on_card == ["registers", "registers", "cluster", "registers",
                       "cluster"]
    w = cuda_dl.bcd_sweep
    assert (w.launches, w.register_launches, w.cluster_launches) == (5, 3, 2)


def test_a_failed_launch_raises_and_never_falls_back(on_card, monkeypatch):
    def broken(a, b, d):
        raise RuntimeError("bcd_sweep launch failed: cudaError 700")

    monkeypatch.setattr(cuda_dl, "_bcd_registers_launch", broken)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _sweep(256, 64)
    assert on_card == []              # the cluster route was not tried
    assert cuda_dl.bcd_sweep.launches == 0


def test_shapes_neither_route_takes_are_refused_before_launch(on_card):
    with pytest.raises(Exception, match="at most 15 MiB"):
        _sweep(256, 3713)
    assert on_card == []
