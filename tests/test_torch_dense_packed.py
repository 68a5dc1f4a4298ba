"""Dense MU's f32 route in the PyTorch port, ``csrc/mu_dense_packed.cu``
(bf16x6 limb products on ``wgmma``): a plain emulation of the kernel's
arithmetic against the full-f32 twin and f64, the route ``mu_stats_dense``
and ``nmf.solve(method='mu')`` take, the shape-only partial counts, the
layout of d's limbs, the refusals before any launch, and the twin against
``decomp_tpu``'s dense MU Pallas kernel in interpret mode at f32. The same
numpy inputs, made from a seed, go through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_kl_dense_packed import _prod
from test_torch_nmf import _t

# chip_smoke.py's limit for f32 kernels against their twin (LIMIT[f32]).
_F32_LIMIT = 2e-6
_F32 = torch.float32


def _inputs(seed, m, n, k, lognormal=False):
    """f32 (y, x, d): uniform, or log-normal e^(ln 10 z) over about six
    decades (chip_smoke.py's phase 3e draws them so)."""
    rng = np.random.default_rng(seed)
    if lognormal:
        ln10 = np.log(10.0)
        arrs = (np.exp(ln10 * rng.standard_normal(s))
                for s in ((m, n), (m, k), (k, n)))
    else:
        arrs = (rng.uniform(0, 1, (m, n)), rng.uniform(0.1, 1.1, (m, k)),
                rng.uniform(0.1, 1.1, (k, n)))
    return tuple(_t(a.astype(np.float32)) for a in arrs)


def _kernel_chain(y, x, d, eps, inner=1, limbs=3):
    """The kernel's arithmetic in plain torch: the x update's numerator
    over 32-column stages (each stage's limb products added to the sum
    with a round-to-nearest f32 add), the refinements with x ddt in f32;
    then the statistics over 32-row stages within the row chunks of
    ``dense_packed_block_rows``, numd^T += y_s^T x_new_s and gram^T +=
    x_new_s^T x_new_s, and the chunks' partials added in chunk order."""
    eps32 = torch.tensor(eps, dtype=_F32)
    m, n = y.shape
    k = d.shape[0]
    num = torch.zeros((m, k), dtype=_F32)
    for s in range(0, n, 32):
        num = num + _prod(y[:, s:s + 32], d[:, s:s + 32].T, limbs, 32)
    ddt = cuda_mu.gram_rows(d)
    x_new = x
    for _ in range(inner):
        x_new = x_new * num / (x_new @ ddt + eps32)
    rows = cuda_mu.dense_packed_block_rows(m, n)
    numd_t, gram_t = None, None
    for c in range(0, m, rows):
        pn = torch.zeros((n, k), dtype=_F32)
        pg = torch.zeros((k, k), dtype=_F32)
        for r in range(c, min(c + rows, m), 32):
            xs = x_new[r:min(r + 32, c + rows)]
            pn = pn + _prod(y[r:r + xs.shape[0]].T, xs, limbs, 32)
            pg = pg + _prod(xs.T, xs, limbs, 32)
        numd_t = pn if numd_t is None else numd_t + pn
        gram_t = pg if gram_t is None else gram_t + pg
    return x_new, numd_t.T, gram_t.T


def _f64_chain(y, x, d, eps, inner=1):
    y, x, d = y.double(), x.double(), d.double()
    num = y @ d.T
    for _ in range(inner):
        x = x * num / (x @ (d @ d.T) + eps)
    return x, x.T @ y, x.T @ x


def _errs(got, ref):
    return [rel_err(a.double().numpy(), b.double().numpy())
            for a, b in zip(got, ref)]


@pytest.mark.parametrize("m,n,k,inner,lognormal,eps", [
    (256, 320, 64, 1, False, 1e-6),
    (256, 320, 64, 1, True, 1e-6),
    (160, 200, 96, 3, False, 1e-6),
    (160, 200, 96, 3, True, 1e-6),
    (333, 257, 7, 1, False, 0.0),     # ragged M, N and K, eps = 0
    (333, 257, 1, 3, False, 1e-6),    # K = 1
    (97, 130, 128, 1, True, 0.0),     # K = 128, ragged M and N
    (65, 33, 64, 3, False, 0.0),      # K = 64: the KT = 64 tile's edge
])
def test_emulated_kernel_keeps_f32_accuracy(m, n, k, inner, lognormal, eps):
    """bf16x6 with per-stage big chains keeps x_new, numd and gram within
    chip_smoke.py's f32 limit of the full-f32 twin and of f64, on uniform
    and on log-normal data over about six decades, with one and three
    refinements, at ragged shapes and eps = 0."""
    y, x, d = _inputs(m + n + k + inner, m, n, k, lognormal)
    got = _kernel_chain(y, x, d, eps, inner)
    twin = cuda_mu.mu_stats_dense_plain(y, x, d, eps, inner_iter=inner)
    ref = _f64_chain(y, x, d, eps, inner)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert max(_errs(got, twin)) < _F32_LIMIT
    assert max(_errs(got, ref)) < _F32_LIMIT
    assert max(_errs(twin, ref)) < _F32_LIMIT


def test_bf16x3_shortcut_breaks_the_limit():
    """Two limbs and three products (bf16x3) break the f32 limit on the
    log-normal data that bf16x6 keeps well within it, so phase 3e's
    log-normal shape would catch that shortcut."""
    y, x, d = _inputs(0, 256, 320, 64, lognormal=True)
    ref = _f64_chain(y, x, d, 1e-6)
    assert max(_errs(_kernel_chain(y, x, d, 1e-6), ref)) < _F32_LIMIT / 2
    assert max(_errs(_kernel_chain(y, x, d, 1e-6, limbs=2), ref)) \
        > _F32_LIMIT


@pytest.mark.parametrize("m,n,block_rows,rows,chunks", [
    (262_144, 10112, None, 32768, 8),   # the f32 path: 640 blocks, 97%
    (100_000, 1024, None, 7168, 14),    # 126 blocks of 132
    (1000, 500, None, 64, 16),          # config 1
    (333, 257, None, 32, 11),
    (1, 1, None, 32, 1),
    (1000, 1000, 100, 128, 8),          # 100 rows rounded up to 128
    (1000, 1000, 32, 32, 32),
])
def test_partials_are_a_function_of_the_shape(m, n, block_rows, rows,
                                              chunks):
    """Row chunks of the statistics pass: the wave fill of (128-column N
    tiles + the gram tile) x chunks over the H100's 132 SMs, in whole
    32-row stages; nothing but the shape and block_rows goes in, so the
    summation order, and every bit of the result, is fixed by them."""
    got = cuda_mu.dense_packed_block_rows(m, n, block_rows)
    assert got == rows == cuda_mu.dense_packed_block_rows(m, n, block_rows)
    assert got % 32 == 0 and -(-m // got) == chunks


@pytest.mark.parametrize("k,n", [(128, 40), (100, 33), (64, 7), (7, 257),
                                 (1, 5)])
def test_d_limbs_have_column_limbs_layout(k, n):
    """d's limbs as the kernel's first launch writes them (held bit for bit
    against column_limbs on the card, chip_smoke.py phase 3e): (N, 3 KT)
    bf16, row n = [limb 0 | limb 1 | limb 2] of d[:, n] in split_bf16x3's
    round-to-nearest limbs, zero past K; the limbs give d back to 2^-24."""
    rng = np.random.default_rng(k * n)
    d = _t(np.exp(2 * rng.standard_normal((k, n))).astype(np.float32))
    kt = 64 if k <= 64 else 128
    got = cuda_mu.column_limbs(d, kt)
    assert got.shape == (n, 3 * kt) and got.dtype == torch.bfloat16
    limbs = cuda_mu.split_bf16x3(d)
    for l in range(3):
        assert torch.equal(got[:, l * kt:l * kt + k], limbs[l].T)
        assert not bool(got[:, l * kt + k:(l + 1) * kt].any())
    back = sum(got[:, l * kt:l * kt + k].double() for l in range(3)).T
    assert float(((back - d.double()).abs() / d.double()).max()) <= 2.0 ** -24


def _no_launch(*_):
    raise AssertionError("the kernel was reached")


@pytest.mark.parametrize("case,exc", [
    ("rank 129", texc.ShapeError),
    ("non-contiguous y", texc.DecompError),
    ("bf16 y", texc.DtypeError),
    ("bf16 d", texc.DtypeError),
    ("bf16 x", texc.DtypeError),
    ("f64 y", texc.DtypeError),
    ("x of another height", texc.ShapeError),
    ("inner_iter 0", texc.DecompError),
])
def test_packed_launch_refuses_before_any_launch(monkeypatch, case, exc):
    """What the packed kernel does not take is refused before the library
    is built or called (checked on CPU tensors: the checks do not look at
    the device type)."""
    monkeypatch.setattr(cuda_mu, "_c_function", _no_launch)
    k = 129 if case == "rank 129" else 4
    y, x, d = torch.zeros((16, 24)), torch.zeros((16, k)), torch.zeros((k, 24))
    inner = 0 if case == "inner_iter 0" else 1
    if case == "non-contiguous y":
        y = torch.zeros((24, 16)).T
    elif case == "bf16 y":
        y = y.to(torch.bfloat16)
    elif case == "bf16 d":
        d = d.to(torch.bfloat16)
    elif case == "bf16 x":
        x = x.to(torch.bfloat16)
    elif case == "f64 y":
        y, x, d = y.double(), x.double(), d.double()
    elif case == "x of another height":
        x = torch.zeros((15, k))
    with pytest.raises(exc):
        cuda_mu._dense_packed_launch(y, x, d, 1e-6, None, inner)


@pytest.fixture
def on_card(monkeypatch):
    """mu_stats_dense as if its data lay on the card: the route is the
    card's for the tensor's dtype, and each launch is recorded and
    replaced by the twin; csrc/mu_stats_dense.cu's launch must not be
    reached."""
    calls = []
    route = cuda_mu.dense_route

    def launch(name):
        def run(y, x, d, eps, block_rows=None, inner_iter=1):
            calls.append(name)
            return cuda_mu.mu_stats_dense_plain(y, x, d, eps,
                                                inner_iter=inner_iter)
        return run

    monkeypatch.setattr(cuda_mu, "dense_route",
                        lambda dtype, device: route(dtype, "cuda"))
    monkeypatch.setattr(cuda_mu, "_dense_packed_launch", launch("packed"))
    monkeypatch.setattr(cuda_mu, "_dense_tma_launch", launch("tma"))
    monkeypatch.setattr(cuda_mu, "_dense_mma_launch", _no_launch)
    for name in ("launches", "packed_launches", "tma_launches"):
        monkeypatch.setattr(cuda_mu.mu_stats_dense, name, 0)
    return calls


@pytest.mark.parametrize("dtype,route", [(torch.float32, "packed"),
                                         (torch.bfloat16, "tma")])
@pytest.mark.parametrize("inner", [1, 3])
def test_solve_takes_the_route_once_per_iteration(on_card, dtype, route,
                                                  inner):
    """nmf.solve(method='mu') without a mask launches mu_stats_dense once
    per iteration on its dtype's route (f32: csrc/mu_dense_packed.cu) and
    never csrc/mu_stats_dense.cu; the counters count each route
    apart."""
    y, x, d = _inputs(4, 40, 30, 3)
    res = tnmf.solve(y.to(dtype), d.to(dtype), x=x.to(dtype), tol=0.0,
                     maxiter=6, method="mu", inner_iter=inner,
                     use_kernel=True, device="cpu")
    assert res.niter == 6
    assert on_card == [route] * 6
    w = cuda_mu.mu_stats_dense
    assert w.launches == 6
    assert (w.packed_launches, w.tma_launches) == (
        (6, 0) if route == "packed" else (0, 6))


def _padded_pallas(y, x, d, eps, inner, mp, np_, kp, block_rows):
    """decomp_tpu's dense MU kernel in interpret mode on zero-padded inputs
    (it takes N and K in multiples of 128 and M in whole blocks, as its
    loop pads them), cut back to the shapes given."""
    m, n = y.shape
    k = d.shape[0]

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[:a.shape[0], :a.shape[1]] = a.numpy()
        return jnp.asarray(out)

    xj, numd, gram = pallas_mu.mu_stats_dense(
        pad(y, (mp, np_)), pad(x, (mp, kp)), pad(d, (kp, np_)), eps,
        block_rows=block_rows, interpret=True, inner_iter=inner)
    return (np.asarray(xj)[:m, :k], np.asarray(numd)[:k, :n],
            np.asarray(gram)[:k, :k])


@pytest.mark.parametrize("m,n,k,eps,inner,padded", [
    (333, 257, 7, 1e-6, 1, (336, 384, 128)),
    (333, 257, 7, 1e-6, 3, (336, 384, 128)),
    (64, 256, 128, 0.0, 1, (64, 256, 128)),
    (96, 128, 100, 1e-6, 3, (96, 128, 128)),
])
def test_twin_matches_pallas_f32(m, n, k, eps, inner, padded):
    """The port's mu_stats_dense (its twin on CPU, the function the kernel
    is held to on the card) against decomp_tpu's mu_stats_dense in
    interpret mode, f32 (Precision.HIGHEST there): ragged M, N and K (zero
    padding leaves the JAX kernel's real entries as they are where eps >
    0), and eps = 0 on an aligned shape. Both sum f32 products in another
    order: the f32 limit."""
    y, x, d = _inputs(m * n + k + inner, m, n, k)
    ref = _padded_pallas(y, x, d, eps, inner, *padded, block_rows=16)
    got = cuda_mu.mu_stats_dense(y, x, d, eps, inner_iter=inner)
    for a, b in zip(got, ref):
        assert a.dtype == _F32 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert rel_err(a.numpy(), b) < _F32_LIMIT


def test_solve_kernel_path_matches_pallas_f32():
    """nmf.solve(method='mu') on f32 data through the kernel path (the
    twin on CPU) against decomp_tpu's Pallas kernel in interpret mode, 10
    fixed iterations with two refinements each: 1e-5."""
    rng = np.random.default_rng(33)
    y = rng.uniform(0.1, 1, (64, 128)).astype(np.float32)
    x0 = rng.uniform(0.1, 1, (64, 5)).astype(np.float32)
    d0 = rng.uniform(0.1, 1, (5, 128)).astype(np.float32)
    rj = decomp_tpu.nmf.solve(y, d0, x=x0, tol=0.0, maxiter=10, inner_iter=2,
                              use_pallas=True, pallas_block_rows=16,
                              _pallas_interpret=True)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), tol=0.0, maxiter=10,
                    inner_iter=2, use_kernel=True, device="cpu")
    assert rt.niter == 10
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5
    assert rel_err(rt.d.numpy(), rj.d) < 1e-5
