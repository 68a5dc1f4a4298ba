"""Out-of-core NMF in the PyTorch port against ``decomp_tpu``:
``nmf.solve_streaming`` on the host-array path and in loader mode
(``jit_loader=True``), and the ``masked_completion_streaming`` preset.

The same numpy inputs, made from a seed, go through both packages. JAX's
loaders slice a device array with ``dynamic_slice`` (its fused epoch traces
them); the port's slice the numpy array. The held-out tests pass
``decomp_tpu``'s per-chunk reserves (``nmf_streaming.py:857-867``:
``uniform(fold_in(fold_in(PRNGKey(seed), _HELDOUT_SALT), lo))``) to the
port's private ``_chunk_reserve`` hook. The kernel gate's test runs JAX's
Pallas chunk kernels in interpret mode against the port's twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu.models.nmf import _HELDOUT_SALT
from decomp_tpu_torch.models import nmf_streaming as tns
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import checkpoint as tck
from decomp_tpu_torch.utils import convert
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_nmf, random_mask, rel_err

tnmf = decomp_tpu_torch.nmf
jnmf = decomp_tpu.nmf


def _init(seed, m, n, k, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, k)).astype(dtype),
            rng.uniform(0.1, 1.0, (k, n)).astype(dtype))


def _np(v):
    return convert.to_numpy(v)


def _same(rt, rj, lim):
    """d and x within ``lim`` relative, the same niter and converged."""
    assert rel_err(_np(rt.d), rj.d) < lim
    assert rel_err(_np(rt.x), rj.x) < lim
    assert rt.niter == int(rj.niter)
    assert rt.converged == bool(rj.converged)


def _loaders(y, chunk, mask=None):
    """(JAX loader, port loader) pairs for y and mask: fixed-size windows
    of ``chunk`` rows, JAX's by dynamic_slice (traced ``lo``)."""
    m, n = y.shape

    def pair(a):
        if a is None:
            return None, None
        aj = jnp.asarray(a)
        return ((lambda lo, hi: jax.lax.dynamic_slice(aj, (lo, 0),
                                                      (chunk, n))),
                (lambda lo, hi: a[lo:hi]))

    return pair(y), pair(mask)


def _jax_reserve(seed, frac):
    """decomp_tpu's per-chunk reserve draw (nmf_streaming.py:857-867;
    dl_streaming.py:304-310): the port's ``_chunk_reserve`` hook."""
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                             _HELDOUT_SALT)

    def reserve(lo, shape):
        kv = jax.random.fold_in(key, np.uint32(lo))
        return np.asarray(jax.random.uniform(kv, shape) < frac,
                          dtype=np.float64)

    return reserve


# The host-array path, f64: both packages run the same compositions per
# chunk, so they agree to summation order: d and x to 1e-10 with equal
# niter (measured <= 1.6e-15). The port's streamed run also equals its own
# in-core solve from the same start (1e-10; measured <= 1.6e-15).
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("inner_iter", [1, 3])
def test_host_path_matches_jax(method, masked, inner_iter):
    y, *_ = planted_nmf(seed=40, n_samples=83, n_channels=30, rank=4)
    mask = random_mask(41, y.shape) if masked else None
    x0, d0 = _init(42, 83, 30, 4)
    kw = dict(tol=0.0, maxiter=15, method=method, mask=mask, chunk_rows=17,
              inner_iter=inner_iter)
    rj = jnmf.solve_streaming(y, d0, x=x0, **kw)
    rt = tnmf.solve_streaming(y, d0, x=x0, device="cpu", **kw)
    assert isinstance(rt.x, np.ndarray) and rt.x.dtype == np.float64
    assert rt.d.dtype == torch.float64
    _same(rt, rj, 1e-10)
    core = tnmf.solve(torch.from_numpy(y), torch.from_numpy(d0),
                      x=torch.from_numpy(x0), tol=0.0, maxiter=15,
                      method=method, inner_iter=inner_iter,
                      mask=None if mask is None else torch.from_numpy(mask))
    assert rel_err(_np(rt.d), core.d.numpy()) < 1e-10
    assert rel_err(rt.x, core.x.numpy()) < 1e-10


# The seeded start: d then x from np.random.default_rng(random_seed),
# scaled by the observed mean of the first 4,096 rows, as decomp_tpu draws
# them. f64: one iteration from it agrees to 1e-12 (measured <= 2.6e-16);
# f32: 1e-6 (the f32 means sum in another order; measured <= 2.4e-7).
@pytest.mark.parametrize("dtype,lim", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("masked", [False, True])
def test_seeded_start_matches_jax(masked, dtype, lim):
    y, *_ = planted_nmf(seed=43, n_samples=70, n_channels=20, rank=3)
    y = y.astype(dtype)
    mask = random_mask(44, y.shape).astype(dtype) if masked else None
    kw = dict(rank=3, tol=0.0, maxiter=1, mask=mask, chunk_rows=32,
              random_seed=9)
    rj = jnmf.solve_streaming(y, **kw)
    rt = tnmf.solve_streaming(y, device="cpu", **kw)
    assert rel_err(_np(rt.d), rj.d) < lim
    assert rel_err(rt.x, rj.x) < lim


# Mixed precision: bf16 data (a CPU tensor: numpy has no bf16) with f32
# factors. Both packages form the same quantised products, but in other
# summation orders whose one-ulp f32 differences flip bf16 roundings of the
# operands and grow: after 25 iterations 5e-3 (the bound decomp_tpu's own
# streamed-against-in-core test keeps; measured <= 1.9e-3, dense KL), and
# after one iteration 1e-5 (measured <= 1.1e-7).
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
@pytest.mark.parametrize("masked", [False, True])
def test_mixed_precision_matches_jax(method, masked):
    y, *_ = planted_nmf(seed=50, n_samples=83, n_channels=30, rank=4)
    y16 = np.asarray(jnp.asarray(y, jnp.bfloat16))
    mask = random_mask(51, y.shape).astype(np.float32) if masked else None
    x0, d0 = _init(52, 83, 30, 4, np.float32)
    for iters, lim in ((1, 1e-5), (25, 5e-3)):
        rj = jnmf.solve_streaming(
            y16, d0, x=x0, mask=None if mask is None else
            np.asarray(jnp.asarray(mask, jnp.bfloat16)), tol=0.0,
            maxiter=iters, method=method, chunk_rows=17,
            factor_dtype=jnp.float32, precision="default")
        rt = tnmf.solve_streaming(
            torch.from_numpy(y16.astype(np.float32)).to(torch.bfloat16), d0,
            x=x0, mask=None if mask is None else torch.from_numpy(mask).to(
                torch.bfloat16), tol=0.0, maxiter=iters, method=method,
            chunk_rows=17, factor_dtype=torch.float32, device="cpu")
        assert isinstance(rt.x, np.ndarray) and rt.x.dtype == np.float32
        assert rt.d.dtype == torch.float32
        assert rel_err(rt.x, rj.x) < lim
        assert rel_err(_np(rt.d), rj.d) < lim


def test_convergence_and_callback_match_jax():
    y, *_ = planted_nmf(seed=43, n_samples=64, n_channels=40, rank=4)
    x0, d0 = _init(44, 64, 40, 4)
    seen = []
    kw = dict(tol=1e-4, maxiter=5000, chunk_rows=16)
    rj = jnmf.solve_streaming(y, d0, x=x0, **kw)
    rt = tnmf.solve_streaming(y, d0, x=x0, device="cpu",
                              callback=lambda it, diff: seen.append(diff),
                              **kw)
    assert rt.converged and len(seen) == rt.niter and seen[-1] < 1e-4
    _same(rt, rj, 1e-10)


def test_loader_and_x_device_match_arrays():
    """A loader on the host path and x on the device reproduce the array
    path bit for bit (the same chunks through the same steps)."""
    y, *_ = planted_nmf(seed=90, n_samples=300, n_channels=64, rank=6)
    y32 = y.astype(np.float32)
    x0, d0 = _init(91, 300, 64, 6, np.float32)
    kw = dict(tol=0.0, maxiter=12, chunk_rows=77, device="cpu")
    ref = tnmf.solve_streaming(y32, d0, x=x0, **kw)
    res = tnmf.solve_streaming(lambda lo, hi: y32[lo:hi], d0, x=x0,
                               n_samples=300, n_channels=64,
                               dtype=torch.float32, **kw)
    np.testing.assert_array_equal(res.x, ref.x)
    assert torch.equal(res.d, ref.d)
    dev = tnmf.solve_streaming(y32, d0, x=x0, x_device=True, **kw)
    assert isinstance(dev.x, torch.Tensor)
    np.testing.assert_array_equal(dev.x.numpy(), ref.x)
    assert torch.equal(dev.d, ref.d)


# record_objective: 0.5 ||mask * (y - x d)||^2 with the fresh x against the
# pre-update d, per chunk: the curve to 1e-10 relative in f64 (measured
# <= 6.4e-16).
@pytest.mark.parametrize("masked", [False, True])
def test_record_objective_matches_jax(masked):
    y, *_ = planted_nmf(seed=94, n_samples=200, n_channels=40, rank=4)
    mask = random_mask(95, y.shape) if masked else None
    x0, d0 = _init(96, 200, 40, 4)
    kw = dict(tol=0.0, maxiter=10, chunk_rows=64, record_objective=True,
              mask=mask)
    rj = jnmf.solve_streaming(y, d0, x=x0, **kw)
    rt = tnmf.solve_streaming(y, d0, x=x0, device="cpu", **kw)
    assert rt.objective.dtype == torch.float64
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-10)
    assert rt.objective[-1] < rt.objective[0]


# Loader mode (jit_loader) against decomp_tpu's fused epoch, f64, with a
# ragged tail (509 is prime): the trailing chunk reads the clamped window
# and keeps the padding's x. d and x to 1e-10 (measured <= 9.4e-16); the
# port's loader mode also equals its host-array path (1e-12; measured 0)
# and keeps x's padding rows out of the result.
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
@pytest.mark.parametrize("masked", [False, True])
def test_loader_mode_matches_jax(method, masked):
    m, n, k, chunk = 509, 48, 4, 64
    y, *_ = planted_nmf(seed=103, n_samples=m, n_channels=n, rank=k)
    mask = random_mask(104, y.shape) if masked else None
    ym = y if mask is None else y * mask
    x0, d0 = _init(105, m, n, k)
    (yj, yt), (mj, mt) = _loaders(ym, chunk, mask)
    kw = dict(tol=0.0, maxiter=12, method=method, chunk_rows=chunk,
              n_samples=m, n_channels=n, x_device=True, jit_loader=True)
    rj = jnmf.solve_streaming(yj, d0, x=x0, mask=mj, dtype=np.float64, **kw)
    rt = tnmf.solve_streaming(yt, d0, x=x0, mask=mt, dtype=torch.float64,
                              device="cpu", **kw)
    assert rt.x.shape == (m, k) and isinstance(rt.x, torch.Tensor)
    _same(rt, rj, 1e-10)
    host = tnmf.solve_streaming(ym, d0, x=x0, mask=mask, tol=0.0, maxiter=12,
                                method=method, chunk_rows=chunk,
                                device="cpu")
    assert rel_err(_np(rt.d), host.d.numpy()) < 1e-12
    assert rel_err(_np(rt.x), host.x) < 1e-12


# The kernel gate: use_kernel=True runs each chunk through its cuda_mu
# wrapper, on CPU chunks the plain twin, against JAX's Pallas chunk kernels
# in interpret mode at a 128-aligned shape (f32). Both quantise at the
# kernels' points and sum in f32 in other orders: 1e-5 (decomp_tpu's own
# kernel-against-jnp limit; measured <= 2.3e-7).
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunk_kernels_match_pallas(method, masked):
    rng = np.random.default_rng(97)
    m, n, k, chunk = 384, 128, 128, 128
    y = np.maximum(rng.uniform(0, 1, (m, 8)) @ rng.uniform(0, 1, (8, n))
                   + 0.01 * rng.normal(size=(m, n)), 0).astype(np.float32)
    mask = ((rng.random((m, n)) >= 0.3).astype(np.float32) if masked
            else None)
    x0, d0 = _init(98, m, n, k, np.float32)
    (yj, yt), (mj, mt) = _loaders(y, chunk, mask)
    kw = dict(tol=0.0, maxiter=4, method=method, chunk_rows=chunk,
              n_samples=m, n_channels=n, x_device=True, jit_loader=True)
    rj = jnmf.solve_streaming(yj, d0, x=x0, mask=mj, dtype=np.float32,
                              use_pallas=True, _pallas_interpret=True, **kw)
    calls = []
    name = ("kl_stats" if method == "kl-mu" else "mu_stats") + (
        "_masked" if masked else "_dense")
    wrapped = getattr(cuda_mu, name)

    def counted(*a, **k_):
        calls.append(a[1].dtype if masked else None)
        return wrapped(*a, **k_)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_mu, name, counted)
        rt = tnmf.solve_streaming(yt, d0, x=x0, mask=mt, dtype=torch.float32,
                                  use_kernel=True, device="cpu", **kw)
    # One wrapper call per chunk per epoch; a 0/1 mask goes as bits.
    assert len(calls) == 4 * (m // chunk)
    assert all(c == torch.int32 for c in calls) or not masked
    assert rel_err(_np(rt.d), rj.d) < 1e-5
    assert rel_err(_np(rt.x), rj.x) < 1e-5


def test_kernel_gate_refusals():
    """use_kernel=True names the first unmet condition; 'auto' keeps the
    composition on CPU chunks; the host-array path refuses True."""
    m, n, chunk = 256, 32, 64
    y = np.random.default_rng(1).uniform(0, 1, (m, n))
    yt = _loaders(y.astype(np.float32), chunk)[0][1]
    x0, d0 = _init(2, m, n, 4, np.float32)
    kw = dict(tol=0.0, maxiter=2, chunk_rows=chunk, n_samples=m,
              n_channels=n, x_device=True, jit_loader=True, device="cpu",
              use_kernel=True)
    cases = [
        (dict(dtype=torch.float32, record_objective=True), "record_objective"),
        (dict(dtype=torch.float32, method="kl-mu",
              factor_dtype=torch.float64), "factor_dtype"),
        (dict(dtype=torch.float32, inner_iter=2, method="kl-mu"),
         "inner_iter"),
        (dict(dtype=torch.float32, inner_iter=2,
              mask=lambda lo, hi: np.ones((hi - lo, n), np.float32)),
         "inner_iter"),
        (dict(dtype=torch.float64), "bfloat16 or float32"),
        (dict(dtype=torch.float32, factor_dtype=torch.float64),
         "data's dtype or float32"),
    ]
    for extra, match in cases:
        with pytest.raises(texc.DecompError, match=match):
            tnmf.solve_streaming(yt, d0, x=x0, **{**kw, **extra})
    xr, dr = _init(3, m, n, 10_625, np.float32)
    with pytest.raises(texc.DecompError, match="rank"):
        tnmf.solve_streaming(yt, dr, x=xr, dtype=torch.float32, **kw)
    assert not tns._chunk_kernel_gate(
        "auto", on_cuda=False, method="mu", mixed=False,
        record_objective=False, rank=4, n=n, y_dtype=torch.float32,
        fdt=torch.float32, masked=False, inner_iter=1)
    assert tns._chunk_kernel_gate(
        "auto", on_cuda=True, method="mu", mixed=True,
        record_objective=False, rank=128, n=n, y_dtype=torch.bfloat16,
        fdt=torch.float32, masked=True, inner_iter=1)
    with pytest.raises(texc.DecompError, match="jit_loader"):
        tnmf.solve_streaming(y, d0, x=x0, use_kernel=True, device="cpu")
    with pytest.raises(texc.DecompError, match="use_kernel"):
        tnmf.solve_streaming(yt, d0, x=x0, **{**kw, "use_kernel": "bogus",
                                               "dtype": torch.float32})


def test_kernel_chunks_pack_once_and_read_nothing(monkeypatch):
    """Loader mode with the kernels (twins on CPU): each chunk's 0/1 mask
    is checked (one host read) in the first epoch only and packed without
    a read after; the epochs read nothing at tol=0, and with tol > 0 only
    the check epochs do."""
    m, n, k, chunk = 256, 32, 4, 64
    y, *_ = planted_nmf(seed=5, n_samples=m, n_channels=n, rank=k)
    mask = random_mask(6, y.shape).astype(np.float32)
    ym = (y * mask).astype(np.float32)
    x0, d0 = _init(7, m, n, k, np.float32)
    checked, reads = [], []
    pack = cuda_mu.pack_mask
    monkeypatch.setattr(cuda_mu, "pack_mask",
                        lambda t: checked.append(1) or pack(t))
    for name in ("__float__", "__bool__", "item"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, _o=orig: reads.append(1) or _o(self))
    kw = dict(x=x0, mask=lambda lo, hi: mask[lo:hi], chunk_rows=chunk,
              n_samples=m, n_channels=n, dtype=torch.float32, x_device=True,
              jit_loader=True, use_kernel=True, device="cpu")
    counts = []
    for iters in (2, 6):
        checked.clear()
        reads.clear()
        tnmf.solve_streaming(lambda lo, hi: ym[lo:hi], d0, tol=0.0,
                             maxiter=iters, **kw)
        counts.append((len(checked), len(reads)))
    assert counts[0] == counts[1] and counts[0][0] == m // chunk
    reads.clear()
    tnmf.solve_streaming(lambda lo, hi: ym[lo:hi], d0, tol=1e-30,
                         maxiter=12, check_every=4, **kw)
    assert len(reads) == counts[0][1] + 3   # one read per check epoch


def test_kernel_and_loader_errors_propagate(monkeypatch):
    """Nothing catches a chunk kernel's failure (no fallback to the
    composition or to another device, under 'auto' as under True), nor a
    loader's own error."""
    m, n, chunk = 256, 32, 64
    y = np.random.default_rng(8).uniform(0, 1, (m, n)).astype(np.float32)
    kw = dict(rank=4, tol=0.0, maxiter=2, chunk_rows=chunk, n_samples=m,
              n_channels=n, dtype=torch.float32, x_device=True,
              jit_loader=True, device="cpu")

    def broken(*a, **k_):
        raise RuntimeError("mu_stats_dense launch failed: cudaError 719")

    monkeypatch.setattr(cuda_mu, "mu_stats_dense", broken)
    with pytest.raises(RuntimeError, match="cudaError 719"):
        tnmf.solve_streaming(lambda lo, hi: y[lo:hi], use_kernel=True, **kw)
    monkeypatch.setattr(tns, "_chunk_kernel_gate", lambda *a, **k_: True)
    with pytest.raises(RuntimeError, match="cudaError 719"):
        tnmf.solve_streaming(lambda lo, hi: y[lo:hi], **kw)

    def missing(lo, hi):
        raise FileNotFoundError("shard 7 missing")

    with pytest.raises(FileNotFoundError, match="shard 7"):
        tnmf.solve_streaming(missing, **kw)


# stop='heldout' in loader mode, fed decomp_tpu's per-chunk reserves: the
# same checks stop both packages on the same epoch; d and x to 1e-10
# (f64; measured <= 8.5e-16), the reported validation error to 1e-6
# relative (measured 0).
@pytest.mark.parametrize("tol,check_every,maxiter", [(1e-2, 5, 300),
                                                     (np.inf, 5, 10)])
def test_heldout_stop_matches_jax(tol, check_every, maxiter):
    rng = np.random.default_rng(99)
    m, n, k, chunk = 300, 32, 4, 64     # ragged: the tail reserves nothing
    ytrue = (rng.uniform(0, 1, (m, k)) @ rng.uniform(0, 1, (k, n))
             + 0.02 * rng.normal(size=(m, n)))
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    x0, d0 = _init(100, m, n, k)
    (yj, yt), (mj, mt) = _loaders(ytrue * mask, chunk, mask)
    kw = dict(tol=tol, maxiter=maxiter, chunk_rows=chunk, n_samples=m,
              n_channels=n, x_device=True, jit_loader=True, stop="heldout",
              check_every=check_every, random_seed=3, heldout_frac=0.1)
    rj = jnmf.solve_streaming(yj, d0, x=x0, mask=mj, dtype=np.float64, **kw)
    rt = tnmf.solve_streaming(yt, d0, x=x0, mask=mt, dtype=torch.float64,
                              device="cpu",
                              _chunk_reserve=_jax_reserve(3, 0.1), **kw)
    assert rt.converged
    _same(rt, rj, 1e-10)
    np.testing.assert_allclose(float(rt.aux["heldout_rel_err"]),
                               float(rj.aux["heldout_rel_err"]), rtol=1e-6)
    # The port's own draw: every epoch reserves the same entries, so two
    # runs agree bit for bit, and the reported error tracks the true one.
    kw["tol"], kw["maxiter"] = 1e-3, 300
    a = tnmf.solve_streaming(yt, d0, x=x0, mask=mt, dtype=torch.float64,
                             device="cpu", **kw)
    b = tnmf.solve_streaming(yt, d0, x=x0, mask=mt, dtype=torch.float64,
                             device="cpu", **kw)
    assert torch.equal(a.d, b.d) and a.niter == b.niter
    miss = mask == 0
    recon = a.x.numpy() @ a.d.numpy()
    true = np.linalg.norm(recon[miss] - ytrue[miss]) / np.linalg.norm(
        ytrue[miss])
    assert true < 0.1
    assert abs(float(a.aux["heldout_rel_err"]) - true) < 0.5 * true


def test_chunk_reserve_depends_on_the_offset_alone():
    r = tns._reserve_fn(None, 5, 0.3, torch.device("cpu"))
    assert torch.equal(r(128, (64, 8)), r(128, (64, 8)))
    assert not torch.equal(r(0, (64, 8)), r(64, (64, 8)))
    seeds = {tns._chunk_seed(5, lo) % 2 ** 32 for lo in range(0, 2 ** 20, 7)}
    assert len(seeds) == len(range(0, 2 ** 20, 7))


# check_every with a rel-change tol: the stop lands on a check epoch, at
# most check_every - 1 epochs after the per-epoch stop, the callback fires
# on check epochs only, and niter equals decomp_tpu's.
def test_check_every_matches_jax():
    rng = np.random.default_rng(102)
    m, n, k, chunk = 512, 64, 4, 128
    y = np.maximum(rng.uniform(0, 1, (m, k)) @ rng.uniform(0, 1, (k, n))
                   + 0.01 * rng.normal(size=(m, n)), 0)
    x0, d0 = _init(103, m, n, k)
    (yj, yt), _ = _loaders(y, chunk)
    kw = dict(tol=1e-3, maxiter=2000, chunk_rows=chunk, n_samples=m,
              n_channels=n, x_device=True, jit_loader=True)
    per = tnmf.solve_streaming(yt, d0, x=x0, dtype=torch.float64,
                               check_every=1, device="cpu", **kw)
    calls = []
    amort = tnmf.solve_streaming(yt, d0, x=x0, dtype=torch.float64,
                                 check_every=7, device="cpu",
                                 callback=lambda it, diff: calls.append(it),
                                 **kw)
    rj = jnmf.solve_streaming(yj, d0, x=x0, dtype=np.float64, check_every=7,
                              **kw)
    assert per.converged and amort.converged
    assert per.niter <= amort.niter < per.niter + 7
    assert calls == [i for i in range(1, amort.niter + 1) if i % 7 == 0]
    _same(amort, rj, 1e-10)


# hbm_cache_chunks: cached chunks skip the loader and the trajectory is
# the same bit for bit, with the cache covering every chunk, a ragged tail
# in the cache or in the loader segment, a mask and the held-out reserve.
@pytest.mark.parametrize("m,cache_chunks,masked", [
    (512, 2, False), (512, 4, False), (509, 4, False), (509, 2, True),
    (509, 4, True)])
def test_hbm_cache_matches_uncached(m, cache_chunks, masked):
    n, k, chunk = 48, 4, 128
    y, *_ = planted_nmf(seed=115, n_samples=m, n_channels=n, rank=k)
    mask = random_mask(116, y.shape) if masked else None
    ym = y if mask is None else y * mask
    x0, d0 = _init(117, m, n, k)
    calls = []

    def loader(lo, hi):
        calls.append(lo)
        return ym[lo:hi]

    kw = dict(x=x0, tol=0.0, maxiter=6, chunk_rows=chunk, n_samples=m,
              n_channels=n, dtype=torch.float64, x_device=True,
              jit_loader=True, device="cpu",
              mask=None if mask is None else (lambda lo, hi: mask[lo:hi]))
    if masked:
        kw.update(stop="heldout", check_every=2, tol=-1.0)
    ref = tnmf.solve_streaming(loader, d0, **kw)
    calls.clear()
    res = tnmf.solve_streaming(loader, d0, hbm_cache_chunks=cache_chunks,
                               **kw)
    assert torch.equal(res.d, ref.d) and torch.equal(res.x, ref.x)
    n_chunks = -(-m // chunk)
    assert len(calls) == cache_chunks + 6 * (n_chunks - cache_chunks)


def test_masked_completion_streaming_matches_jax():
    """The preset over loaders: held-out stopped masked MU in loader mode,
    fed decomp_tpu's reserves, equal to decomp_tpu's run (f64, 1e-10);
    a mesh that is not a DeviceMesh is refused (the sharded preset is
    tested in test_torch_parallel_streaming.py); mixed=True casts f32
    chunks to bf16 and keeps f32 factors."""
    rng = np.random.default_rng(113)
    m, n, k, chunk = 512, 32, 4, 128
    ytrue = (rng.uniform(0, 1, (m, k)) @ rng.uniform(0, 1, (k, n))
             + 0.02 * rng.normal(size=(m, n)))
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    x0, d0 = _init(114, m, n, k)
    (yj, yt), (mj, mt) = _loaders(ytrue * mask, chunk, mask)
    kw = dict(x=x0, d=d0, n_samples=m, n_channels=n, chunk_rows=chunk,
              tol=5e-3, maxiter=400, check_every=10, random_seed=3)
    rj = jnmf.masked_completion_streaming(yj, mj, dtype=np.float64, **kw)
    rt = tnmf.masked_completion_streaming(
        yt, mt, dtype=torch.float64, device="cpu",
        _chunk_reserve=_jax_reserve(3, 0.05), **kw)
    assert rt.converged
    _same(rt, rj, 1e-10)
    with pytest.raises(texc.DecompError,
                       match="mesh must be a torch DeviceMesh"):
        tnmf.masked_completion_streaming(yt, mt, dtype=torch.float64,
                                         device="cpu", mesh=object(), **kw)
    y32, m32 = (ytrue * mask).astype(np.float32), mask.astype(np.float32)
    mixed = tnmf.masked_completion_streaming(
        lambda lo, hi: y32[lo:hi], lambda lo, hi: m32[lo:hi],
        dtype=torch.float32, device="cpu", mixed=True,
        **{**kw, "x": x0.astype(np.float32), "d": d0.astype(np.float32),
           "maxiter": 30})
    assert mixed.x.dtype == mixed.d.dtype == torch.float32
    assert float(mixed.aux["heldout_rel_err"]) < 0.2


def test_refusals_raise_like_jax():
    """The same exception types as decomp_tpu's for the same mistakes."""
    rng = np.random.default_rng(60)
    y = rng.uniform(0, 1, (64, 40))
    mask = (rng.random((64, 40)) >= 0.3).astype(np.float64)
    d = rng.uniform(0, 1, (4, 40))
    load = (lambda lo, hi: y[lo:hi])
    cases = [
        ((y,), {}),                                    # neither d nor rank
        ((y,), dict(rank=4, chunk_rows=0)),
        ((y,), dict(rank=4, method="nope")),
        ((y,), dict(rank=4, stop="bogus")),
        ((y,), dict(rank=4, mask=mask, stop="heldout")),
        ((y,), dict(rank=4, hbm_cache_chunks=2)),
        ((y,), dict(rank=4, inner_iter=0)),
        ((y, rng.uniform(0, 1, (4, 41))), dict(chunk_rows=32, maxiter=2)),
        ((y, rng.uniform(0, 1, (40,))), dict(chunk_rows=32, maxiter=2)),
        ((y, d), dict(rank=5, chunk_rows=32, maxiter=2)),
        ((y.astype(np.complex128),), dict(rank=4)),
        ((load,), dict(rank=4)),                       # no n_samples
        ((load,), dict(rank=4, n_samples=64, n_channels=40,
                       dtype=np.float64, mask=mask)),
        ((y,), dict(rank=4, jit_loader=True, x_device=True)),
        ((load,), dict(rank=4, n_samples=64, n_channels=40,
                       jit_loader=True)),
        ((load,), dict(rank=4, n_samples=64, n_channels=40, chunk_rows=128,
                       jit_loader=True, x_device=True)),
        ((load,), dict(rank=4, n_samples=64, n_channels=40, chunk_rows=32,
                       jit_loader=True, x_device=True, stop="heldout")),
        ((load,), dict(rank=4, n_samples=64, n_channels=40, chunk_rows=32,
                       jit_loader=True, x_device=True, stop="heldout",
                       mask=lambda lo, hi: mask[lo:hi],
                       record_objective=True)),
    ]
    for args, kw in cases:
        with pytest.raises(Exception) as ej:
            jnmf.solve_streaming(*args, maxiter=2, **{
                k_: v for k_, v in kw.items() if k_ != "maxiter"})
        tkw = {k_: v for k_, v in kw.items() if k_ != "maxiter"}
        if "dtype" in tkw or "n_samples" in tkw:
            tkw["dtype"] = torch.float64
        with pytest.raises(Exception) as et:
            tnmf.solve_streaming(*args, maxiter=2, device="cpu", **tkw)
        assert type(et.value).__name__ == type(ej.value).__name__, (kw,
                                                                    et.value)


def test_device_rule(monkeypatch):
    """With no card and no device= the streaming entry points raise as the
    others do; device='cpu' runs; a d on another device is refused."""
    y, *_ = planted_nmf(seed=61, n_samples=40, n_channels=20, rank=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(texc.DecompError, match="no CUDA device"):
        tnmf.solve_streaming(y, rank=3, maxiter=2)
    with pytest.raises(texc.DecompError, match="no CUDA device"):
        tnmf.masked_completion_streaming(
            lambda lo, hi: y[lo:hi], lambda lo, hi: np.ones_like(y[lo:hi]),
            rank=3, n_samples=40, n_channels=20, dtype=torch.float64,
            chunk_rows=20, maxiter=2)
    res = tnmf.solve_streaming(y, rank=3, maxiter=2, device="cpu")
    assert res.d.device.type == "cpu"
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        tnmf.solve_streaming(y, torch.ones((3, 20), device="meta"),
                             maxiter=2, device="cpu")


# checkpointed_solve over the streaming solve: the epochs are Markovian in
# (x, d), so chunked budgets equal the straight run bit for bit, on the
# host-array path (numpy x) and in loader mode (x on the device), and an
# interrupted run resumes from its snapshot.
@pytest.mark.parametrize("loader_mode", [False, True])
def test_checkpointed_streaming_equals_straight(tmp_path, loader_mode):
    y, *_ = planted_nmf(seed=62, n_samples=60, n_channels=40, rank=4)
    x0, d0 = _init(63, 60, 40, 4)
    kw = dict(tol=0.0, chunk_rows=30, device="cpu", d=d0, x=x0)
    first = y
    if loader_mode:
        first = (lambda lo, hi: y[lo:hi])
        kw.update(n_samples=60, n_channels=40, dtype=torch.float64,
                  jit_loader=True, x_device=True)
    straight = tnmf.solve_streaming(first, maxiter=12, **kw)
    mgr = tck.CheckpointManager(str(tmp_path / "s"))
    res, total = tck.checkpointed_solve(tnmf.solve_streaming, first,
                                        manager=mgr, chunk_iters=4,
                                        maxiter=12, **kw)
    assert total == 12
    assert torch.equal(res.d, straight.d)
    np.testing.assert_array_equal(_np(res.x), _np(straight.x))
    mgr2 = tck.CheckpointManager(str(tmp_path / "s2"))
    tck.checkpointed_solve(tnmf.solve_streaming, first, manager=mgr2,
                           chunk_iters=4, maxiter=8, **kw)
    res2, total2 = tck.checkpointed_solve(tnmf.solve_streaming, first,
                                          manager=mgr2, chunk_iters=4,
                                          maxiter=12, **kw)
    assert total2 == 12 and torch.equal(res2.d, straight.d)


def test_jax_streaming_snapshot_resumes_in_the_port(tmp_path):
    """A decomp_tpu snapshot of a streaming solve resumes in the port: 8
    iterations in JAX and 4 in the port equal 12 in JAX (f64, 1e-10)."""
    from decomp_tpu.utils import checkpoint as jck

    y, *_ = planted_nmf(seed=64, n_samples=60, n_channels=40, rank=4)
    x0, d0 = _init(65, 60, 40, 4)
    kw = dict(tol=0.0, chunk_rows=30, d=d0, x=x0)
    path = str(tmp_path / "j")
    jck.checkpointed_solve(jnmf.solve_streaming, y, manager=jck.
                           CheckpointManager(path), chunk_iters=4,
                           maxiter=8, **kw)
    res, total = tck.checkpointed_solve(
        tnmf.solve_streaming, y, manager=tck.CheckpointManager(path),
        chunk_iters=4, maxiter=12, device="cpu", **kw)
    straight = jnmf.solve_streaming(y, maxiter=12, **kw)
    assert total == 12
    assert rel_err(_np(res.d), straight.d) < 1e-10
    assert rel_err(res.x, straight.x) < 1e-10
