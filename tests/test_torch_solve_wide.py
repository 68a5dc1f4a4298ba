"""The whole-solve lasso above 1,024 features in the PyTorch port: the wide
route of ``cuda_lasso.solve_rows``, which on the card runs
``csrc/lasso_fista_wide.cu`` (a thread-block cluster a group of row slots;
'high' as bf16x3, 'highest' as bf16x6) for every F inside the TPU kernel's
gate (``cuda_lasso.solve_fits``: 1,408 reals with momentum, 1,536 without,
640 complex features). On the CPU the wrapper runs its twin, held here
against ``decomp_tpu``'s Pallas kernel in interpret mode through
``lasso.solve``, ``lasso.solve`` on complex64 data (against
``solve_split``) and dictionary learning's inner coding; then the gate
against ``pallas_fista.fits_vmem``, the three-limb stage images, the
routes and the launcher's arguments with the card's launches faked, and
'auto''s rule. The same numpy inputs, made from a seed, go through both
packages. The CUDA kernel itself runs only on the card (``chip_smoke.py``
phases 9b and 10d, ``tools/solve_wide_turns.py``)."""

import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.ops import complex_split as cs
from decomp_tpu.ops import pallas_fista
from decomp_tpu_torch.models import dictionary_learning as tdl
from decomp_tpu_torch.models import lasso as tl
from decomp_tpu_torch.ops import cuda_lasso, cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err

# lasso.solve's alpha: sparse enough solutions that the exact mode's rows
# stop within the test's iterations.
ALPHA = 0.2


def _t(a):
    return torch.from_numpy(np.array(a))


def _real_problem(seed, m, f):
    """A planted f32 batch over F features at N = F / 2 channels: a normal
    over sqrt(N), 5%-sparse truth, 0.01 noise."""
    rng = np.random.default_rng(seed)
    n = f // 2
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    xt = rng.normal(size=(m, f)) * (rng.random((m, f)) < 0.05)
    y = (xt @ a + 0.01 * rng.normal(size=(m, n))).astype(np.float32)
    return y, a


def _complex_problem(seed, m, fc):
    """The same over Fc complex features at Fc / 2 complex channels."""
    rng = np.random.default_rng(seed)
    n = fc // 2

    def cnormal(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    a = (cnormal(fc, n) / np.sqrt(2 * n)).astype(np.complex64)
    xt = cnormal(m, fc) * (rng.random((m, fc)) < 0.05)
    y = (xt @ a + 0.01 * cnormal(m, n)).astype(np.complex64)
    return y, a


def _split_np(v):
    return np.asarray(v.re) + 1j * np.asarray(v.im)


# (a) The gate: the port's copy against the TPU kernel's, on F padded as
# the JAX callers pad it (real: to 128; complex: Fc to 128, doubled), over
# every width from 16 to 2,048 reals, at every (momentum, hi_lo, group).
@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("hi_lo", [False, True])
@pytest.mark.parametrize("momentum", [False, True])
def test_solve_fits_is_the_tpu_gate(momentum, hi_lo, group):
    for f in range(16, 2049, 16):
        f_pad = (2 * (-(-(f // 2) // 128) * 128) if group
                 else -(-f // 128) * 128)
        assert cuda_lasso.solve_fits(f, momentum, hi_lo, group) == \
            pallas_fista.fits_vmem(f_pad, momentum, hi_lo, group=group), f


def test_the_gates_edges():
    """The corners of the TPU kernel's gate, at either precision: 1,408
    reals with momentum, 1,536 without, 640 complex features."""
    for hi_lo in (False, True):
        assert cuda_lasso.solve_max_features(True, hi_lo) == 1408
        assert cuda_lasso.solve_max_features(False, hi_lo) == 1536
        for momentum in (False, True):
            assert cuda_lasso.solve_max_features(momentum, hi_lo,
                                                 group=True) == 1280
    assert cuda_lasso.solve_fits(1408) and not cuda_lasso.solve_fits(1409)
    assert cuda_lasso.solve_fits(1536, momentum=False)
    assert not cuda_lasso.solve_fits(1537, momentum=False)
    assert cuda_lasso.solve_fits(1280, group=True)
    assert not cuda_lasso.solve_fits(1282, group=True)
    assert [cuda_lasso.solve_route(f) for f in (1, 1024, 1025, 1536)] == [
        "narrow", "narrow", "wide", "wide"]


# (b) lasso.solve(use_kernel=True) on the CPU (the twin) against
# decomp_tpu's Pallas path in interpret mode, above 1,024 features: in exact
# mode (tol 1e-5) and in the fixed budget (tol 0, 17 iterations), with the
# limits of tests/test_torch_lasso_whole.py: niter equal on >= 90% of rows,
# those rows within 1e-4 and all rows within 1e-3, the fixed budget within
# 1e-5 (measured: niter equal on >= 93.7% of rows, those rows within
# 5.3e-6, all rows within 1.1e-5, the fixed budget within 4.6e-6).
@pytest.mark.parametrize("f,method,precision,m", [
    (1152, "acc_ista", "high", 16), (1152, "parallel_cd", "highest", 24),
    (1408, "fista", "high", 32), (1408, "acc_ista", "highest", 16),
    (1536, "ista", "highest", 48), (1536, "parallel_cd", "high", 16)])
def test_wide_kernel_path_matches_pallas(f, method, precision, m):
    y, a = _real_problem(f + m, m, f)
    alpha = (np.linspace(0.1, 0.3, f).astype(np.float32)
             if method == "fista" else ALPHA)
    kw = dict(method=method, tol=1e-5, maxiter=300, per_problem=True,
              precision=precision)
    rj = decomp_tpu.lasso.solve(y, a, alpha, use_pallas=True,
                                _pallas_interpret=True, **kw)
    before = cuda_lasso.solve_rows.launches
    rt = tl.solve(_t(y), _t(a), _t(alpha), use_kernel=True, **kw)
    assert cuda_lasso.solve_rows.launches == before   # CPU: the twin ran
    same = rt.niter.numpy() == np.asarray(rj.niter)
    assert same.mean() >= 0.9
    assert rel_err(rt.x.numpy()[same], np.asarray(rj.x)[same]) < 1e-4
    assert rel_err(rt.x.numpy(), rj.x) < 1e-3
    assert rt.converged.float().mean() >= 0.9
    kw.update(tol=0.0, maxiter=17)
    rj = decomp_tpu.lasso.solve(y, a, alpha, use_pallas=True,
                                _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), _t(alpha), use_kernel=True, **kw)
    assert (rt.niter == 17).all() and not rt.converged.any()
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


# (c) Complex64 above 512 complex features: lasso.solve(use_kernel=True) on
# the CPU (the complex twin) against decomp_tpu's split kernel path,
# solve_split(use_pallas=True) in interpret mode, with the limits of
# tests/test_torch_lasso_complex_kernel.py (tol 1e-4; measured: niter equal
# on every row, x within 2.3e-6, the fixed budget within 1.7e-6).
@pytest.mark.parametrize("fc,method,precision,m", [
    (513, "acc_ista", "high", 16), (640, "fista", "highest", 16),
    (640, "ista", "high", 24)])
def test_wide_complex_path_matches_pallas(fc, method, precision, m):
    y, a = _complex_problem(fc + m, m, fc)
    kw = dict(method=method, tol=1e-4, maxiter=300, per_problem=True,
              precision=precision)
    rj = decomp_tpu.lasso.solve_split(cs.from_numpy(y), cs.from_numpy(a),
                                      ALPHA, use_pallas=True,
                                      _pallas_interpret=True, **kw)
    before = (cuda_lasso.solve_rows.launches,
              cuda_lasso.solve_rows.complex_launches)
    rt = tl.solve(_t(y), _t(a), ALPHA, use_kernel=True, **kw)
    assert before == (cuda_lasso.solve_rows.launches,
                      cuda_lasso.solve_rows.complex_launches)  # the twin
    assert rt.x.dtype == torch.complex64 and rt.x.shape == (m, fc)
    xj = _split_np(rj.x)
    same = rt.niter.numpy() == np.asarray(rj.niter)
    assert same.mean() >= 0.9
    assert rel_err(rt.x.numpy()[same], xj[same]) < 1e-4
    assert rel_err(rt.x.numpy(), xj) < 1e-3
    assert rt.converged.float().mean() >= 0.9
    kw.update(tol=0.0, maxiter=17)
    rj = decomp_tpu.lasso.solve_split(cs.from_numpy(y), cs.from_numpy(a),
                                      ALPHA, use_pallas=True,
                                      _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, use_kernel=True, **kw)
    assert (rt.niter == 17).all() and not rt.converged.any()
    assert rel_err(rt.x.numpy(), _split_np(rj.x)) < 1e-5


# (d) Dictionary learning with 1,152 atoms, use_kernel=True: the inner
# coding in the whole-solve kernel's fixed budget (lasso_tol 0) on the
# wide route (its twin here), two outer iterations, against decomp_tpu's
# Pallas route in interpret mode: 5e-5, the limit of
# tests/test_torch_dl.py's whole-kernel test (measured: d 2.4e-5, x 6.3e-6;
# 1,152 atoms over 64 channels sum many more products than that test's).
def test_dictionary_learning_wide_inner_coding_matches_pallas():
    rng = np.random.default_rng(28)
    k, n, m = 1152, 64, 48
    d_true = rng.normal(size=(k, n))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    xt = rng.normal(size=(m, k)) * (rng.random((m, k)) < 0.01)
    y = (xt @ d_true + 0.01 * rng.normal(size=(m, n))).astype(np.float32)
    d0 = rng.normal(size=(k, n)).astype(np.float32)
    kw = dict(maxiter=2, lasso_iter=8, lasso_tol=0.0)
    rj = decomp_tpu.dictionary_learning.solve(y, d0, 0.05, use_pallas=True,
                                              _pallas_interpret=True, **kw)
    before = cuda_lasso.solve_rows.launches
    rt = tdl.solve(_t(y), _t(d0), 0.05, use_kernel=True, **kw)
    assert cuda_lasso.solve_rows.launches == before
    assert rel_err(rt.d.numpy(), rj.d) < 5e-5
    assert rel_err(rt.x.numpy(), rj.x) < 5e-5


def test_tile_images_three_limbs_read_back():
    """'highest''s stage images (``limbs=3``): each chunk's stage holds the
    three round-to-nearest limbs of ``cuda_mu.split_bf16x3``, in that
    order, read with the kernel's addressing, zeros past the matrix; the
    limbs add up to the value within 2^-24."""
    f = 1100
    v = torch.from_numpy(np.random.default_rng(3).normal(
        size=(f, f)).astype(np.float32))
    rows = cuda_lasso.stage_rows(f)
    assert rows == [512, 512, 80]
    img = cuda_lasso.tile_images(v, limbs=3).view(torch.int16)
    nks = -(-f // 16)
    assert img.shape == (nks * 3 * sum(rows) * 16,)
    want = [h.view(torch.int16) for h in cuda_mu.split_bf16x3(v)]
    back = sum(h.float() for h in cuda_mu.split_bf16x3(v))
    assert float((back - v).abs().max() / v.abs().max()) < 2 ** -23
    for c, (chunk, r_c) in enumerate(zip(
            img.split([nks * 3 * r * 16 for r in rows]), rows)):
        r, kk = torch.arange(r_c), torch.arange(16)
        col = (8 * ((kk[None, :] // 8) ^ ((r[:, None] >> 2) & 1))
               + kk[None, :] % 8)
        read = chunk.reshape(nks, 3, r_c, 16).gather(
            -1, col.expand(nks, 3, r_c, 16))
        read = read.permute(1, 2, 0, 3).reshape(3, r_c, nks * 16)
        for got, w in zip(read, want):
            part = w[c * 512:c * 512 + r_c]
            assert torch.equal(got[:part.shape[0], :f], part)
            assert not bool(got[part.shape[0]:].any())
            assert not bool(got[:, f:].any())


def _batch(seed, m, f, complex_):
    """solve_rows' operands: (yah, gram, x0, z0, t0, done0, nit0) and the
    step, f32 or complex64."""
    y, a = (_complex_problem if complex_ else _real_problem)(seed, m, f)
    y, a = _t(y), _t(a)
    ah = a.conj().T
    gram = a @ ah
    step = 1.0 / float(torch.linalg.matrix_norm(gram, 2))
    x0 = torch.zeros((m, f), dtype=y.dtype)
    return (y @ ah, gram, x0, x0, torch.ones(m), torch.zeros(m),
            torch.zeros(m, dtype=torch.int32)), step


@pytest.fixture
def routed(monkeypatch):
    """solve_rows as if on the card: each launcher's checks run, the call
    recorded and replaced by the twin on the Gram it was given (a pair
    Gram expanded)."""
    calls = []

    def fake(name):
        def run(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol, *,
                group=False, **kw):
            pairs = group and gram.shape[0] != gram.shape[1]
            cuda_lasso.check_solve_rows_args(
                yah, gram, x0, z0, t0, done0, nit0, kw["maxiter"],
                kw["block_rows"], pairs=pairs, momentum=kw["momentum"],
                hi_lo=kw["hi_lo"], group=group)
            calls.append((name, tuple(gram.shape), group, kw["hi_lo"]))
            g = (cuda_lasso.embed_gram(cuda_lasso.from_pairs(gram).T)
                 if pairs else gram)
            return cuda_lasso.solve_rows_plain(yah, g, x0, z0, t0, done0,
                                               nit0, stepsz, thresh, tol,
                                               group=group, **kw)
        return run

    monkeypatch.setattr(cuda_lasso, "_runs_plain", lambda t: False)
    for name in ("wide", "tma", "mma"):
        monkeypatch.setattr(cuda_lasso, f"_solve_rows_{name}", fake(name))
    return calls


def test_routes_by_width(routed):
    """Above 1,024 reals both precisions take the wide kernel, which reads
    the pair Gram in the complex mode (from complex64 or from the
    embedding); at 1,024 and below the routes stay the narrow kernels';
    every route gives the twin's bits."""
    kw = dict(momentum=False, restart=False, maxiter=6)
    for f, route in ((1025, "wide"), (1024, None)):
        (yah, gram, x0, z0, t0, d0, n0), step = _batch(f, 4, f, False)
        args = (yah, gram, x0, z0, t0, d0, n0, step, 0.05 * step, 1e-4)
        routed.clear()
        for hi_lo in (True, False):
            got = cuda_lasso.solve_rows(*args, hi_lo=hi_lo, **kw)
            ref = cuda_lasso.solve_rows_plain(*args, hi_lo=hi_lo, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert routed == ([(route, (f, f), False, True),
                           (route, (f, f), False, False)] if route else
                          [("tma", (f, f), False, True),
                           ("mma", (f, f), False, False)])
    (cy, cg, cx, cz, t0, d0, n0), step = _batch(5, 4, 513, True)
    cargs = (cy, cg, cx, cz, t0, d0, n0, step, 0.05 * step, 1e-4)
    routed.clear()
    for hi_lo in (True, False):
        got = cuda_lasso.solve_rows(*cargs, hi_lo=hi_lo, **kw)
        ref = cuda_lasso.solve_rows_plain(*cargs, hi_lo=hi_lo, **kw)
        assert got[0].dtype == torch.complex64
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    py, pg, px, pz, pst, pth = cuda_lasso._complex_pairs(cy, cg, cx, cz, step,
                                                         0.05 * step)
    got = cuda_lasso.solve_rows(py, pg, px, pz, t0, d0, n0, pst, pth, 1e-4,
                                hi_lo=False, group=True, **kw)
    ref = cuda_lasso.solve_rows_plain(py, pg, px, pz, t0, d0, n0, pst, pth,
                                      1e-4, hi_lo=False, group=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert routed == [("wide", (513, 1026), True, True),
                      ("wide", (513, 1026), True, False),
                      ("wide", (513, 1026), True, False)]


def test_wide_band_refusals(routed):
    """In the band the clusters hold 16 rows: 32 a block is refused, by
    solve_rows and by check_solve_rows_args; past the gate solve_rows and
    lasso.solve(use_kernel=True) raise with the gate's edge; nothing
    launches."""
    m, z = 4, torch.zeros
    assert cuda_lasso.stripe_rows(None, 1152) == 16
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        cuda_lasso.check_solve_rows_args(
            z((m, 1152)), z((1152, 1152)), z((m, 1152)), z((m, 1152)),
            z(m), z(m), z(m), 10, 32)
    assert cuda_lasso.check_solve_rows_args(
        z((m, 1152)), z((1152, 1152)), z((m, 1152)), z((m, 1152)), z(m),
        z(m), z(m), 10, 16) == 16
    kw = dict(momentum=True, restart=True, maxiter=6)
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(7, m, 1152, False)
    args = (yah, gram, x0, z0, t0, d0, n0, step, 0.05 * step, 1e-4)
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        cuda_lasso.solve_rows(*args, block_rows=32, **kw)
    big = torch.zeros((m, 1409))
    with pytest.raises(texc.ShapeError, match="1 <= F <= 1408"):
        cuda_lasso.solve_rows(big, torch.zeros((1409, 1409)), big, big,
                              z(m), z(m), z(m), 1.0, 0.1, 1e-4, **kw)
    cbig = torch.zeros((m, 641), dtype=torch.complex64)
    with pytest.raises(texc.ShapeError, match="640 complex"):
        cuda_lasso.solve_rows(cbig, torch.zeros((641, 641),
                                                dtype=torch.complex64),
                              cbig, cbig, z(m), z(m), z(m), 1.0, 0.1, 1e-4,
                              **kw)
    assert routed == []
    y = torch.zeros((m, 8), dtype=torch.complex64)
    with pytest.raises(texc.DecompError, match="at most 640 complex"):
        tl.solve(y, torch.zeros((641, 8), dtype=torch.complex64), 0.1,
                 use_kernel=True, per_problem=True)


@pytest.fixture
def fake_launch(monkeypatch):
    """The wide launcher on CPU tensors, as far as the C call: the
    arguments (the stream appended) checked against the declared ctypes
    signature, recorded, and not run."""
    calls = []

    def c_function(source, name, argtypes):
        return SimpleNamespace(source=source, name=name, argtypes=argtypes)

    def launch(name, fn, device, *args):
        args = args + (0,)   # the stream
        assert len(args) == len(fn.argtypes), (fn.name, len(args))
        for a, t in zip(args, fn.argtypes):
            assert isinstance(a, float if t is ctypes.c_float else int)
        calls.append((fn.source, fn.name, args))

    monkeypatch.setattr(cuda_lasso, "_c_function", c_function)
    monkeypatch.setattr(cuda_lasso, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    return calls


@pytest.mark.parametrize("complex_,hi_lo", [(False, True), (False, False),
                                            (True, True), (True, False)])
def test_wide_launch_arguments(fake_launch, complex_, hi_lo):
    """The wide launcher passes what its C entry declares: the limbs (2
    'high', 3 'highest'), at most 132 / 3 clusters of 16 rows, and is
    counted in ``.launches``, ``.wide_launches`` and, complex,
    ``.complex_launches``; the narrow kernels' counts stay."""
    m, f = 40, (513 if complex_ else 1100)
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(13, m, f, complex_)
    w = cuda_lasso.solve_rows
    before = (w.launches, w.wide_launches, w.complex_launches,
              w.tma_launches)
    kw = dict(momentum=True, restart=True, maxiter=9, hi_lo=hi_lo)
    cuda_lasso._solve_rows_wide(
        *((cuda_lasso.as_pairs(yah), cuda_lasso.pair_gram(gram),
           cuda_lasso.as_pairs(x0), cuda_lasso.as_pairs(z0))
          if complex_ else (yah, gram, x0, z0)),
        t0, d0, n0, step, 0.05 * step, 1e-4, group=complex_, **kw)
    assert (w.launches, w.wide_launches, w.complex_launches,
            w.tma_launches) == (before[0] + 1, before[1] + 1,
                                before[2] + int(complex_), before[3])
    assert w.slot_iters.shape == (3,)
    ((src, name, a),) = fake_launch
    assert (src, name) == ("lasso_fista_wide", "lasso_solve_rows_wide_launch")
    reals = 2 * f if complex_ else f
    # limbs, momentum, restart, fixed, group, clusters; ...; M, F, maxiter
    assert a[:6] == (2 if hi_lo else 3, 1, 1, 0, int(complex_), 3)
    assert a[16:19] == (m, reals, 9)


def test_auto_takes_the_wide_route_where_the_card_measured_it_faster():
    """use_kernel='auto' on a CUDA tensor (a stand-in: the gate reads only
    ``is_cuda``) above 1,024 reals: the wide route for f32 and complex64
    at both precisions inside the gate, by method (the card measured it
    faster than the composition at every width, method and batch size it
    timed); the composition past it."""
    card = SimpleNamespace(is_cuda=True)
    alpha = torch.tensor(0.1)

    def mode(dtype, f, precision="high", method="acc_ista"):
        return tl._kernel_mode("auto", card, None, method, dtype, f, True,
                               False, precision, alpha)

    f32, c64 = torch.float32, torch.complex64
    for precision in ("high", "highest"):
        for f, method, fits in ((1152, "acc_ista", True),
                                (1408, "fista", True),
                                (1409, "acc_ista", False),
                                (1536, "ista", True),
                                (1537, "parallel_cd", False)):
            assert mode(f32, f, precision, method) == (
                "whole" if fits else None)
        for fc, fits in ((513, True), (640, True), (641, False)):
            assert mode(c64, fc, precision) == ("whole" if fits else None)
    # Under 'highest' complex64 keeps the composition from 257 to 512
    # features, where the narrow kernel lost, and takes the wide route above.
    assert mode(c64, 512, "highest") is None
    assert mode(c64, 513, "highest") == "whole"
    assert mode(torch.float64, 1152) is None
    assert mode(torch.complex128, 640) is None
