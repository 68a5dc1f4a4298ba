"""Batch lasso in the PyTorch port against ``decomp_tpu``: ``lasso.solve``
end to end (every method, masked and unmasked, global and per-problem
stopping, resume, complex), its kernel path on the CPU (the twins of
``ops.cuda_lasso``) against the Pallas path in interpret mode, state
carried from a JAX solve into the port, ``solve_streaming``, the errors,
and the rule that an entry point runs on the card unless asked for the CPU.
The same numpy inputs, made from a seed, go through both packages."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.utils import convert
from decomp_tpu_torch.utils import exceptions as texc
from problems import planted_lasso, random_mask, rel_err

ALPHA = 0.05
tl = decomp_tpu_torch.lasso


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same_run(rt, rj, tol):
    """x within ``tol`` relative, the same niter and converged."""
    assert rel_err(_np(rt.x), rj.x) < tol
    np.testing.assert_array_equal(_np(rt.niter), np.asarray(rj.niter))
    np.testing.assert_array_equal(_np(rt.converged),
                                  np.asarray(rj.converged))


# f64 composition paths: x to 1e-10 with equal niter and converged, as the
# NMF parity tests hold theirs.
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista", "cd",
                                    "parallel_cd"])
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("tol,maxiter", [(0.0, 40), (1e-7, 3000)])
def test_solve_matches_jax(method, complex_, tol, maxiter):
    y, a, _ = planted_lasso(seed=1, complex_=complex_)
    kw = dict(tol=tol, maxiter=maxiter, method=method)
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, complex_split=False, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, **kw)
    assert rt.x.dtype == (torch.complex128 if complex_ else torch.float64)
    _assert_same_run(rt, rj, 1e-10)
    if tol > 0:
        assert rt.converged


@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd"])
@pytest.mark.parametrize("per_problem", [False, True])
def test_masked_solve_matches_jax(method, per_problem):
    y, a, _ = planted_lasso(seed=2)
    mask = random_mask(3, y.shape)
    kw = dict(tol=1e-6, maxiter=5000, method=method, per_problem=per_problem)
    rj = decomp_tpu.lasso.solve(y * mask, a, ALPHA, mask=mask, **kw)
    rt = tl.solve(_t(y * mask), _t(a), ALPHA, mask=_t(mask), **kw)
    _assert_same_run(rt, rj, 1e-10)


@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd"])
@pytest.mark.parametrize("complex_", [False, True])
def test_per_problem_matches_jax(method, complex_):
    rng = np.random.default_rng(21)
    a = rng.normal(size=(24, 96))
    y = rng.normal(size=(6, 96)) * (10.0 ** rng.uniform(-2, 1, size=(6, 1)))
    if complex_:
        a = a + 1j * rng.normal(size=a.shape)
        y = y + 1j * rng.normal(size=y.shape)
    kw = dict(tol=1e-6, maxiter=5000, method=method, per_problem=True)
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, complex_split=False, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, **kw)
    assert rt.niter.shape == (6,) and rt.niter.dtype == torch.int32
    assert len(set(rt.niter.tolist())) > 1
    _assert_same_run(rt, rj, 1e-10)


def test_complex64_matches_jax():
    y, a, _ = planted_lasso(seed=16, complex_=True)
    y, a = y.astype(np.complex64), a.astype(np.complex64)
    kw = dict(tol=0.0, maxiter=35, method="acc_ista")
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, complex_split=False, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, complex_split=True, **kw)
    assert rt.x.dtype == torch.complex64
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5


def test_1d_y_and_alpha_shapes_match_jax():
    y, a, _ = planted_lasso(seed=7)
    kw = dict(tol=0.0, maxiter=30, method="fista")
    r1 = tl.solve(_t(y[0]), _t(a), ALPHA, **kw)
    assert r1.x.shape == (a.shape[0],)
    assert rel_err(r1.x.numpy(), decomp_tpu.lasso.solve(y[0], a, ALPHA,
                                                        **kw).x) < 1e-10
    rng = np.random.default_rng(9)
    for alpha in (rng.uniform(0.01, 0.1, a.shape[0]),           # feature
                  rng.uniform(0.01, 0.1, (y.shape[0], a.shape[0]))):  # sample
        rj = decomp_tpu.lasso.solve(y, a, alpha, **kw)
        rt = tl.solve(_t(y), _t(a), _t(alpha), **kw)
        assert rel_err(rt.x.numpy(), rj.x) < 1e-10
    rp = tl.solve(_t(y[0]), _t(a), ALPHA, tol=1e-6, maxiter=500,
                  per_problem=True)
    assert rp.niter.dim() == 0 and bool(rp.converged)


def test_record_objective_matches_jax():
    y, a, _ = planted_lasso(seed=13)
    mask = random_mask(14, y.shape)
    for m in (None, mask):
        kw = dict(tol=0.0, maxiter=25, method="fista", record_objective=True)
        rj = decomp_tpu.lasso.solve(y, a, ALPHA, mask=m, **kw)
        rt = tl.solve(_t(y), _t(a), ALPHA, mask=None if m is None else _t(m),
                      **kw)
        np.testing.assert_allclose(rt.objective.numpy(),
                                   np.asarray(rj.objective), rtol=1e-9)


def test_lipschitz_and_check_every_match_jax():
    y, a, _ = planted_lasso(seed=11)
    kw = dict(tol=1e-6, maxiter=3000, method="fista", lipschitz=3.0,
              check_every=7)
    _assert_same_run(tl.solve(_t(y), _t(a), ALPHA, **kw),
                     decomp_tpu.lasso.solve(y, a, ALPHA, **kw), 1e-10)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista"])
def test_state_resume_is_bit_exact(method, use_kernel):
    """return_state then state= reproduces the uninterrupted per-problem run
    bit for bit: converged rows stay frozen and niter accumulates."""
    rng = np.random.default_rng(52)
    a = (rng.normal(size=(64, 40)) / np.sqrt(40)).astype(np.float32)
    xt = rng.normal(size=(48, 64)) * (rng.random((48, 64)) < 0.1)
    y = (xt @ a + 0.01 * rng.normal(size=(48, 40))).astype(np.float32)
    kw = dict(method=method, tol=2e-4, per_problem=True,
              use_kernel=use_kernel, return_state=True)
    straight = tl.solve(_t(y), _t(a), 0.05, maxiter=200, **kw)
    nit = straight.niter
    first = int(nit.min() + nit.max()) // 2
    r1 = tl.solve(_t(y), _t(a), 0.05, maxiter=first, **kw)
    assert 0 < int(r1.converged.sum()) < y.shape[0]
    st = {"done": r1.converged, "niter": r1.niter}
    if r1.aux is not None:
        st.update(z=r1.aux["z"], t=r1.aux["t"])
    r2 = tl.solve(_t(y), _t(a), 0.05, x=r1.x, maxiter=200 - first, state=st,
                  **kw)
    for name in ("x", "niter", "converged"):
        assert torch.equal(getattr(r2, name), getattr(straight, name)), name


def test_global_momentum_resume_is_bit_exact():
    y, a, _ = planted_lasso(seed=10)
    kw = dict(tol=0.0, method="acc_ista")
    straight = tl.solve(_t(y), _t(a), ALPHA, maxiter=80, **kw)
    r1 = tl.solve(_t(y), _t(a), ALPHA, maxiter=40, return_state=True, **kw)
    r2 = tl.solve(_t(y), _t(a), ALPHA, x=r1.x, maxiter=40,
                  momentum_state=(r1.aux["z"], r1.aux["t"]), **kw)
    assert torch.equal(r2.x, straight.x)


def test_jax_state_carries_into_the_port():
    """A JAX per-problem FISTA solve stopped at maxiter=40, handed over
    through ``convert.lasso_resume``, continues in the port to JAX's
    uninterrupted 80-iteration result (f64: 1e-10, equal niter)."""
    rng = np.random.default_rng(31)
    a = rng.normal(size=(24, 96))
    y = rng.normal(size=(8, 96)) * (10.0 ** rng.uniform(-2, 1, size=(8, 1)))
    kw = dict(tol=1e-4, method="fista", per_problem=True)
    full = decomp_tpu.lasso.solve(y, a, ALPHA, maxiter=80, **kw)
    half = decomp_tpu.lasso.solve(y, a, ALPHA, maxiter=40, return_state=True,
                                  **kw)
    conv = np.asarray(half.converged)
    assert 0 < conv.sum() < len(conv)      # some rows are frozen at 40
    x, state = convert.lasso_resume(half, "cpu")
    assert set(state) == {"z", "t", "done", "niter"}
    rest = tl.solve(_t(y), _t(a), ALPHA, x, maxiter=40, state=state, **kw)
    _assert_same_run(rest, full, 1e-10)


# The kernel path on the CPU (use_kernel=True runs the twins) against
# decomp_tpu's Pallas path in interpret mode, f32. Masked kernel: fixed
# budget, 1e-5 relative after 30 iterations. The whole-solve kernel's
# test is in tests/test_torch_lasso_whole.py.
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd"])
def test_masked_kernel_path_matches_pallas(method, precision):
    y, a, _ = planted_lasso(seed=40, n_samples=24, n_features=20,
                            n_channels=36)
    mask = random_mask(41, y.shape).astype(np.float32)
    y, a = (y * mask).astype(np.float32), a.astype(np.float32)
    kw = dict(method=method, tol=0.0, maxiter=30, mask=mask,
              precision=precision)
    rj = decomp_tpu.lasso.solve(y, a, ALPHA, use_pallas=True,
                                _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), ALPHA, use_kernel=True,
                  **{**kw, "mask": _t(mask)})
    ref = tl.solve(_t(y), _t(a), ALPHA, use_kernel=False,
                   **{**kw, "mask": _t(mask)})
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5
    assert rel_err(ref.x.numpy(), rj.x) < 1e-5


def _complex_batch(seed, m=64, f=48, n=40):
    """A planted complex64 batch with an unnormalised dictionary, as the
    JAX package's config-2-complex makes one (``bench_split_complex.py``)
    at a small size."""
    rng = np.random.default_rng(seed)

    def cnormal(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    a = (cnormal(f, n) / np.sqrt(2 * n)).astype(np.complex64)
    xt = cnormal(m, f) * (rng.random((m, f)) < 0.1)
    y = (xt @ a + 0.01 * cnormal(m, n)).astype(np.complex64)
    return y, a


def _split_np(v):
    return np.asarray(v.re) + 1j * np.asarray(v.im)


# The complex kernel path's test against the JAX package's split kernel
# path is in tests/test_torch_lasso_complex_kernel.py.


@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista"])
def test_complex_kernel_state_resume_is_bit_exact(method):
    """Complex64 through the kernel path: return_state then state=
    reproduces the uninterrupted per-problem run bit for bit."""
    y, a = _complex_batch(53, m=40, f=24, n=30)
    kw = dict(method=method, tol=2e-4, per_problem=True, use_kernel=True,
              return_state=True)
    straight = tl.solve(_t(y), _t(a), 0.05, maxiter=200, **kw)
    nit = straight.niter
    first = int(nit.min() + nit.max()) // 2
    r1 = tl.solve(_t(y), _t(a), 0.05, maxiter=first, **kw)
    assert 0 < int(r1.converged.sum()) < y.shape[0]
    st = {"done": r1.converged, "niter": r1.niter}
    if r1.aux is not None:
        assert r1.aux["z"].dtype == torch.complex64
        st.update(z=r1.aux["z"], t=r1.aux["t"])
    r2 = tl.solve(_t(y), _t(a), 0.05, x=r1.x, maxiter=200 - first, state=st,
                  **kw)
    for name in ("x", "niter", "converged"):
        assert torch.equal(getattr(r2, name), getattr(straight, name)), name


# solve_split over (re, im) pairs against the JAX package's: the f64
# composition to 1e-10 with equal niter, as solve's complex parity above;
# the f32 kernel path (acc_ista, 'high', resumed from a momentum state)
# within the limits of the kernel-path test above (measured: niter equal on
# every row, x within 1.6e-6).
def test_solve_split_matches_jax():
    from decomp_tpu.ops import complex_split as cs

    y, a, _ = planted_lasso(seed=23, complex_=True)
    kw = dict(tol=1e-7, maxiter=3000, method="fista", per_problem=True)
    rj = decomp_tpu.lasso.solve_split(cs.from_numpy(y), cs.from_numpy(a),
                                      ALPHA, use_pallas=False, **kw)
    rt = tl.solve_split((_t(y.real), _t(y.imag)), (_t(a.real), _t(a.imag)),
                        ALPHA, use_kernel=False, **kw)
    assert isinstance(rt.x, tl.SplitComplex)
    assert rt.x.re.dtype == torch.float64 and rt.x.re.shape == (6, 24)
    _assert_same_run(rt._replace(x=_split_np(rt.x)),
                     rj._replace(x=_split_np(rj.x)), 1e-10)
    # Host pairs, and JAX's SplitComplex itself (an object with .re/.im).
    rh = tl.solve_split((y.real, y.imag), cs.from_numpy(a), ALPHA,
                        use_kernel=False, device="cpu", **kw)
    assert torch.equal(rh.x.re, rt.x.re) and torch.equal(rh.x.im, rt.x.im)

    y, a = _complex_batch(54, m=32, f=20, n=24)
    kw = dict(tol=1e-5, method="acc_ista", per_problem=True,
              precision="high", return_state=True)
    ys, a_s = cs.from_numpy(y), cs.from_numpy(a)
    jk = dict(use_pallas=True, _pallas_interpret=True)
    j1 = decomp_tpu.lasso.solve_split(ys, a_s, 0.1, maxiter=30, **jk, **kw)
    j2 = decomp_tpu.lasso.solve_split(
        ys, a_s, 0.1, x=j1.x, maxiter=200, **jk, **kw,
        state={"z": j1.aux["z"], "t": j1.aux["t"], "done": j1.converged,
               "niter": j1.niter})
    pair = (lambda v: (_t(np.asarray(v.re)), _t(np.asarray(v.im))))
    t1 = tl.solve_split(pair(ys), pair(a_s), 0.1, maxiter=30,
                        use_kernel=True, **kw)
    t2 = tl.solve_split(
        pair(ys), pair(a_s), 0.1, x=t1.x, maxiter=200, use_kernel=True,
        **kw, state={"z": t1.aux["z"], "t": t1.aux["t"],
                     "done": t1.converged, "niter": t1.niter})
    assert isinstance(t2.aux["z"], tl.SplitComplex)
    same = t2.niter.numpy() == np.asarray(j2.niter)
    assert same.mean() >= 0.9
    assert rel_err(_split_np(t2.x)[same], _split_np(j2.x)[same]) < 1e-4
    assert rel_err(_split_np(t2.x), _split_np(j2.x)) < 1e-3


# solve_split's checks and its use_kernel contract against the JAX
# package's (lasso.py:1013-1126): the same error type for each case.
@pytest.mark.parametrize("kw", [
    dict(method="cd"),
    dict(y="not_a_pair"),
    dict(y="1d"),
    dict(a="bad_im"),
    dict(use_kernel=True, per_problem=True, mask="ones"),
    dict(use_kernel=True, per_problem=False),
    dict(use_kernel=True, per_problem=True, record_objective=True),
    dict(use_kernel=True, per_problem=True, precision="default"),
    dict(use_kernel=True, per_problem=True, f64=True),
    dict(use_kernel=True, per_problem=True, alpha="rows"),
    dict(state={"z": "x"}),
    dict(method="ista", momentum_state="mst", x="x"),
])
def test_solve_split_errors_match_jax(kw):
    from decomp_tpu.ops import complex_split as cs

    y, a, _ = planted_lasso(seed=24, complex_=True)
    kw = dict(kw)
    if not kw.pop("f64", False):
        y, a = y.astype(np.complex64), a.astype(np.complex64)
    m, f = y.shape[0], a.shape[0]
    values = {"not_a_pair": y.real, "1d": cs.from_numpy(y[0]),
              "bad_im": (a.real, a.imag[:, :3]), "ones": np.ones(y.shape),
              "rows": np.full((m, f), 0.1),
              "x": cs.from_numpy(np.zeros((m, f), y.dtype)),
              "mst": (cs.from_numpy(np.zeros((m, f), y.dtype)), np.ones(m))}

    def fill(v):
        if isinstance(v, dict):
            return {k: fill(u) for k, u in v.items()}
        return values.get(v, v) if isinstance(v, str) else v

    args = {k: fill(v) for k, v in kw.items()}
    y_ = args.pop("y", cs.from_numpy(y))
    a_ = args.pop("a", cs.from_numpy(a))
    alpha = args.pop("alpha", ALPHA)
    jkw = {("use_pallas" if k == "use_kernel" else k): v
           for k, v in args.items()}
    with pytest.raises(Exception) as ej:
        decomp_tpu.lasso.solve_split(y_, a_, alpha, **jkw)
    with pytest.raises(Exception) as et:
        tl.solve_split(y_, a_, alpha, device="cpu", **args)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert isinstance(et.value, ValueError)


@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("chunk_rows", [3, 4])
def test_solve_streaming_matches_jax(per_problem, chunk_rows):
    y, a, _ = planted_lasso(seed=60, n_samples=10)
    mask = random_mask(61, y.shape)
    alpha = np.random.default_rng(62).uniform(0.02, 0.08, (10, a.shape[0]))
    for m, al in ((None, ALPHA), (mask, alpha)):
        kw = dict(tol=1e-6, maxiter=2000, method="fista", mask=m,
                  chunk_rows=chunk_rows, per_problem=per_problem)
        rj = decomp_tpu.lasso.solve_streaming(y, a, al, **kw)
        rt = tl.solve_streaming(y, a, al, device="cpu", **kw)
        assert isinstance(rt.x, np.ndarray) and rt.x.dtype == np.float64
        _assert_same_run(rt, rj, 1e-10)


# Complex data through the stream, native complex128 in both packages (the
# JAX package's complex_split='auto' keeps CPU data complex): x to 1e-10
# with equal per-row niter, as the real case above.
@pytest.mark.parametrize("per_problem", [False, True])
def test_solve_streaming_complex_matches_jax(per_problem):
    y, a, _ = planted_lasso(seed=60, n_samples=10, complex_=True)
    mask = random_mask(61, y.shape)
    for m in (None, mask):
        kw = dict(tol=1e-6, maxiter=2000, method="fista", mask=m,
                  chunk_rows=3, per_problem=per_problem)
        rj = decomp_tpu.lasso.solve_streaming(y, a, ALPHA, **kw)
        rt = tl.solve_streaming(y, a, ALPHA, device="cpu", **kw)
        assert isinstance(rt.x, np.ndarray) and rt.x.dtype == np.complex128
        _assert_same_run(rt, rj, 1e-10)


def _bad_problem():
    y, a, _ = planted_lasso(seed=15)
    return y, a


# decomp_tpu's validation cases (tests/test_lasso.py:279, :443, :519),
# with use_pallas=True on the JAX side where the port says use_kernel=True.
@pytest.mark.parametrize("kw", [
    dict(method="nope"),
    dict(a="aT"),
    dict(method="cd", mask="ones"),
    dict(method="cd", per_problem=True),
    dict(method="cd", alpha="vec"),
    dict(maxiter=0),
    dict(alpha=-1.0),
    dict(mask="bad_shape"),
    dict(x="bad_x"),
    dict(method="fista", use_kernel=True),
    dict(method="cd", per_problem=True, use_kernel=True),
    dict(method="fista", per_problem=True, use_kernel=True),      # f64
    dict(method="fista", per_problem=True, record_objective=True,
         use_kernel=True, f32=True),
    dict(method="fista", per_problem=True, precision="default",
         use_kernel=True, f32=True),
    dict(method="fista", per_problem=True, alpha="rows", use_kernel=True,
         f32=True),
    dict(method="fista", state={"bogus": 1}),
    dict(method="fista", state={"done": "zeros", "niter": "zeros"}),
    dict(method="fista", state={"z": "x"}),
    dict(method="fista", state={"z": "x", "t": 1.0}, momentum_state="mst"),
    dict(method="ista", momentum_state="mst", x="x"),
    dict(method="fista", momentum_state="mst"),
])
def test_errors_match_jax_types(kw):
    y, a = _bad_problem()
    kw = dict(kw)
    if kw.pop("f32", False):
        y, a = y.astype(np.float32), a.astype(np.float32)
    m, f = y.shape[0], a.shape[0]
    values = {"aT": a.T, "ones": np.ones_like(y), "vec": np.full(f, 0.1),
              "bad_shape": np.ones((m, 3)), "bad_x": np.ones((m + 1, f)),
              "rows": np.full((m, f), 0.1), "zeros": np.zeros(m),
              "x": np.zeros((m, f)), "mst": (np.zeros((m, f)), np.ones(m))}

    def fill(v):
        if isinstance(v, dict):
            return {k: fill(u) for k, u in v.items()}
        return values.get(v, v) if isinstance(v, str) else v

    args = {k: fill(v) for k, v in kw.items()}
    a_ = args.pop("a", a)
    alpha = args.pop("alpha", ALPHA)
    jkw = {("use_pallas" if k == "use_kernel" else k): v
           for k, v in args.items()}
    with pytest.raises(Exception) as ej:
        decomp_tpu.lasso.solve(y, a_, alpha, **jkw)
    with pytest.raises(Exception) as et:
        tl.solve(y, a_, alpha, device="cpu", **args)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert isinstance(et.value, ValueError)


def test_port_refusals():
    """What the port refuses beyond the JAX package's contract: the
    complex kernel path's limits (complex64 only, Fc <= 640, the TPU
    kernel's gate, unmasked, no objective curve), and kernel options where
    no kernel runs."""
    y, a, _ = planted_lasso(seed=19, complex_=True)
    kw = dict(use_kernel=True, per_problem=True)
    with pytest.raises(texc.DecompError, match="complex64"):
        tl.solve(_t(y), _t(a), ALPHA, **kw)                # complex128
    y64, a64 = _t(y.astype(np.complex64)), _t(a.astype(np.complex64))
    wide = torch.zeros((641, a.shape[1]), dtype=torch.complex64)
    with pytest.raises(texc.DecompError, match="at most 640 complex"):
        tl.solve(y64, wide, ALPHA, **kw)
    with pytest.raises(texc.DecompError, match="objectives"):
        tl.solve(y64, a64, ALPHA, record_objective=True, **kw)
    with pytest.raises(texc.DecompError, match="unmasked"):
        tl.solve(y64, a64, ALPHA, mask=torch.ones(y64.shape), **kw)
    assert tl.solve(y64, a64, ALPHA, tol=0.0, maxiter=3,
                    **kw).x.dtype == torch.complex64
    yr = _t(y.real.astype(np.float32))
    ar = _t(a.real.astype(np.float32))
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        tl.solve(yr, ar, ALPHA, kernel_block_rows=16)   # no kernel runs
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        tl.solve(yr, ar, ALPHA, per_problem=True, use_kernel=True,
                 kernel_block_rows=8)
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        tl.solve(yr, torch.ones(ar.shape, device="meta"), ALPHA)
    with pytest.raises(texc.DecompError, match="precision"):
        tl.solve(yr, ar, ALPHA, precision="bogus")


def test_auto_takes_complex_where_the_card_measured_it_faster():
    """use_kernel='auto' on a CUDA tensor (a stand-in: the gate reads only
    ``is_cuda``): complex64 runs the whole-solve kernel under 'high' up to
    512 features and under 'highest' up to 256 (PERF.md §6), and under
    both from 513 to the TPU kernel's gate, 640, on the wide route; real
    f32 up to the gate (1,408 features with momentum); never complex128."""
    card = SimpleNamespace(is_cuda=True)
    alpha = torch.tensor(0.1)

    def mode(dtype, f, precision="high", per_problem=True):
        return tl._kernel_mode("auto", card, None, "acc_ista", dtype, f,
                               per_problem, False, precision, alpha)

    c64 = torch.complex64
    assert mode(c64, 512) == "whole" and mode(c64, 64) == "whole"
    assert mode(c64, 256, "highest") == "whole"
    assert mode(c64, 257, "highest") is None
    assert mode(c64, 513) == "whole" and mode(c64, 640, "highest") == "whole"
    assert mode(c64, 641) is None
    assert mode(c64, 512, per_problem=False) is None
    assert mode(torch.complex128, 64) is None
    assert mode(torch.float32, 1024, "highest") == "whole"
    assert mode(torch.float32, 1025) == "whole"
    assert mode(torch.float32, 1408) == "whole"
    assert mode(torch.float32, 1409) is None
    cpu = SimpleNamespace(is_cuda=False)
    assert tl._kernel_mode("auto", cpu, None, "acc_ista", c64, 64, True,
                           False, "high", alpha) is None


def test_kernel_block_rows_changes_nothing():
    rng = np.random.default_rng(8)
    a = _t((rng.normal(size=(32, 24)) / 5).astype(np.float32))
    y = _t(rng.normal(size=(20, 24)).astype(np.float32))
    kw = dict(tol=1e-5, maxiter=100, per_problem=True, use_kernel=True)
    r16 = tl.solve(y, a, ALPHA, kernel_block_rows=16, **kw)
    r32 = tl.solve(y, a, ALPHA, kernel_block_rows=32, **kw)
    assert torch.equal(r16.x, r32.x) and torch.equal(r16.niter, r32.niter)


# An entry point runs on the card unless the caller asks for the CPU. The
# tests make "no card" certain by hiding any that the machine has.
@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _lasso_call(y, a, **kw):
    return tl.solve(y, a, ALPHA, tol=0.0, maxiter=3, **kw)


def _nmf_call(y, a, **kw):
    return decomp_tpu_torch.nmf.solve(abs(y), rank=2, tol=0.0, maxiter=3,
                                      **kw)


def _completion_call(y, a, **kw):
    mask = np.ones(y.shape) if isinstance(y, np.ndarray) else torch.ones(
        y.shape, dtype=y.dtype)
    return tnmf.masked_completion(abs(y), mask, rank=2, maxiter=3, **kw)


def _streaming_call(y, a, **kw):
    return tl.solve_streaming(np.asarray(y), np.asarray(a), ALPHA, tol=0.0,
                              maxiter=3, chunk_rows=4, **kw)


@pytest.mark.parametrize("call", [_lasso_call, _nmf_call, _completion_call,
                                  _streaming_call])
def test_host_input_needs_a_card_or_device_cpu(no_card, call):
    y, a, _ = planted_lasso(seed=70)
    with pytest.raises(texc.DecompError, match="no CUDA device"):
        call(y, a)
    res = call(y, a, device="cpu")
    assert np.all(np.isfinite(_np(res.x)))
    if call is not _streaming_call:
        assert res.x.device.type == "cpu"
        cpu = call(_t(y), _t(a))              # a CPU tensor is a request too
        assert cpu.x.device.type == "cpu"


def test_host_companions_follow_a_tensor_y(no_card):
    y, a, _ = planted_lasso(seed=71)
    mask = random_mask(72, y.shape)
    res = tl.solve(_t(y), a, np.full(a.shape[0], ALPHA), mask=mask,
                   x=np.zeros((y.shape[0], a.shape[0])), tol=0.0, maxiter=3)
    assert res.x.device.type == "cpu"
    with pytest.raises(texc.DecompError, match="move it explicitly"):
        tl.solve(_t(y), _t(a), ALPHA, device="meta")
