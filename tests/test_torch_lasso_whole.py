"""The whole-solve lasso kernel's path in the PyTorch port against
``decomp_tpu``: ``lasso.solve(use_kernel=True, per_problem=True)`` on the
CPU (the twin of ``cuda_lasso.solve_rows``) against the Pallas path in
interpret mode, every gradient method at precision 'highest' and 'high'.
In a file of its own (from ``tests/test_torch_lasso.py``) so that a
``--dist loadfile`` run gives it a worker of its own."""

import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu_torch.ops import cuda_lasso
from problems import rel_err

tl = decomp_tpu_torch.lasso


def _t(a):
    return torch.from_numpy(np.array(a))


# The kernel path on the CPU (use_kernel=True runs the twins) against
# decomp_tpu's Pallas path in interpret mode, f32. Whole-solve kernel: the
# rows whose niter agree (>= 90%) within 1e-4 and x within 1e-3, the limits
# of tests/test_torch_lasso_kernels.py (measured: niter equal on >= 90.6%
# of rows, those rows within 4.0e-6, all rows within 5.7e-6).
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd"])
def test_whole_kernel_path_matches_pallas(method, precision):
    rng = np.random.default_rng(50)
    m, f, n = 96, 128, 80
    a = (rng.normal(size=(f, n)) / np.sqrt(n)).astype(np.float32)
    xt = rng.normal(size=(m, f)) * (rng.random((m, f)) < 0.1)
    y = (xt @ a + 0.01 * rng.normal(size=(m, n))).astype(np.float32)
    alpha = (np.linspace(0.02, 0.08, f).astype(np.float32)
             if method == "fista" else 0.05)
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
    # ista and parallel_cd leave a few rows unconverged at 300 iterations
    np.testing.assert_array_equal(rt.converged.numpy()[same],
                                  np.asarray(rj.converged)[same])
    assert rt.converged.float().mean() >= 0.9
    # fixed budget (tol <= 0): every row runs maxiter
    kw.update(tol=0.0, maxiter=37)
    rj = decomp_tpu.lasso.solve(y, a, alpha, use_pallas=True,
                                _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), _t(alpha), use_kernel=True, **kw)
    assert (rt.niter == 37).all() and not rt.converged.any()
    assert rel_err(rt.x.numpy(), rj.x) < 1e-5
