"""Complex64 lasso through the PyTorch port's kernel path against
``decomp_tpu``: ``lasso.solve(use_kernel=True)`` on the CPU (the complex
twin of ``cuda_lasso.solve_rows``) against the JAX package's split kernel
path, ``solve_split(use_pallas=True)`` in interpret mode, and against the
port's own complex composition. In a file of its own (from
``tests/test_torch_lasso.py``, whose helpers it shares) so that a ``--dist
loadfile`` run gives it a worker of its own."""

import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch
from decomp_tpu_torch.ops import cuda_lasso
from problems import rel_err
from test_torch_lasso import _complex_batch, _split_np

tl = decomp_tpu_torch.lasso


def _t(a):
    return torch.from_numpy(np.array(a))


# Complex64 through the kernel path on the CPU (use_kernel=True runs the
# complex twin) against the JAX package's split kernel path, solve_split(
# use_pallas=True) in interpret mode, and against the port's own complex
# composition: the criteria of the real case above, at tol 1e-4 (at 1e-5
# the 'high' runs' bf16x3 sums, 1.5e-5 apart in x, are as large as tol).
# Measured: niter equal on >= 96.9% of rows against Pallas (>= 93.7%
# against the composition), those rows within 4.0e-6 (1.6e-5), all rows
# within 2.0e-5 (2.6e-5); the fixed budget within 3.7e-6.
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("method", ["ista", "fista", "acc_ista",
                                    "parallel_cd"])
def test_complex_kernel_path_matches_pallas(method, precision):
    from decomp_tpu.ops import complex_split as cs

    y, a = _complex_batch(51)
    f = a.shape[0]
    alpha = (np.linspace(0.02, 0.08, f).astype(np.float32)
             if method == "fista" else 0.05)
    kw = dict(method=method, tol=1e-4, maxiter=300, per_problem=True,
              precision=precision)
    rj = decomp_tpu.lasso.solve_split(cs.from_numpy(y), cs.from_numpy(a),
                                      alpha, use_pallas=True,
                                      _pallas_interpret=True, **kw)
    before = (cuda_lasso.solve_rows.launches,
              cuda_lasso.solve_rows.complex_launches)
    rt = tl.solve(_t(y), _t(a), _t(alpha), use_kernel=True, **kw)
    rc = tl.solve(_t(y), _t(a), _t(alpha), use_kernel=False, **kw)
    assert before == (cuda_lasso.solve_rows.launches,
                      cuda_lasso.solve_rows.complex_launches)  # the twin
    assert rt.x.dtype == torch.complex64 and rt.x.shape == (64, f)
    xj = _split_np(rj.x)
    for ref_x, ref_nit in ((xj, np.asarray(rj.niter)),
                           (rc.x.numpy(), rc.niter.numpy())):
        same = rt.niter.numpy() == ref_nit
        assert same.mean() >= 0.9
        assert rel_err(rt.x.numpy()[same], ref_x[same]) < 1e-4
        assert rel_err(rt.x.numpy(), ref_x) < 1e-3
    assert rt.converged.float().mean() >= 0.9
    # fixed budget (tol <= 0): every row runs maxiter
    kw.update(tol=0.0, maxiter=37)
    rj = decomp_tpu.lasso.solve_split(cs.from_numpy(y), cs.from_numpy(a),
                                      alpha, use_pallas=True,
                                      _pallas_interpret=True, **kw)
    rt = tl.solve(_t(y), _t(a), _t(alpha), use_kernel=True, **kw)
    assert (rt.niter == 37).all() and not rt.converged.any()
    assert rel_err(rt.x.numpy(), _split_np(rj.x)) < 1e-5
