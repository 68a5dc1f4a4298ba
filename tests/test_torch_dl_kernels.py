"""The dictionary-learning kernels' plain twins (``ops.cuda_dl``) against
``decomp_tpu``: ``bcd_sweep_plain`` against the Pallas BCD sweep in
interpret mode and against the JAX composition sweep,
``masked_grad_dict_plain`` against the Pallas masked dictionary gradient in
interpret mode and against the composition, and the wrappers' contract checks, which run before any
launch and so need no card. The same numpy inputs, made from a seed, go
through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decomp_tpu.models.dictionary_learning import _bcd_dict_update
from decomp_tpu.ops import pallas_bcd, pallas_lasso
from decomp_tpu_torch.ops import cuda_dl
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err


def _t(a):
    return torch.from_numpy(np.array(a))


def _bcd_inputs(seed, k, n, dtype=np.float32, complex_=False, zero=None):
    """A = x^H x, B = x^H y from random x and y, and unit-norm atoms d; atom
    ``zero`` gets all-zero statistics (a dead atom)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        z = rng.normal(size=shape)
        return z + 1j * rng.normal(size=shape) if complex_ else z

    x, y, d = randn(300, k), randn(300, n), randn(k, n)
    if zero is not None:
        x[:, zero] = 0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(v.astype(dtype) for v in (x.conj().T @ x, x.conj().T @ y, d))


def _jax_composition(a, b, d):
    with jax.default_matmul_precision("highest"):
        return np.asarray(_bcd_dict_update(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(d)))


# f32 against the Pallas kernel (interpret): 1e-6 relative, the limit
# tests/test_pallas.py:359 holds the padded kernel to (measured 3.3e-7).
def test_bcd_twin_matches_pallas():
    a, b, d = _bcd_inputs(80, 64, 128)
    ref = pallas_bcd.bcd_sweep(jnp.asarray(a), jnp.asarray(b), jnp.asarray(d),
                               interpret=True)
    before = cuda_dl.bcd_sweep.launches
    got = cuda_dl.bcd_sweep(_t(a), _t(b), _t(d))
    assert cuda_dl.bcd_sweep.launches == before    # CPU: the twin ran
    assert got.dtype == torch.float32 and got.shape == (64, 128)
    assert rel_err(got.numpy(), np.asarray(ref)) < 1e-6


# The twin is the composition sweep: in f64 and complex128 it gives the JAX
# composition to 1e-12; ragged f32 shapes (no alignment anywhere) to 1e-6.
@pytest.mark.parametrize("k,n,dtype,complex_,limit", [
    (64, 128, np.float64, False, 1e-12),
    (24, 40, np.complex128, True, 1e-12),
    (37, 50, np.float64, False, 1e-12),
    (37, 50, np.float32, False, 1e-6),
    (5, 3, np.float32, False, 1e-6),
])
def test_bcd_twin_is_the_jax_composition(k, n, dtype, complex_, limit):
    a, b, d = _bcd_inputs(k + n, k, n, dtype, complex_)
    got = cuda_dl.bcd_sweep_plain(_t(a), _t(b), _t(d))
    assert got.dtype == _t(d).dtype
    assert rel_err(got.numpy(), _jax_composition(a, b, d)) < limit
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               rtol=10 * limit)


def test_bcd_twin_keeps_a_dead_atom():
    a, b, d = _bcd_inputs(3, 37, 50, zero=4)
    got = cuda_dl.bcd_sweep(_t(a), _t(b), _t(d))
    np.testing.assert_array_equal(got.numpy()[4], d[4])
    np.testing.assert_array_equal(_jax_composition(a, b, d)[4], d[4])
    assert rel_err(got.numpy(), _jax_composition(a, b, d)) < 1e-6


def _grad_inputs(seed, m, n, k):
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) > 0.3).astype(np.float32)
    my = (rng.normal(size=(m, n)) * mask).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    d = rng.normal(size=(k, n)).astype(np.float32)
    return my, mask, x, d


# f32: 1e-5 relative, as tests/test_pallas.py:178 holds the TPU kernel to
# the composition (measured 1.9e-7). bf16: both round the residual to bf16
# before the second product, where a one-ulp f32 difference of x d can flip
# a rounding; the limit is 1e-4 (measured 7.5e-8).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_grad_dict_twin_matches_pallas(dtype):
    my, mask, x, d = _grad_inputs(11, 160, 256, 128)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = pallas_lasso.masked_grad_dict(
        *(jnp.asarray(v, jdt) for v in (my, mask, x, d)), block_rows=32,
        interpret=True)
    before = cuda_dl.masked_grad_dict.launches
    got = cuda_dl.masked_grad_dict(*(_t(v).to(tdt) for v in (my, mask, x, d)))
    assert cuda_dl.masked_grad_dict.launches == before   # the twin ran
    assert got.dtype == torch.float32 and got.shape == (128, 256)
    limit = 1e-5 if dtype == "float32" else 1e-4
    assert rel_err(got.numpy(), np.asarray(ref)) < limit


# Ragged shapes against the composition x^T (mask * (x d) - my): f32 sums
# and residual, 1e-5; the chunking of the twin changes nothing beyond the
# f32 summation order.
@pytest.mark.parametrize("m,n,k,rows", [(45, 70, 9, None), (333, 257, 7, 64),
                                        (130, 33, 128, 50)])
def test_masked_grad_dict_twin_matches_the_composition(m, n, k, rows):
    my, mask, x, d = _grad_inputs(m + n + k, m, n, k)
    md = [v.astype(np.float64) for v in (my, mask, x, d)]
    ref = md[2].T @ (md[1] * (md[2] @ md[3]) - md[0])
    got = cuda_dl.masked_grad_dict_plain(*(_t(v) for v in (my, mask, x, d)),
                                         block_rows=rows)
    assert rel_err(got.numpy(), ref) < 1e-5
    got64 = cuda_dl.masked_grad_dict_plain(*(_t(v) for v in md))
    assert got64.dtype == torch.float32     # the TPU kernel's f32 output
    assert rel_err(got64.numpy(), ref) < 1e-6


def test_bcd_kernel_limit():
    assert cuda_dl.bcd_fits(256, 64)                      # BASELINE config 3
    assert cuda_dl.bcd_fits(256, 208)                     # phase 14b
    assert cuda_dl.bcd_fits(256, 3712)                    # the TPU gate's
    assert not cuda_dl.bcd_fits(256, 3713)                # largest N at 256
    assert not cuda_dl.bcd_fits(2048, 26)                 # A does not fit
    # The cluster route's shared memory: a ring of 4 rows of A, 6
    # mbarriers, 2 x 128 warp partials and shared d (K rows of l4 float4s).
    plan = cuda_dl.bcd_cluster_plan(256, 208)
    assert plan.smem_bytes == 4 * 4 * 256 + 48 + 1024 + 16 * 256 * plan.l4


@pytest.mark.parametrize("k,n,exc,match", [
    (256, 3713, texc.ShapeError, "at most 15 MiB"),
    (4000, 13, texc.ShapeError, "at most 15 MiB"),
    (8, 8, texc.DtypeError, "f32"),
    (8, 8, texc.ShapeError, "do not fit"),
])
def test_bcd_kernel_checks_need_no_card(k, n, exc, match):
    z = torch.zeros
    a, b, d = z((k, k)), z((k, n)), z((k, n))
    if exc is texc.DtypeError:
        d = d.double()
    elif match == "do not fit":
        a = z((k + 1, k + 1))
    with pytest.raises(exc, match=match):
        cuda_dl.check_bcd_args(a, b, d)
    cuda_dl.check_bcd_args(z((8, 8)), z((8, 5)), z((8, 5)))


def test_masked_grad_dict_checks_and_chunks():
    z = torch.zeros
    with pytest.raises(texc.ShapeError, match="1 <= F <= 128"):
        cuda_dl.check_masked_grad_args(z((4, 8)), z((4, 8)), z((4, 129)),
                                       z((129, 8)))
    with pytest.raises(texc.DecompError, match="no kernel for device"):
        cuda_dl.masked_grad_dict(*(t.to("meta") for t in (
            z((4, 8)), z((4, 8)), z((4, 2)), z((2, 8)))))
    with pytest.raises(texc.DecompError, match="no kernel for device"):
        cuda_dl.bcd_sweep(*(t.to("meta") for t in (z((4, 4)), z((4, 6)),
                                                   z((4, 6)))))
    # the chunks fill about 4 waves of 132 SMs over the 64-column tiles
    rows = cuda_dl.grad_dict_chunk_rows(100_000, 1024)
    assert rows % 32 == 0 and -(-100_000 // rows) * 16 in range(500, 560)
    assert cuda_dl.grad_dict_chunk_rows(10, 5000) == 32
