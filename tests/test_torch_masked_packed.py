"""The bit-packed mask of masked MU in the PyTorch port: ``pack_mask``,
``mu_stats_masked``'s packed route (its twin on CPU) against the dense
route and against ``decomp_tpu``'s masked Pallas kernel in interpret mode,
and the route ``nmf.solve`` takes. The same numpy inputs, made from a
seed, go through both packages."""

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
from test_torch_masked import _heldout_problem, _masked_arrs, _problem
from test_torch_nmf import _bf16_np, _t

_MASK_DTYPES = [torch.bool, torch.bfloat16, torch.float32, torch.float64]
_WIDTHS = [1, 31, 32, 33, 257, 1000]


def _mask(m, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((m, n)) >= 0.3).to(dtype)


@pytest.mark.parametrize("n", _WIDTHS)
@pytest.mark.parametrize("dtype", _MASK_DTYPES)
def test_pack_mask_round_trips(dtype, n):
    """Exact round trip; W = ceil(N / 32) rounded up to 4 words, so every
    row starts 16-byte aligned; pad bits and pad words are 0."""
    mask = _mask(7, n, dtype)
    bits = cuda_mu.pack_mask(mask)
    w = -(-n // 32)
    assert bits.dtype == torch.int32 and bits.is_contiguous()
    assert bits.shape == (7, -(-w // 4) * 4)
    assert (bits.shape[1] * 4) % 16 == 0 and bits.data_ptr() % 16 == 0
    assert torch.equal(cuda_mu.unpack_mask(bits, n, dtype), mask)
    pad = cuda_mu.unpack_mask(bits, bits.shape[1] * 32, torch.int32)[:, n:]
    assert int(pad.sum()) == 0
    assert int(bits[:, w:].abs().sum()) == 0
    # bit j of word w in row r is mask[r, 32 w + j]
    r, c = 3, n - 1
    assert (int(bits[r, c // 32]) >> (c % 32)) & 1 == int(mask[r, c] != 0)


@pytest.mark.parametrize("value", [0.5, 2.0])
def test_weighted_mask_is_not_packed(value):
    mask = _mask(9, 40, torch.float32)
    mask[4, 7] = value
    assert cuda_mu.pack_mask(mask) is None


@pytest.mark.parametrize("dtype,xdt,block_rows", [
    (torch.float64, torch.float64, None),
    (torch.float32, torch.float32, 16),
    (torch.bfloat16, torch.float32, None),
    (torch.bfloat16, torch.bfloat16, 24),
])
def test_packed_twin_is_the_dense_twin(dtype, xdt, block_rows):
    """On CPU the packed route unpacks to my's dtype for the twin, so it
    gives the dense mask's bits."""
    my, mask, x, d = _masked_arrs(8, 70, 45, 6)
    my, mask, d = (_t(a).to(dtype) for a in (my, mask, d))
    x = _t(x).to(xdt)
    got = cuda_mu.mu_stats_masked(my, cuda_mu.pack_mask(mask), x, d, 1e-6,
                                  block_rows=block_rows)
    ref = cuda_mu.mu_stats_masked_plain(my, mask, x, d, 1e-6,
                                        block_rows=block_rows)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# f64: the Pallas kernel forms x_new and its statistics in f32 even for
# f64 data (pallas_mu.py:247-250), so the packed twin agrees with it to f32
# summation order (measured <= 2.7e-7), as test_torch_masked.py's dense
# twin does: 1e-6.
@pytest.mark.parametrize("m,jax_rows", [(64, 32), (72, 8)])
def test_packed_twin_matches_pallas_f64(m, jax_rows):
    my, mask, x, d = _masked_arrs(m, m, 256, 128)
    sj = pallas_mu.mu_stats_masked(
        jnp.asarray(my), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(d),
        1e-15, block_rows=jax_rows, interpret=True)
    st = cuda_mu.mu_stats_masked(_t(my), cuda_mu.pack_mask(_t(mask)), _t(x),
                                 _t(d), 1e-15)
    for a, b in zip(st, sj):
        assert rel_err(a.numpy(), b) < 1e-6


# Mixed mode, with test_torch_masked.py's limits: x_new 1e-5, the
# statistics 1e-4 (one bf16 rounding flip of cdt(x_new) moves a statistic
# by ~2e-5 at this shape).
@pytest.mark.parametrize("seed", [11, 12])
def test_packed_twin_matches_pallas_mixed(seed):
    my, mask, x, d = _masked_arrs(seed, 72, 256, 128)
    myb, x32 = _bf16_np(my), x.astype(np.float32)
    db = _bf16_np(d.astype(np.float32))
    sj = pallas_mu.mu_stats_masked(
        jnp.asarray(myb, jnp.bfloat16), jnp.asarray(mask, jnp.bfloat16),
        jnp.asarray(x32), jnp.asarray(db, jnp.bfloat16), 1e-6,
        block_rows=24, interpret=True)
    bits = cuda_mu.pack_mask(_t(mask, torch.bfloat16))
    st = cuda_mu.mu_stats_masked(_t(myb, torch.bfloat16), bits, _t(x32),
                                 _t(db, torch.bfloat16), 1e-6, block_rows=16)
    for a, b, limit in zip(st, sj, (1e-5, 1e-4, 1e-4)):
        assert a.dtype == torch.float32
        assert rel_err(a.numpy(), b) < limit


@pytest.mark.parametrize("shape", [(20, 2), (19, 4), (20, 3), (20,)])
def test_wrapper_refuses_a_packed_mask_of_another_shape(shape):
    my, mask, x, d = (_t(a) for a in _masked_arrs(6, 20, 40, 4))
    assert cuda_mu.pack_mask(mask).shape == (20, 4)
    bad = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(texc.ShapeError):
        cuda_mu.mu_stats_masked(my, bad, x, d, 1e-6)


def test_packed_rows_are_a_function_of_the_shape():
    """Two waves of resident blocks (2 per SM on 132 SMs) over 64-column N
    tiles, in whole 64-row stages; nothing but the shape goes in, so the
    summation order is fixed by the shape."""
    assert cuda_mu.packed_block_rows(100_000, 1000, 50) == 3072
    assert cuda_mu.packed_block_rows(262_144, 10112, 128) == 65536
    assert cuda_mu.packed_block_rows(10 ** 6, 64, 64) == 1920   # 521 chunks
    for m, n, k in ((333, 257, 7), (65536, 10112, 128), (1, 1, 1),
                    (10 ** 6, 64, 65)):
        rows = cuda_mu.packed_block_rows(m, n, k)
        assert rows % 64 == 0 and rows >= 64
        assert rows == cuda_mu.packed_block_rows(m, n, k)


class _RouteSpy:
    """Counts pack_mask results and unpack_mask calls (the packed route's
    twin unpacks once per iteration on CPU; the kernel route's counters
    count launches on the card only)."""

    def __init__(self, monkeypatch):
        self.packed, self.unpacked = [], 0
        pack, unpack = cuda_mu.pack_mask, cuda_mu.unpack_mask

        def pack_spy(mask):
            out = pack(mask)
            self.packed.append(out is not None)
            return out

        def unpack_spy(*a):
            self.unpacked += 1
            return unpack(*a)

        monkeypatch.setattr(cuda_mu, "pack_mask", pack_spy)
        monkeypatch.setattr(cuda_mu, "unpack_mask", unpack_spy)


def _jax_kernel_run(y, mask, x0, d0, **kw):
    return decomp_tpu.nmf.solve(y, d0, x=x0, mask=mask, use_pallas=True,
                                pallas_block_rows=16, _pallas_interpret=True,
                                **kw)


def test_solve_takes_the_packed_route_and_matches_pallas(monkeypatch):
    """A 0/1 mask is packed once per solve and every iteration takes the
    packed route; the result matches the Pallas kernel in interpret mode
    (f32, 15 fixed iterations: 1e-4, as test_torch_masked.py)."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = (a.astype(np.float32)
                       for a in _problem(seed=5, m=70, n=50, k=4))
    rj = _jax_kernel_run(y, mask, x0, d0, tol=0.0, maxiter=15)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                    maxiter=15, use_kernel=True, kernel_block_rows=16,
                    device="cpu")
    assert spy.packed == [True] and spy.unpacked == 15
    assert rt.niter == 15
    assert rel_err(rt.x.numpy(), rj.x) < 1e-4
    assert rel_err(rt.d.numpy(), rj.d) < 1e-4


def test_solve_keeps_a_weighted_mask_dense(monkeypatch):
    """A weighted mask is refused by pack_mask and runs the dense route,
    as before: the same bits as the composition-free dense twin."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0 = (a.astype(np.float32)
                       for a in _problem(seed=6, m=40, n=30, k=3))
    mask = mask * np.where(np.arange(30) % 2, 0.5, 1.0).astype(np.float32)
    rt = tnmf.solve(_t(y), _t(d0), x=_t(x0), mask=_t(mask), tol=0.0,
                    maxiter=5, use_kernel=True, device="cpu")
    assert spy.packed == [False] and spy.unpacked == 0
    my = _t(mask) * _t(y)
    x, d = _t(x0), _t(d0)
    for _ in range(5):
        x, d = cuda_mu.mu_update_masked(my, _t(mask), x, d,
                                        float(np.float32(1e-15)))
    assert torch.equal(rt.x, x) and torch.equal(rt.d, d)


def test_heldout_solve_packs_the_training_mask(monkeypatch):
    """Under stop='heldout' the packed mask is the training mask (observed
    minus the validation reserve): with decomp_tpu's reserve passed in,
    the kernel path stops where the Pallas run in interpret mode stops,
    with a close validation error."""
    spy = _RouteSpy(monkeypatch)
    y, mask, x0, d0, val = (a.astype(np.float32)
                            for a in _heldout_problem())
    kw = dict(tol=1e-3, maxiter=3000, check_every=25)
    rj = _jax_kernel_run(y, mask, x0, d0, stop="heldout", random_seed=21,
                         **kw)
    rt = tnmf._solve(_t(y), _t(d0), _t(x0), _t(mask), _t(val), rank=4,
                     use_kernel=True, kernel_block_rows=16, **kw)
    assert spy.packed == [True]
    assert bool(rj.converged) and rt.converged
    assert rt.niter == int(rj.niter)
    ej = float(np.asarray(rj.aux["heldout_rel_err"]))
    assert abs(float(rt.aux["heldout_rel_err"]) - ej) < 1e-4 * ej
    assert rel_err(rt.d.numpy(), rj.d) < 1e-3
