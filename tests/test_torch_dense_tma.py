"""The bf16 route of dense MU in the PyTorch port (``csrc/mu_dense_tma.cu``):
its row chunks, the route ``mu_stats_dense`` takes by dtype and device,
the padded copies TMA needs, the twin at the route's chunk rows against
``decomp_tpu``'s Pallas kernel in interpret mode, and the checks that
come before any launch. The kernel itself runs on the card only
(``chip_smoke.py`` phase 2); the same numpy inputs, made from a seed, go
through both packages here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decomp_tpu.ops import pallas_mu
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err
from test_torch_nmf import _arrs, _bf16_np, _t


@pytest.mark.parametrize("m,n,rows", [
    (1 << 20, 10112, 131072),   # the main path: 8 chunks x 80 tiles
    (65537, 10112, 8256),       # ragged M: 8 chunks, the last 7,745 rows
    (65536, 10112, 8192),
    (100_000, 1000, 7168),      # 14 chunks x 9 tiles = 126 blocks
    (1000, 1000, 128),
    (333, 257, 64),
    (1, 1, 64),
])
def test_tma_rows_are_whole_stages_and_a_function_of_the_shape(m, n, rows):
    """Whole 64-row stages, so no stage crosses into the next chunk; the
    same (M, N) always gives the same chunks, and with them the same
    summation order."""
    got = cuda_mu.dense_tma_block_rows(m, n)
    assert got == rows == cuda_mu.dense_tma_block_rows(m, n)
    assert got % 64 == 0 and -(-m // got) <= 64


def test_tma_chunks_fill_their_waves_at_the_main_path():
    """1,048,576 x 10,112: 80 N tiles (79 + the gram tile) x 8 chunks make
    640 blocks, 97% of 5 waves of 132 resident blocks, and 42 MB of f32
    partials at K = 128 (default_block_rows: 128 chunks, 671 MB)."""
    m, n, k = 1 << 20, 10112, 128
    chunks = -(-m // cuda_mu.dense_tma_block_rows(m, n))
    blocks = chunks * (-(-n // 128) + 1)
    assert (chunks, blocks) == (8, 640)
    assert blocks / (-(-blocks // 132) * 132) >= 0.95
    assert chunks * (k * n + k * k) * 4 < 50e6
    assert -(-m // cuda_mu.default_block_rows(m)) == 128


@pytest.mark.parametrize("dtype,device,route", [
    (torch.bfloat16, torch.device("cuda"), "tma"),
    (torch.bfloat16, "cuda:1", "tma"),
    (torch.float32, torch.device("cuda", 0), "packed"),
    (torch.bfloat16, "cpu", "plain"),
    (torch.float32, torch.device("cpu"), "plain"),
    (torch.float64, "cpu", "plain"),
])
def test_dense_route_by_dtype_and_device(dtype, device, route):
    assert cuda_mu.dense_route(dtype, device) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_route_of_cpu_and_meta_tensors(dtype):
    """A CPU tensor takes the twin and counts no launch; a meta tensor has
    no kernel, on either route, and is refused before anything runs."""
    y, x, d = _arrs(7, 24, 40, 5)
    y, d = _t(y, dtype), _t(d, dtype)
    x = _t(x, torch.float32)
    assert cuda_mu.dense_route(y.dtype, y.device) == "plain"
    before = (cuda_mu.mu_stats_dense.launches,
              cuda_mu.mu_stats_dense.tma_launches)
    got = cuda_mu.mu_stats_dense(y, x, d, 1e-6)
    ref = cuda_mu.mu_stats_dense_plain(y, x, d, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (cuda_mu.mu_stats_dense.launches,
            cuda_mu.mu_stats_dense.tma_launches) == before
    meta = (torch.empty((24, 40), dtype=dtype, device="meta"),
            torch.empty((24, 5), device="meta"),
            torch.empty((5, 40), dtype=dtype, device="meta"))
    with pytest.raises(texc.DecompError, match="no kernel"):
        cuda_mu.dense_route(dtype, meta[0].device)
    with pytest.raises(texc.DecompError, match="no kernel"):
        cuda_mu.mu_stats_dense(*meta, 1e-6)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 16, 257, 264])
def test_tma_rows_pad_exactly_when_rows_are_not_16_bytes(n):
    """bf16 rows are 16-byte aligned when N % 8 == 0: then the tensor goes
    as it is; otherwise a copy whose rows are padded with zeros to the
    next multiple of 8."""
    t = torch.from_numpy(np.random.default_rng(n).uniform(0.1, 1, (5, n))
                         ).to(torch.bfloat16)
    got, ld = cuda_mu._tma_rows(t)
    if n % 8 == 0:
        assert got is t and ld == n
    else:
        assert ld == -(-n // 8) * 8 and got.shape == (5, ld)
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got[:, :n], t)
        assert int((got[:, n:] != 0).sum()) == 0


# f64: the Pallas kernel forms x_new and its statistics in f32 even for f64
# data (pallas_mu.py:191, :488-489), and the twin mirrors those casts, so
# both agree to f32 summation order: 1e-6 relative, as in
# test_torch_nmf.py. The route's chunk rows (64 here: 2-4 chunks) change
# nothing but the order of the twin's f32 sums.
@pytest.mark.parametrize("m,inner", [(200, 1), (136, 3)])
def test_twin_at_tma_rows_matches_pallas_f64(m, inner):
    n, k = 256, 128
    rows = cuda_mu.dense_tma_block_rows(m, n)
    assert rows == 64 and -(-m // rows) > 1
    y, x, d = _arrs(20 + m, m, n, k)
    sj = pallas_mu.mu_stats_dense(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(d), 1e-15,
        block_rows=8, interpret=True, inner_iter=inner)
    st = cuda_mu.mu_stats_dense_plain(_t(y), _t(x), _t(d), 1e-15,
                                      block_rows=rows, inner_iter=inner)
    one = cuda_mu.mu_stats_dense_plain(_t(y), _t(x), _t(d), 1e-15,
                                       block_rows=m, inner_iter=inner)
    for a, b, c in zip(st, sj, one):
        assert rel_err(a.numpy(), b) < 1e-6
        assert rel_err(a.numpy(), c.numpy()) < 1e-6


# Mixed mode (bf16 y and d, f32 x): the limits of test_torch_masked.py's
# mixed statistics test: x_new 1e-5, the statistics 1e-4 (one bf16
# rounding flip of cdt(x_new) moves a statistic by ~2e-5 at this size).
@pytest.mark.parametrize("seed", [31, 32])
def test_twin_at_tma_rows_matches_pallas_mixed(seed):
    m, n, k = 192, 256, 128
    y, x, d = _arrs(seed, m, n, k)
    yb, x32, db = _bf16_np(y), x.astype(np.float32), _bf16_np(d)
    sj = pallas_mu.mu_stats_dense(
        jnp.asarray(yb, jnp.bfloat16), jnp.asarray(x32),
        jnp.asarray(db, jnp.bfloat16), 1e-6, block_rows=16, interpret=True)
    st = cuda_mu.mu_stats_dense_plain(
        _t(yb, torch.bfloat16), _t(x32), _t(db, torch.bfloat16), 1e-6,
        block_rows=cuda_mu.dense_tma_block_rows(m, n))
    for a, b, limit in zip(st, sj, (1e-5, 1e-4, 1e-4)):
        assert a.dtype == torch.float32
        assert rel_err(a.numpy(), b) < limit


def _no_launch(*_):
    raise AssertionError("the kernel was reached")


@pytest.mark.parametrize("case,exc", [
    ("rank 129", texc.ShapeError),
    ("non-contiguous y", texc.DecompError),
    ("f32 d", texc.DtypeError),
    ("f32 y", texc.DtypeError),
    ("f64 x", texc.DtypeError),
    ("x of another height", texc.ShapeError),
])
def test_tma_launch_refuses_before_any_launch(monkeypatch, case, exc):
    """What the TMA kernel does not take is refused before the library is
    built or called (checked on CPU tensors: the checks do not look at the
    device type)."""
    monkeypatch.setattr(cuda_mu, "_c_function", _no_launch)
    bf16 = torch.bfloat16
    k = 129 if case == "rank 129" else 4
    y = torch.zeros((16, 24), dtype=bf16)
    x = torch.zeros((16, k))
    d = torch.zeros((k, 24), dtype=bf16)
    if case == "non-contiguous y":
        y = torch.zeros((24, 16), dtype=bf16).T
    elif case == "f32 d":
        d = d.float()
    elif case == "f32 y":
        y, d = y.float(), d.float()
    elif case == "f64 x":
        x = x.double()
    elif case == "x of another height":
        x = torch.zeros((15, k))
    with pytest.raises(exc):
        cuda_mu._dense_tma_launch(y, x, d, 1e-6, None, 1)
