"""Held-out stopping in the PyTorch port's sharded solves: the reserve's
blocks, lockstep with the one-process solve, ``masked_completion(mesh=)``
and held-out dictionary learning, on gloo worlds of CPU ranks, against the
port's one-process solves and ``decomp_tpu.parallel`` (fed the JAX draw
through the private ``_val``).

Each rank's reserve must be its block of ``nmf._heldout_reserve``'s draw on
the global matrix, whatever the number of ranks; the tests shrink the draw's
row chunk to a few rows so that blocks start and end inside chunks. The
sharded run must then stop on the one-process run's iteration, with the
factors within 1e-12 (f64, the order of the sums alone differs) and the
held-out error within 1e-12; against JAX within 1e-10."""

import numpy as np
import pytest
import torch

import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from decomp_tpu_torch.models import nmf as tnmf
from problems import planted_nmf, planted_patches, rel_err
from torch_parallel_ranks import assemble, worlds  # noqa: F401

CHUNK = 7


def _problem(seed=21, m=96, n=30, k=4):
    rng = np.random.default_rng(seed)
    y, *_ = planted_nmf(seed=seed, n_samples=m, n_channels=n, rank=k,
                        noise=0.05)
    mask = (rng.random((m, n)) >= 0.3).astype(np.float64)
    x0, d0 = rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n))
    return dict(y=y * mask, mask=mask, x=x0, d=d0)


def _jax_reserve(shape, mask, frac, seed):
    """decomp_tpu's global held-out reserve (parallel/nmf.py:446-472)."""
    import jax
    from decomp_tpu.models.nmf import _HELDOUT_SALT

    kv = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                            _HELDOUT_SALT)
    return np.asarray((jax.random.uniform(kv, shape) < frac)
                      .astype(np.float64) * mask)


@pytest.mark.parametrize("rows,cols", [(1, 1), (2, 1), (4, 1), (3, 1),
                                       (2, 2), (4, 3)])
def test_reserve_blocks_are_the_global_draw(monkeypatch, rows, cols):
    """Every (row, col) block of the replayed draw equals that block of
    the global reserve, chunks cut anywhere."""
    monkeypatch.setattr(tnmf, "_CHUNK_ROWS", CHUNK)
    rng = np.random.default_rng(5)
    m, n = 60, 24
    mask = torch.as_tensor((rng.random((m, n)) > 0.3).astype(np.float32))
    full = tnmf._heldout_reserve(mask, 0.2, 11)
    mb, nb = m // rows, n // cols
    for r in range(rows):
        for c in range(cols):
            blk = (slice(r * mb, (r + 1) * mb), slice(c * nb, (c + 1) * nb))
            got = tnmf._heldout_block(mask[blk], 0.2, 11, (m, n), r * mb,
                                      c * nb)
            assert torch.equal(got, full[blk])


@pytest.mark.parametrize("world,spec,row_axis,col_axis", [
    (2, ((2,), ("rows",)), "rows", None),
    (4, ((4,), ("rows",)), "rows", None),
    (4, ((2, 2), ("rows", "cols")), "rows", "cols"),
    (4, ((2, 2), ("slice", "rows")), ("slice", "rows"), None),
])
@pytest.mark.parametrize("method", ["mu", "kl-mu"])
def test_heldout_lockstep_with_single(worlds, monkeypatch, world, spec,
                                      row_axis, col_axis, method):
    """The public draw: the sharded run stops on the one-process run's
    check, every rank on the same one."""
    monkeypatch.setattr(tnmf, "_CHUNK_ROWS", CHUNK)
    arrays = _problem()
    kw = dict(tol=1e-2, maxiter=600, method=method, stop="heldout",
              random_seed=5)
    outs = worlds(world).run(ranks.nmf, spec, row_axis, col_axis, arrays,
                             kw, CHUNK)
    ref = dt.nmf.solve(torch.as_tensor(arrays["y"]),
                       torch.as_tensor(arrays["d"]),
                       x=torch.as_tensor(arrays["x"]),
                       mask=torch.as_tensor(arrays["mask"]), device="cpu",
                       **kw)
    assert ref.converged and ref.niter < 600
    assert {o["niter"] for o in outs} == {ref.niter}
    assert {o["converged"] for o in outs} == {True}
    tol = 1e-12 if col_axis is None and not isinstance(row_axis, tuple) \
        else 1e-10
    assert rel_err(assemble(outs, "x"), ref.x.numpy()) < tol
    assert rel_err(assemble(outs, "d", 1, "col"), ref.d.numpy()) < tol
    ho = float(ref.aux["heldout_rel_err"])
    assert all(abs(o["heldout"] - ho) <= 1e-12 * ho for o in outs)


@pytest.mark.parametrize("spec,row_axis,col_axis", [
    (((4,), ("rows",)), "rows", None),
    (((2, 2), ("rows", "cols")), "rows", "cols"),
])
def test_heldout_matches_jax(worlds, spec, row_axis, col_axis):
    """JAX's global reserve through _val: the sharded port stops on
    decomp_tpu.parallel's iteration."""
    import jax
    from decomp_tpu import parallel as jpar

    arrays = _problem(seed=23)
    val = _jax_reserve(arrays["y"].shape, arrays["mask"], 0.05, 5)
    kw = dict(tol=1e-2, maxiter=600, stop="heldout", random_seed=5)
    outs = worlds(4).run(ranks.nmf, spec, row_axis, col_axis,
                         {**arrays, "_val": val}, kw)
    mesh = jpar.make_mesh(*spec, devices=jax.devices()[:4])
    ref = jpar.nmf.solve(arrays["y"], arrays["d"], x=arrays["x"],
                         mask=arrays["mask"], mesh=mesh, row_axis=row_axis,
                         col_axis=col_axis, **kw)
    assert bool(ref.converged)
    assert {o["niter"] for o in outs} == {int(ref.niter)}
    assert rel_err(assemble(outs, "x"), np.asarray(ref.x)) < 1e-10
    assert rel_err(assemble(outs, "d", 1, "col"), np.asarray(ref.d)) < 1e-10
    ho = float(ref.aux["heldout_rel_err"])
    assert all(abs(o["heldout"] - ho) <= 1e-6 * ho for o in outs)


@pytest.mark.parametrize("refit", [0, 15])
def test_masked_completion_mesh_lockstep(worlds, monkeypatch, refit):
    """masked_completion(mesh=...) runs parallel.nmf.solve: the one-process
    preset's stop, factors and refit."""
    monkeypatch.setattr(tnmf, "_CHUNK_ROWS", CHUNK)
    arrays = _problem(seed=25)
    kw = dict(rank=4, tol=1e-2, maxiter=600, random_seed=2, refit=refit)
    outs = worlds(2).run(ranks.completion, ((2,), ("rows",)), arrays, kw,
                         CHUNK)
    ref = tnmf.masked_completion(
        torch.as_tensor(arrays["y"]), torch.as_tensor(arrays["mask"]),
        d=torch.as_tensor(arrays["d"]), x=torch.as_tensor(arrays["x"]),
        device="cpu", **kw)
    assert {o["niter"] for o in outs} == {ref.niter}
    assert rel_err(assemble(outs, "x"), ref.x.numpy()) < 1e-12
    assert rel_err(outs[0]["d"], ref.d.numpy()) < 1e-12
    assert all(o["d_same"] for o in outs)


def test_dictionary_learning_heldout_lockstep(worlds, monkeypatch):
    """Held-out dictionary learning stops on the one-process outer
    iteration."""
    monkeypatch.setattr(tnmf, "_CHUNK_ROWS", CHUNK)
    y, d0, _ = planted_patches(seed=7, n_samples=64, n_channels=16,
                               n_atoms=6)
    mask = (np.random.default_rng(8).random(y.shape) > 0.25).astype(
        np.float64)
    kw = dict(tol=1e-3, maxiter=60, lasso_iter=5, stop="heldout",
              random_seed=4)
    arrays = dict(y=y * mask, d=d0, alpha=0.05, mask=mask)
    outs = worlds(4).run(ranks.dl, ((4,), ("rows",)), "rows", arrays, kw,
                         CHUNK)
    ref = dt.dictionary_learning.solve(
        torch.as_tensor(y * mask), torch.as_tensor(d0), 0.05,
        mask=torch.as_tensor(mask), device="cpu", **kw)
    assert {o["niter"] for o in outs} == {ref.niter}
    assert rel_err(assemble(outs, "x"), ref.x.numpy()) < 1e-10
    assert rel_err(outs[0]["d"], ref.d.numpy()) < 1e-10
    assert all(o["d_same"] for o in outs)
