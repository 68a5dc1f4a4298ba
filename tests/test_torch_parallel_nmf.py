"""Sharded NMF of the PyTorch port (``decomp_tpu_torch.parallel.nmf``) on
gloo worlds of CPU ranks, against the port's one-process solve and against
``decomp_tpu.parallel.nmf`` on a JAX mesh of the same shape.

The same seeded numpy inputs and explicit ``d0`` / ``x0`` go to all three;
each rank solves its block and the parent reassembles the global factors.
Tolerances: f64, 1e-12 relative against the one-process port (the sums
differ only in order) and 1e-10 against JAX; the kernels' twins form their
statistics in f32, so their runs agree to 1e-6."""

import numpy as np
import pytest
import torch

import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from problems import planted_nmf, random_mask, rel_err
from torch_parallel_ranks import assemble, worlds  # noqa: F401

MESHES = {
    "row4": (((4,), ("rows",)), "rows", None),
    "grid2x2": (((2, 2), ("rows", "cols")), "rows", "cols"),
    "slice2x2": (((2, 2), ("slice", "rows")), ("slice", "rows"), None),
    "slice2x1x2": (((2, 1, 2), ("slice", "rows", "cols")),
                   ("slice", "rows"), "cols"),
}


def _problem(seed, m=64, n=40, k=5, masked=False):
    y, *_ = planted_nmf(seed=seed, n_samples=m, n_channels=n, rank=k)
    rng = np.random.default_rng(seed + 1)
    x0, d0 = rng.uniform(0.1, 1, (m, k)), rng.uniform(0.1, 1, (k, n))
    mask = random_mask(seed + 2, y.shape) if masked else None
    return dict(y=y, d=d0, x=x0, mask=mask)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _single(arrays, **kw):
    return dt.nmf.solve(_t(arrays["y"]), _t(arrays["d"]), x=_t(arrays["x"]),
                        mask=_t(arrays["mask"]), device="cpu", **kw)


def _jax(arrays, spec, row_axis, col_axis, **kw):
    import jax
    from decomp_tpu import parallel as jpar

    shape, names = spec
    mesh = jpar.make_mesh(shape, names,
                          devices=jax.devices()[:int(np.prod(shape))])
    return jpar.nmf.solve(arrays["y"], arrays["d"], x=arrays["x"],
                          mask=arrays["mask"], mesh=mesh, row_axis=row_axis,
                          col_axis=col_axis, **kw)


def _run(worlds, name, arrays, **kw):
    spec, row_axis, col_axis = MESHES[name]
    n = int(np.prod(spec[0]))
    return worlds(n).run(ranks.nmf, spec, row_axis, col_axis, arrays, kw)


def _check(outs, ref, tol, col_axis=None):
    """The ranks' reassembled factors against ``ref`` (x, d, niter)."""
    x = assemble(outs, "x", 0, "row")
    d = assemble(outs, "d", 1, "col")
    assert rel_err(x, np.asarray(ref.x)) < tol
    assert rel_err(d, np.asarray(ref.d)) < tol
    assert {o["niter"] for o in outs} == {int(ref.niter)}
    assert {o["converged"] for o in outs} == {bool(ref.converged)}
    if col_axis is None:
        # d comes from all-reduced statistics: the same bits everywhere.
        assert all(o["d_same"] for o in outs)


@pytest.mark.parametrize("method,masked", [
    ("mu", False), ("mu", True), ("kl-mu", False), ("kl-mu", True),
    ("hals", False)])
@pytest.mark.parametrize("mesh", ["row4", "grid2x2"])
def test_sharded_matches_single_and_jax(worlds, mesh, method, masked):
    arrays = _problem(1, masked=masked)
    kw = dict(tol=0.0, maxiter=40, method=method)
    outs = _run(worlds, mesh, arrays, **kw)
    _check(outs, _single(arrays, **kw), 1e-12, MESHES[mesh][2])
    _check(outs, _jax(arrays, *MESHES[mesh], **kw), 1e-10, MESHES[mesh][2])


@pytest.mark.parametrize("mesh", ["slice2x2", "slice2x1x2"])
@pytest.mark.parametrize("masked", [False, True])
def test_tuple_axes_match_single_and_jax(worlds, mesh, masked):
    """A ('slice', 'rows') row axis, alone and with a column axis on a (2,
    1, 2) mesh: reduced over each dim's group in turn."""
    arrays = _problem(4, masked=masked)
    kw = dict(tol=0.0, maxiter=30, method="mu")
    outs = _run(worlds, mesh, arrays, **kw)
    _check(outs, _single(arrays, **kw), 1e-12, MESHES[mesh][2])
    _check(outs, _jax(arrays, *MESHES[mesh], **kw), 1e-10, MESHES[mesh][2])


def test_convergence_and_objective_agree(worlds):
    """A tol > 0 run stops on the single run's iteration; the objective
    curve is the global one."""
    arrays = _problem(7, masked=True)
    kw = dict(tol=1e-4, maxiter=3000, check_every=1)
    outs = _run(worlds, "grid2x2", arrays, **kw)
    ref = _single(arrays, **kw)
    assert ref.converged and ref.niter < 3000
    _check(outs, ref, 1e-9, "cols")
    _check(outs, _jax(arrays, *MESHES["grid2x2"], **kw), 1e-8, "cols")
    kw = dict(tol=0.0, maxiter=25, record_objective=True)
    outs = _run(worlds, "grid2x2", arrays, **kw)
    ref = _single(arrays, **kw)
    for o in outs:
        assert rel_err(o["objective"], ref.objective.numpy()) < 1e-12


@pytest.mark.parametrize("method,masked", [
    ("mu", False), ("mu", True), ("kl-mu", False), ("kl-mu", True)])
def test_kernel_twins_row_sharded(worlds, method, masked):
    """use_kernel=True: each rank runs the ops.cuda_mu wrapper (its twin on
    the CPU) on its rows, the statistics summed before the epilogue."""
    arrays = _problem(10, masked=masked)
    kw = dict(tol=0.0, maxiter=30, method=method, use_kernel=True)
    outs = _run(worlds, "row4", arrays, **kw)
    _check(outs, _single(arrays, **kw), 1e-6)
    _check(outs, _jax(arrays, *MESHES["row4"], tol=0.0, maxiter=30,
                      method=method), 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_mixed_precision_matches_single_and_jax(worlds, masked):
    """bf16 data, f32 factors: every product on bf16 operands summed in
    f32, so the ranks' partial sums agree with one sum to 1e-5."""
    import jax.numpy as jnp

    arrays = _problem(12, masked=masked)
    yb = torch.as_tensor(arrays["y"]).to(torch.bfloat16)
    outs = worlds(2).run(ranks.nmf, ((2,), ("rows",)), "rows", None,
                         {**arrays, "y": yb},
                         dict(tol=0.0, maxiter=30, factor_dtype=torch.float32,
                              use_kernel=False))
    ref = dt.nmf.solve(yb, _t(arrays["d"]), x=_t(arrays["x"]),
                       mask=_t(arrays["mask"]), tol=0.0, maxiter=30,
                       factor_dtype=torch.float32, device="cpu")
    _check(outs, ref, 1e-5)
    y32 = yb.to(torch.float32).numpy()
    jref = _jax({**arrays, "y": jnp.asarray(y32, jnp.bfloat16)},
                ((2,), ("rows",)), "rows", None, tol=0.0, maxiter=30,
                factor_dtype=jnp.float32)
    _check(outs, jref, 1e-4)


def test_random_init(worlds):
    """rank= without d or x: each rank draws its x block from its row
    coordinate, d the same everywhere; the scale is the global mean."""
    arrays = _problem(15)
    arrays.update(d=None, x=None)
    kw = dict(rank=5, tol=0.0, maxiter=20, random_seed=3)
    outs = _run(worlds, "row4", arrays, **kw)
    again = _run(worlds, "row4", arrays, **kw)
    x = assemble(outs, "x")
    assert np.isfinite(x).all() and (x >= 0).all()
    assert all(o["d_same"] for o in outs)
    assert np.array_equal(x, assemble(again, "x"))
    blocks = [o["x"] for o in outs]
    assert not np.array_equal(blocks[0], blocks[1])
    y = arrays["y"]
    assert rel_err(x @ outs[0]["d"], y) < 0.2


def test_world_of_two_matches_world_of_four(worlds):
    arrays = _problem(18, masked=True)
    kw = dict(tol=0.0, maxiter=30, method="kl-mu")
    two = worlds(2).run(ranks.nmf, ((2,), ("rows",)), "rows", None, arrays,
                        kw)
    four = _run(worlds, "row4", arrays, **kw)
    assert rel_err(assemble(two, "x"), assemble(four, "x")) < 1e-12
    assert rel_err(two[0]["d"], four[0]["d"]) < 1e-12


def test_checkpointed_sharded_solve(worlds, tmp_path):
    """checkpointed_solve over parallel.nmf.solve, one snapshot file per
    rank, ends where the straight sharded run does, bit for bit."""
    arrays = _problem(33, m=64, n=40, k=4)
    outs = worlds(4).run(ranks.checkpointed, arrays, str(tmp_path), 10, 30)
    assert outs == [(30, True, True)] * 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"rank{r}.npz" for r in range(4)]
