"""Meshes, blocks, refusals and the launcher of the PyTorch port's sharded
solvers (``decomp_tpu_torch.parallel``), on gloo worlds of CPU ranks.

Every invalid argument must raise ``DecompError`` on every rank, also when
only one rank passes it: a rank that raised alone would leave the others
waiting in a collective. The launcher must turn a failing or silent rank
into one failing test, never a hang."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from decomp_tpu_torch import parallel
from decomp_tpu_torch.models import nmf as tnmf
from decomp_tpu_torch.parallel import _spawn
from decomp_tpu_torch.utils import exceptions as texc
from decomp_tpu_torch.utils.exceptions import DecompError
from torch_parallel_ranks import worlds  # noqa: F401

ROW2 = ((2,), ("rows",))
GRID = ((2, 1), ("rows", "cols"))


def _nmf_kw(**kw):
    rng = np.random.default_rng(0)
    return dict(y=rng.uniform(0.1, 1, (8, 6)), rank=2, tol=0.0, maxiter=3,
                **kw)


def _lasso_kw(**kw):
    rng = np.random.default_rng(1)
    return dict(y=rng.normal(size=(8, 6)), a=rng.normal(size=(4, 6)),
                alpha=0.1, maxiter=3, **kw)


def _dl_kw(**kw):
    rng = np.random.default_rng(2)
    return dict(y=rng.normal(size=(8, 6)), d=rng.normal(size=(3, 6)),
                alpha=0.1, maxiter=2, **kw)


REFUSALS = {
    "unknown axis": (ROW2, "nmf", _nmf_kw(row_axis="nope"), None),
    "repeated axis": (ROW2, "nmf", _nmf_kw(row_axis=("rows", "rows")), None),
    "axis not a name": (ROW2, "nmf", _nmf_kw(row_axis=3), None),
    "shared axis": (GRID, "nmf", _nmf_kw(col_axis="rows"), None),
    "kernel with col_axis": (GRID, "nmf",
                             _nmf_kw(col_axis="cols", use_kernel=True), None),
    "not a mesh": (None, "nmf", _nmf_kw(), None),
    "bad method on one rank": (ROW2, "nmf", _nmf_kw(),
                               {1: {"method": "bogus"}}),
    "unequal blocks": (ROW2, "nmf", _nmf_kw(),
                       {0: {"y": np.ones((9, 6))}}),
    "d's columns": (ROW2, "nmf", _nmf_kw(d=np.ones((2, 5))), None),
    "_val on one rank": (ROW2, "nmf", _nmf_kw(mask=np.ones((8, 6)),
                                             stop="heldout"),
                         {1: {"_val": np.zeros((8, 6))}}),
    "heldout without mask": (ROW2, "nmf", _nmf_kw(stop="heldout"), None),
    "lasso alpha on one rank": (ROW2, "lasso", _lasso_kw(),
                                {0: {"alpha": -1.0}}),
    "lasso unmasked kernel": (ROW2, "lasso", _lasso_kw(use_kernel=True),
                              None),
    "lasso axis": (GRID, "lasso", _lasso_kw(axis="cols2"), None),
    "completion device": (ROW2, "completion",
                          _nmf_kw(mask=np.ones((8, 6)), device="cpu"), None),
    "completion axis": (ROW2, "completion",
                        _nmf_kw(mask=np.ones((8, 6)), col_axis="rows"),
                        None),
    "dl cd": (ROW2, "dl", _dl_kw(lasso_method="cd"), None),
    "dl x on one rank": (ROW2, "dl", _dl_kw(),
                         {1: {"x": np.zeros((8, 2))}}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_on_every_rank(worlds, case):
    spec, solver, kw, per_rank = REFUSALS[case]
    outs = worlds(2).run(ranks.refusal, spec, solver, kw, per_rank)
    assert all(o is not None for o in outs), outs
    for name, _ in outs:
        assert issubclass(getattr(texc, name), DecompError)


def test_mesh_device_type_must_be_the_data_s(worlds):
    outs = worlds(2).run(ranks.refusal, ROW2, "nmf",
                         {**_nmf_kw(), "y": torch.zeros((8, 6))}, None,
                         True)
    assert all(o[0] == "DecompError" and "device type" in o[1]
               for o in outs)


def test_no_process_group_is_refused():
    y = np.ones((4, 4))
    with pytest.raises(DecompError, match="process group"):
        parallel.nmf.solve(y, rank=2, mesh=object())
    with pytest.raises(DecompError, match="process group"):
        parallel.lasso.solve(y, y, 0.1, mesh=object())
    with pytest.raises(DecompError, match="process group"):
        tnmf.masked_completion(y, y, rank=2, mesh=object())


def test_shard_rows_and_meshes(worlds):
    rows = 8
    g = np.arange(rows * 6, dtype=np.float32).reshape(rows, 6)
    outs = worlds(4).run(ranks.meshes, rows)
    for rank, o in enumerate(outs):
        assert np.array_equal(o["flat"], g[2 * rank:2 * rank + 2])
        # ('slice', 'rows'): slices outermost, ranks in order
        assert o["sliced_index"] == rank
        assert np.array_equal(o["sliced"], g[2 * rank:2 * rank + 2])
        assert o["sliced_shape"] == (2, 2)
        assert o["sliced_layout"] == [[0, 1], [2, 3]]
        # one host: the inferred layout is one slice of every rank
        assert o["host_shape"] == (1, 4)
        r, c = o["grid"]
        assert np.array_equal(o["block"], g[4 * r:4 * r + 4, 3 * c:3 * c + 3])
        assert o["device"] == "cpu"
    assert worlds(4).run(ranks.multislice_refusals) == [
        ["DecompError", "DecompError", "ValueError"]] * 4


def test_launcher_reraises_a_failing_rank(tmp_path):
    world = _spawn.World(2, tmp_path, timeout=500)
    try:
        assert world.timeout == _spawn.MAX_TIMEOUT == 120.0
        assert world.run(ranks.sleeps, 0.0) == [0, 1]
        with pytest.raises(RuntimeError, match="rank one fails on purpose"):
            world.run(ranks.fails_on_rank_one)
        assert not world.alive
        with pytest.raises(RuntimeError, match="closed"):
            world.run(ranks.sleeps, 0.0)
    finally:
        world.close()


def test_launcher_times_out(tmp_path):
    """A rank that does not answer fails the call after the world's own
    timeout, and the world is terminated."""
    with pytest.raises(RuntimeError, match="no answer from every rank"):
        _spawn.run(ranks.sleeps, 2, tmp_path, 60.0, timeout=3)
