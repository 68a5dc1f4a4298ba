"""What the ranks of the sharded-solver tests run, and the worlds that run
it (``tests/test_torch_parallel_*.py``).

The ranks of a world import this module to unpickle the functions they are
sent, so it imports no JAX and nothing of ``decomp_tpu``: the tests hold the
ranks' results against ``decomp_tpu.parallel`` in the parent process. Each
function takes global numpy arrays, cuts the rank's blocks with
``parallel.shard_rows``, solves, and returns numpy blocks with the rank's
coordinates, so that the parent can reassemble the global result.
"""

import numpy as np
import pytest
import torch

from decomp_tpu_torch import parallel
from decomp_tpu_torch.parallel import _spawn
from decomp_tpu_torch.parallel import mesh as pmesh
from decomp_tpu_torch.utils.exceptions import DecompError


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``worlds(n)``: this module's gloo world of ``n`` CPU ranks, spawned
    on first use and again after a failure; closed with the module."""
    cache = {}

    def get(n):
        if n not in cache or not cache[n].alive:
            cache[n] = _spawn.World(n, tmp_path_factory.mktemp(f"world{n}"))
        return cache[n]

    yield get
    for world in cache.values():
        world.close()


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _blocks(mesh, row_axis, col_axis, arrays):
    """The rank's blocks of the global arrays: 'y', 'mask', '_val' by
    (row, col), 'x' and a 2-D 'alpha' by rows, 'd' by columns; other
    entries as they are."""
    out = {}
    for key, a in arrays.items():
        if a is not None and key in ("y", "mask", "_val"):
            a = parallel.shard_rows(a, mesh, row_axis, col_axis)
        elif a is not None and (key == "x"
                                or key == "alpha" and np.ndim(a) == 2):
            a = parallel.shard_rows(a, mesh, row_axis)
        elif a is not None and key == "d" and col_axis is not None:
            a = parallel.shard_rows(a, mesh, None, col_axis)
        out[key] = a
    return out


def _result(res, mesh, row_axis, col_axis=None):
    aux = getattr(res, "aux", None)
    out = dict(row=pmesh.axis_index(mesh, row_axis),
               col=0 if col_axis is None else pmesh.axis_index(mesh,
                                                                col_axis),
               x=_np(res.x), niter=_np(res.niter) if isinstance(
                   res.niter, torch.Tensor) else res.niter,
               converged=_np(res.converged) if isinstance(
                   res.converged, torch.Tensor) else res.converged,
               objective=_np(res.objective),
               heldout=None if not aux else float(aux["heldout_rel_err"]))
    if hasattr(res, "d"):
        out["d"] = _np(res.d)
        out["d_same"] = _spawn.same_on_all_ranks(res.d)
    return out


def _chunk(chunk_rows):
    """Shrink the held-out draw's row chunk in this rank (None: keep)."""
    if chunk_rows is not None:
        from decomp_tpu_torch.models import nmf as tnmf
        tnmf._CHUNK_ROWS = chunk_rows


def nmf(rank, n, spec, row_axis, col_axis, arrays, kw, chunk_rows=None):
    """``parallel.nmf.solve`` on the rank's blocks of ``arrays``;
    ``chunk_rows`` shrinks the held-out draw's row chunk."""
    _chunk(chunk_rows)
    mesh = parallel.make_mesh(*spec)
    b = _blocks(mesh, row_axis, col_axis, arrays)
    y, d = b.pop("y"), b.pop("d", None)
    res = parallel.nmf.solve(y, d, mesh=mesh, row_axis=row_axis,
                             col_axis=col_axis, **b, **kw)
    return _result(res, mesh, row_axis, col_axis)


def completion(rank, n, spec, arrays, kw, chunk_rows=None):
    """``nmf.masked_completion(mesh=...)`` on the rank's rows."""
    from decomp_tpu_torch.models import nmf as tnmf

    _chunk(chunk_rows)
    mesh = parallel.make_mesh(*spec)
    b = _blocks(mesh, "rows", None, arrays)
    res = tnmf.masked_completion(b.pop("y"), b.pop("mask"), mesh=mesh,
                                 **b, **kw)
    return _result(res, mesh, "rows")


def lasso(rank, n, spec, axis, arrays, kw):
    """``parallel.lasso.solve`` on the rank's rows."""
    mesh = parallel.make_mesh(*spec)
    b = _blocks(mesh, axis, None, arrays)
    res = parallel.lasso.solve(b.pop("y"), b.pop("a"), b.pop("alpha"),
                               mesh=mesh, axis=axis, **b, **kw)
    return _result(res, mesh, axis)


def dl(rank, n, spec, axis, arrays, kw, chunk_rows=None):
    """``parallel.dictionary_learning.solve`` on the rank's rows."""
    _chunk(chunk_rows)
    mesh = parallel.make_mesh(*spec)
    b = _blocks(mesh, axis, None, arrays)
    res = parallel.dictionary_learning.solve(
        b.pop("y"), b.pop("d"), b.pop("alpha"), mesh=mesh, axis=axis, **b,
        **kw)
    return _result(res, mesh, axis)


def _loader(a, calls=None):
    """A loader of rows [lo, hi) of the global array ``a`` (None: none);
    ``calls`` collects the offsets it is called with."""
    if a is None:
        return None

    def load(lo, hi):
        if calls is not None:
            calls.append(lo)
        return a[lo:hi]

    return load


def _reserve(draws):
    """The ``_chunk_reserve`` hook over precomputed draws {offset: draw}
    (the parent computes decomp_tpu's; the ranks import no JAX)."""
    return None if draws is None else (lambda lo, shape: draws[lo])


def nmf_streaming(rank, n, spec, row_axis, arrays, kw, draws=None):
    """``parallel.nmf.solve_streaming`` over loaders of the global numpy
    arrays 'y' and 'mask' (global offsets); 'd' and 'x' as given. Also
    returns the offsets the y loader was called with."""
    mesh = parallel.make_mesh(*spec)
    calls = []
    res = parallel.nmf.solve_streaming(
        _loader(arrays["y"], calls), arrays.get("d"), x=arrays.get("x"),
        mask=_loader(arrays.get("mask")), mesh=mesh, row_axis=row_axis,
        n_samples=arrays["y"].shape[0], n_channels=arrays["y"].shape[1],
        _chunk_reserve=_reserve(draws), **kw)
    return dict(_result(res, mesh, row_axis), calls=calls)


def completion_streaming(rank, n, spec, arrays, kw, draws=None):
    """``nmf.masked_completion_streaming(mesh=...)`` over loaders."""
    from decomp_tpu_torch.models import nmf_streaming as tns

    mesh = parallel.make_mesh(*spec)
    res = tns.masked_completion_streaming(
        _loader(arrays["y"]), _loader(arrays["mask"]), d=arrays.get("d"),
        x=arrays.get("x"), n_samples=arrays["y"].shape[0],
        n_channels=arrays["y"].shape[1], mesh=mesh,
        _chunk_reserve=_reserve(draws), **kw)
    return _result(res, mesh, "rows")


def dl_streaming(rank, n, spec, row_axis, arrays, kw, draws=None):
    """``parallel.dictionary_learning.solve_streaming`` over loaders."""
    mesh = parallel.make_mesh(*spec)
    res = parallel.dictionary_learning.solve_streaming(
        _loader(arrays["y"]), arrays["d"], arrays["alpha"],
        x=arrays.get("x"), mask=_loader(arrays.get("mask")), mesh=mesh,
        row_axis=row_axis, n_samples=arrays["y"].shape[0],
        n_channels=arrays["y"].shape[1], _chunk_reserve=_reserve(draws),
        **kw)
    return _result(res, mesh, row_axis)


def lasso_streaming(rank, n, spec, axis, arrays, kw):
    """``parallel.lasso.solve_streaming`` on the global arrays, which every
    rank passes whole: the whole x and counts as numpy."""
    mesh = parallel.make_mesh(*spec)
    res = parallel.lasso.solve_streaming(
        arrays["y"], arrays["a"], arrays["alpha"], arrays.get("x"),
        mask=arrays.get("mask"), mesh=mesh, axis=axis, **kw)
    return dict(x=res.x, niter=np.asarray(res.niter),
                converged=np.asarray(res.converged))


def checkpointed(rank, n, arrays, directory, chunk, maxiter):
    """``checkpointed_solve`` over ``parallel.nmf.solve``, one snapshot
    file per rank, and the straight sharded run."""
    from decomp_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                   checkpointed_solve)

    mesh = parallel.make_mesh()
    b = _blocks(mesh, "rows", None, arrays)
    mgr = CheckpointManager(f"{directory}/rank{rank}")
    res, total = checkpointed_solve(
        parallel.nmf.solve, b["y"], manager=mgr, chunk_iters=chunk,
        maxiter=maxiter, tol=0.0, d=b["d"], x=b["x"], mesh=mesh)
    straight = parallel.nmf.solve(b["y"], b["d"], x=b["x"], tol=0.0,
                                  maxiter=maxiter, mesh=mesh)
    return (total, torch.equal(res.d, straight.d),
            torch.equal(res.x, straight.x))


def aot_nmf(rank, n, spec, row_axis, arrays, kw):
    """``parallel.nmf.solve`` on the rank's rows, live and through an
    artifact (``utils.aot``: export, serialize, load, call). ``spec``
    "multislice" builds ``make_multislice_mesh(n_slices=2)``. Returns the
    artifact's result, whether it equals the live one bit for bit, the
    pinned shape of y, the refusal of the global y, and rank 0's artifact
    bytes."""
    from decomp_tpu_torch.utils import aot

    mesh = (parallel.make_multislice_mesh(n_slices=2) if spec == "multislice"
            else parallel.make_mesh(*spec))
    b = _blocks(mesh, row_axis, None, arrays)
    y, d = b["y"], torch.as_tensor(b["d"])
    kw = dict(kw, mesh=mesh, row_axis=row_axis)
    live = parallel.nmf.solve(y, d, **kw)
    blob = aot.export_solver(parallel.nmf.solve, y, d, **kw).serialize()
    loaded = aot.load_solver(blob)
    res = loaded(y, d)
    try:
        loaded(torch.as_tensor(arrays["y"]), d)
        global_refusal = None
    except DecompError as e:
        global_refusal = str(e)
    return dict(_result(res, mesh, row_axis),
                same=[torch.equal(res.x, live.x), torch.equal(res.d, live.d),
                      res.niter == live.niter,
                      res.converged == live.converged],
                pinned=tuple(loaded.in_avals[0].shape),
                global_refusal=global_refusal,
                blob=blob if rank == 0 else None)


def aot_call(rank, n, blob, y, d):
    """The error that calling the artifact ``blob`` with ``y`` and ``d``
    raises on this rank: (type name, message), or None."""
    from decomp_tpu_torch.utils import aot

    try:
        aot.load_solver(blob)(torch.as_tensor(y), torch.as_tensor(d))
    except DecompError as e:
        return type(e).__name__, str(e)
    return None


def refusal(rank, n, spec, solver, kw, per_rank=None, meta_y=False,
            loaders=()):
    """The error a sharded call raises on this rank: (type name, message),
    or None. ``spec`` None passes a mesh that is no ``DeviceMesh``;
    ``per_rank``: {rank: keywords} that only that rank passes;
    ``meta_y``: y is a tensor on the 'meta' device; ``loaders``: the
    keywords whose arrays go in as loaders."""
    from decomp_tpu_torch.models import nmf as tnmf
    from decomp_tpu_torch.models import nmf_streaming as tns

    mesh = parallel.make_mesh(*spec) if spec is not None else object()
    kw = {**kw, **(per_rank or {}).get(rank, {})}
    if meta_y:
        kw["y"] = torch.empty(kw["y"].shape, device="meta")
    for key in loaders:
        kw[key] = _loader(kw[key])
    fn = {"nmf": parallel.nmf.solve, "lasso": parallel.lasso.solve,
          "dl": parallel.dictionary_learning.solve,
          "completion": tnmf.masked_completion,
          "nmf_streaming": parallel.nmf.solve_streaming,
          "dl_streaming": parallel.dictionary_learning.solve_streaming,
          "lasso_streaming": parallel.lasso.solve_streaming,
          "completion_streaming": tns.masked_completion_streaming}[solver]
    try:
        fn(mesh=mesh, **kw)
    except DecompError as e:
        return type(e).__name__, str(e)
    return None


def meshes(rank, n, rows):
    """Block placement and the meshes: ``shard_rows`` of a global array on
    a flat and a ('slice', 'rows') mesh, and the multi-slice layouts."""
    flat = parallel.make_mesh()
    sliced = parallel.make_multislice_mesh(n_slices=2)
    by_host = parallel.make_multislice_mesh()
    g = np.arange(rows * 6, dtype=np.float32).reshape(rows, 6)
    grid = parallel.make_mesh((2, n // 2), ("rows", "cols"))
    return dict(
        flat=_np(parallel.shard_rows(g, flat)),
        sliced=_np(parallel.shard_rows(g, sliced, ("slice", "rows"))),
        sliced_index=pmesh.axis_index(sliced, ("slice", "rows")),
        sliced_shape=tuple(sliced.mesh.shape),
        sliced_layout=sliced.mesh.tolist(),
        host_shape=tuple(by_host.mesh.shape),
        block=_np(parallel.shard_rows(torch.as_tensor(g), grid, "rows",
                                      "cols")),
        grid=(pmesh.axis_index(grid, "rows"), pmesh.axis_index(grid, "cols")),
        device=str(pmesh.local_device(flat)))


def multislice_refusals(rank, n):
    """The refusals of the mesh builders."""
    out = []
    for call in (lambda: parallel.make_multislice_mesh(n_slices=3),
                 lambda: parallel.make_multislice_mesh(
                     axis_names=("a", "b", "c")),
                 lambda: parallel.make_mesh((3,), ("rows",))):
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(type(e).__name__)
    return out


def fails_on_rank_one(rank, n):
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")
    return rank


def sleeps(rank, n, seconds):
    import time

    time.sleep(seconds)
    return rank


def assemble(outs, key="x", axis=0, by="row"):
    """The global array of the ranks' blocks of ``key``, laid out by their
    ``by`` coordinate along ``axis``; the ranks that share a coordinate
    must hold the same bits."""
    blocks = {}
    for o in outs:
        if o[by] in blocks:
            assert np.array_equal(blocks[o[by]], o[key]), (key, by)
        else:
            blocks[o[by]] = o[key]
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=axis)
