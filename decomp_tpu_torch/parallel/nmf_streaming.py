"""Sharded out-of-core NMF over ``torch.distributed`` (counterpart of
``decomp_tpu.parallel.nmf_streaming``): data larger than every card's
memory, its rows split over the ranks of ``row_axis`` and each rank's rows
streamed in chunks.

Each rank runs loader mode's epoch (``models.nmf_streaming._loader_solve``)
over its own chunks. The loader is called with global row offsets (the
rank's first row plus the chunk's), x stays on the rank's device, and each
chunk goes through its ``ops.cuda_mu`` kernel where the gate engages. Once
an epoch the d statistics, with the objective and the validation sums, are
all-reduced in one buffer before the d update, which then runs on every
rank on the same sums: d has the same bits everywhere, and every stopping
test reads d or an all-reduced sum, so the ranks stop together.

The grid is ``decomp_tpu``'s: every rank ``ceil(n_samples / (ranks x
chunk_rows))`` chunks; a chunk reaching past n_samples reads a clamped
window with the rows past the data zeroed, and a rank wholly past the data
streams all-zero chunks. The held-out reserve of a chunk is keyed by its
global offset, so a rank reserves exactly what one process reserves for
the same chunks.
"""

from typing import Callable, Optional

import numpy as np
import torch

from decomp_tpu_torch.models import nmf_streaming as _ns
from decomp_tpu_torch.parallel import mesh as _mesh
from decomp_tpu_torch.utils import assertion
from decomp_tpu_torch.utils.dtypes import acc_dtype
from decomp_tpu_torch.utils.exceptions import DecompError
from decomp_tpu_torch.utils.result import NMFResult


def solve_streaming(
    y,
    d=None,
    *,
    rank: Optional[int] = None,
    x=None,
    mesh,
    row_axis="rows",
    tol=1e-4,
    maxiter: int = 100,
    method: str = "mu",
    mask=None,
    chunk_rows: int = 65536,
    random_seed: int = 0,
    eps: float = 1e-15,
    precision: str = "highest",
    factor_dtype=None,
    inner_iter: int = 1,
    callback: Optional[Callable] = None,
    n_samples: Optional[int] = None,
    n_channels: Optional[int] = None,
    dtype=None,
    record_objective: bool = False,
    use_kernel="auto",
    kernel_block_rows: Optional[int] = None,
    hbm_cache_chunks: int = 0,
    stop: str = "rel_change",
    heldout_frac: float = 0.05,
    check_every: int = 5,
    _chunk_reserve=None,
) -> NMFResult:
    """Sharded out-of-core ``y ≈ x @ d`` with nonnegative factors. Every
    rank of the process group calls it with the same arguments.

    ``y`` is a loader ``(lo, hi) -> rows`` taking GLOBAL row offsets (numpy
    or a tensor on any device; each rank calls it for its own chunks only),
    with ``n_samples``, ``n_channels`` and ``dtype`` (a ``torch.dtype``);
    ``mask`` likewise. Host arrays are refused: ``nmf.solve_streaming``
    streams them in one process. ``row_axis``: one mesh dim name or a
    tuple of them (see ``parallel.mesh``). Other parameters as in
    ``nmf.solve_streaming``'s loader mode: ``use_kernel`` and
    ``kernel_block_rows`` for the chunk kernels, ``stop='heldout'``,
    ``check_every``, ``record_objective``, ``inner_iter``,
    ``factor_dtype``, and ``hbm_cache_chunks``, the first this many chunks
    of EACH RANK's rows kept on its device.

    x : warm start, the global x (a host array, or a tensor on the host or
        on the rank's device) with ``n_samples`` rows or the grid's padded
        count; each rank copies its rows.
    random_seed : without ``d``, d is ``scale * rng.uniform`` from
        ``np.random.default_rng(random_seed)``, the same on every rank,
        with ``scale`` from the observed mean of the head chunk ``y(0,
        chunk_rows)``; without ``x``, each rank draws its rows from a
        ``torch.Generator`` seeded by ``random_seed`` and its row
        coordinate, at the same scale.

    Returns NMFResult: ``d``, ``niter``, ``converged``, ``objective`` and
    ``aux['heldout_rel_err']`` are global and the same on every rank;
    ``x`` holds the rank's rows inside the data, ``[row0, min(row0 +
    n_local, n_samples))`` (empty on a rank wholly past them), so that the
    blocks in rank order are the global x. An invalid argument raises
    ``DecompError`` on every rank.
    """
    dev = _mesh.placement(mesh, None)
    _mesh.require_process_group()
    p = _mesh.checked(lambda: _prepare(
        y, d, rank, x, mesh, row_axis, method, mask, chunk_rows, precision,
        factor_dtype, inner_iter, n_samples, n_channels, dtype, use_kernel,
        kernel_block_rows, stop, heldout_frac, record_objective, dev))
    src, fdt = p["src"], p["fdt"]
    rank, d, x = p["rank"], p["d"], p["x"]
    n_channels = int(n_channels)
    if d is None or x is None:
        scale = _head_scale(src, rank)
    if d is None:
        rng = np.random.default_rng(random_seed)
        d = torch.from_numpy(scale * rng.uniform(size=(rank, n_channels))
                             ).to(device=dev, dtype=fdt)
    if x is None:
        from decomp_tpu_torch.parallel.nmf import _generator

        gen = _generator(random_seed, 1, _mesh.axis_index(mesh, row_axis),
                         dev)
        x = (scale * torch.rand((src.n_chunks * src.chunk_rows, rank),
                                generator=gen, device=dev)).to(fdt)
    reserve = None
    if stop == "heldout":
        reserve = _ns._reserve_fn(_chunk_reserve, random_seed,
                                  float(heldout_frac), dev)
    mixed = p["mixed"]
    acc = acc_dtype(src.dtype)
    eps_t = torch.tensor(eps, dtype=acc if mixed else src.dtype)
    x, d, niter, converged, objs, last_e = _ns._loader_solve(
        src, x, d, reserve, use_k=p["use_k"], block_rows=kernel_block_rows,
        n_cache=max(0, min(int(hbm_cache_chunks), src.n_chunks)),
        maxiter=int(maxiter), tol=float(tol), check_every=check_every,
        callback=callback, record_objective=record_objective, method=method,
        masked=mask is not None, mixed=mixed, eps=float(eps), eps_t=eps_t,
        inner_iter=p["inner_iter"],
        reduce_sum=_mesh.reducer(mesh, row_axis))
    aux = (None if last_e is None else {"heldout_rel_err": torch.tensor(
        float(np.sqrt(last_e)), dtype=torch.float32, device=dev)})
    return NMFResult(x=x, d=d, niter=niter, converged=converged,
                     objective=_ns._curve(objs, maxiter, record_objective,
                                          acc), aux=aux)


def _head_scale(src, rank):
    """The random init's scale from the head chunk ``y(0, chunk_rows)``,
    which every rank loads alike (``decomp_tpu``'s
    ``parallel/nmf_streaming.py:174-194``)."""
    def head(loader):
        return None if loader is None else _ns._load(
            loader, 0, src.chunk_rows, src.device, src.dtype)

    return _ns._init_scale(head(src.y_loader), head(src.mask_loader), rank)


def _prepare(y, d, rank, x, mesh, row_axis, method, mask, chunk_rows,
             precision, factor_dtype, inner_iter, n_samples, n_channels,
             dtype, use_kernel, kernel_block_rows, stop, heldout_frac,
             record_objective, dev):
    """``solve_streaming``'s checks (those of ``nmf.solve_streaming``'s
    loader mode and of ``decomp_tpu``'s sharded streamer), made alike on
    every rank; returns the rank's chunk source, its rows of a warm start,
    d on its device and the kernel gate's verdict."""
    inner_iter = _ns._check_options(method, stop, use_kernel, precision,
                                    inner_iter, kernel_block_rows)
    if not callable(y):
        raise DecompError("the sharded streaming solver requires a callable "
                          "y loader taking global row offsets; "
                          "nmf.solve_streaming streams host arrays in one "
                          "process")
    _ns._check_loaders(mask, n_samples, n_channels, dtype)
    n_dev = _mesh.validate_axis(mesh, row_axis, "row_axis")
    n_samples, n_channels = int(n_samples), int(n_channels)
    chunk_rows = int(chunk_rows)
    if chunk_rows < 1:
        raise DecompError("chunk_rows must be >= 1")
    masked = mask is not None
    _ns._check_loader_mode(chunk_rows, n_samples, stop == "heldout", masked,
                           record_objective, heldout_frac)
    factor_dtype, fdt = _ns._factor_dtypes(factor_dtype, dtype)
    if d is None and rank is None:
        raise DecompError("provide an initial dictionary `d` or a `rank`")
    if d is not None:
        d = _ns._given_d(d, rank, n_channels, dev).to(fdt)
        rank = d.shape[0]
    rank = int(rank)
    row0, n_chunks = _ns.rank_grid(n_samples, chunk_rows, n_dev,
                                   _mesh.axis_index(mesh, row_axis))
    src = _ns._LoaderChunks(y, mask, n_samples, chunk_rows, dev, dtype,
                            row0=row0, n_chunks=n_chunks)
    if x is not None:
        # The true row count, or the padded grid's (a previous solve's x
        # on the same grid).
        n_pad = n_dev * n_chunks * chunk_rows
        assertion.assert_ndim("x", x, 2)
        if x.shape[0] not in (n_samples, n_pad):
            raise DecompError(f"x has {x.shape[0]} rows; expected "
                              f"n_samples={n_samples} (or the padded "
                              f"{n_pad})")
        assertion.assert_axis_size("x", x, 1, rank, "rank")
        x = _ns.rank_rows("x", x, row0, row0 + n_chunks * chunk_rows, dev,
                          fdt)
    mixed = factor_dtype is not None
    use_k = _ns._chunk_kernel_gate(
        use_kernel, on_cuda=dev.type == "cuda", method=method, mixed=mixed,
        record_objective=record_objective, rank=rank, n=n_channels,
        y_dtype=dtype, fdt=fdt, masked=masked, inner_iter=inner_iter)
    return dict(src=src, d=d, x=x, rank=rank, fdt=fdt, mixed=mixed,
                use_k=use_k, inner_iter=inner_iter)
