"""Sharded solvers over ``torch.distributed`` (counterpart of
``decomp_tpu.parallel``): NMF, batch lasso and dictionary learning with the
sample axis (and, for in-core NMF, the channel axis) split over the ranks
of a ``DeviceMesh``, one process per rank. Each rank runs the port's
kernels on its own block and all-reduces the K-sized statistics; see
``parallel.mesh``. Out of core, each rank streams its rows in chunks:
``nmf.solve_streaming`` (``parallel.nmf_streaming``) and
``dictionary_learning.solve_streaming`` from loaders that take global row
offsets, and ``lasso.solve_streaming`` from a global host array."""

from decomp_tpu_torch.parallel import (dictionary_learning, lasso, nmf,
                                       nmf_streaming)
from decomp_tpu_torch.parallel.mesh import (
    make_mesh,
    make_multislice_mesh,
    shard_rows,
)

__all__ = ["nmf", "nmf_streaming", "lasso", "dictionary_learning",
           "make_mesh", "make_multislice_mesh", "shard_rows"]
