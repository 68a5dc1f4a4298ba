"""Sharded solvers over ``torch.distributed`` (counterpart of
``decomp_tpu.parallel``): NMF, batch lasso and dictionary learning with the
sample axis (and, for NMF, the channel axis) split over the ranks of a
``DeviceMesh``, one process per rank. Each rank runs the port's kernels on
its own block and all-reduces the K-sized statistics; see
``parallel.mesh``."""

from decomp_tpu_torch.parallel import dictionary_learning, lasso, nmf
from decomp_tpu_torch.parallel.mesh import (
    make_mesh,
    make_multislice_mesh,
    shard_rows,
)

__all__ = ["nmf", "lasso", "dictionary_learning", "make_mesh",
           "make_multislice_mesh", "shard_rows"]
