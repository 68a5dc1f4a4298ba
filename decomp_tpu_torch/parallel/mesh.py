"""Meshes, row blocks and reductions over ``torch.distributed``
(counterpart of ``decomp_tpu.parallel.mesh``).

A sharded solve runs SPMD: one process per rank, each holding its own block
of the data, launching the port's kernels on that block and all-reducing
the K-sized statistics. The caller starts the processes and initialises the
process group (NCCL on GPUs, one process per GPU; gloo on the CPU); a
``DeviceMesh`` (``torch.distributed.device_mesh``) names its dims, and the
solvers take the names of the dims that shard the rows (``row_axis``) and,
for NMF, the columns (``col_axis``).

Hierarchical (multi-slice) meshes: wherever a solver takes a row axis it
also takes a TUPLE of dim names, e.g. ``('slice', 'rows')``: the sample
dimension then shards over the combined extent of those dims, outermost
first, and each statistic is all-reduced over each named dim's group in
turn, innermost first: the reduction within a host, then the small
exchange between hosts. The two-stage order of the sums differs from a
flat sum, so a stopping rule sitting exactly at a plateau can fire one
check earlier or later than a one-process run; the ranks of one run always
stop together, since the stopping scalar is all-reduced.

Every decision a rank takes on the host (a convergence test, a kernel
route) comes from an all-reduced value or from shapes that are equal by
contract, so that the ranks stay in lockstep: a rank that left a loop
early would leave the others waiting in a collective. ``agree`` makes
argument errors collective for the same reason.
"""

import math
import socket
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from decomp_tpu_torch.utils.exceptions import DecompError

#: An axis argument: one mesh dim name or a tuple of names (hierarchical
#: sharding over their combined extent, outermost first).
AxisSpec = Union[str, Tuple[str, ...]]


def axis_tuple(axis: AxisSpec) -> Tuple[str, ...]:
    """Normalise an axis spec (name or sequence of names) to a tuple;
    anything else raises ``DecompError``."""
    if isinstance(axis, str):
        return (axis,)
    try:
        names = tuple(axis)
    except TypeError:
        raise DecompError(
            f"axis must be a mesh axis name or a sequence of names, "
            f"got {axis!r}") from None
    if not all(isinstance(nm, str) for nm in names):
        raise DecompError(
            f"axis must name mesh axes (strings), got {axis!r}")
    return names


def validate_axis(mesh: DeviceMesh, axis: AxisSpec, what: str = "axis") -> int:
    """Check every name in ``axis`` against ``mesh`` and return the
    combined extent (the product of the named dims' sizes). A tuple axis
    must not repeat a name."""
    names = axis_tuple(axis)
    if len(names) == 0:
        raise DecompError(f"{what} must name at least one mesh axis")
    if len(set(names)) != len(names):
        raise DecompError(f"{what} {axis!r} repeats a mesh axis name")
    dims = mesh.mesh_dim_names or ()
    for name in names:
        if name not in dims:
            raise DecompError(f"{what} {axis!r}: {name!r} not in mesh "
                              f"axes {dims}")
    return math.prod(mesh.size(dims.index(n)) for n in names)


def axis_index(mesh: DeviceMesh, axis: AxisSpec) -> int:
    """The calling rank's coordinate along ``axis``: for a tuple, the
    row-major index over the named dims, outermost first (the order in
    which ``shard_rows`` lays the blocks out)."""
    dims = mesh.mesh_dim_names
    index = 0
    for name in axis_tuple(axis):
        index = (index * mesh.size(dims.index(name))
                 + mesh.get_local_rank(name))
    return index


def local_device(mesh: DeviceMesh) -> torch.device:
    """The device the calling rank's blocks live on: its current CUDA
    device for a 'cuda' mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _device_type():
    """The mesh's device type: 'cuda' where the card is visible."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("rows", "cols")) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the initialised process group,
    ranks laid out in order. Every rank calls it, with the same arguments.

    Default: all ranks along the first ('rows') dim, size-1 trailing dims
    (row sharding is the natural layout of a tall matrix). For a
    multi-slice layout pass e.g. ``shape=(n_slices, ranks_per_slice)``,
    ``axis_names=('slice', 'rows')`` and hand the solvers ``row_axis=
    ('slice', 'rows')``. The mesh is a 'cuda' one where the card is
    visible, else a 'cpu' one.
    """
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not match the world "
                         f"size {world}")
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(axis_names))


def make_multislice_mesh(n_slices: Optional[int] = None,
                         axis_names: Tuple[str, str] = ("slice", "rows")
                         ) -> DeviceMesh:
    """A two-dim mesh for a multi-host run: the outer dim over hosts, the
    inner over each host's ranks, so that every inner group stays on one
    host and the statistics' reduction crosses hosts once.

    By default the ranks are grouped by the host names that an
    ``all_gather_object`` collects (every rank must call this), hosts in
    sorted order and ranks in order within a host; a ragged grouping
    (unequal hosts) raises. ``n_slices`` instead splits the ranks in order
    into that many equal slices (a simulated layout on one host)."""
    if len(axis_names) != 2:
        raise DecompError("make_multislice_mesh uses exactly two axes "
                          "(outer slice axis, inner intra-slice axis); "
                          "build custom layouts with make_mesh")
    world = dist.get_world_size()
    if n_slices is None:
        hosts = [None] * world
        dist.all_gather_object(hosts, socket.gethostname())
        groups = {}
        for rank, host in enumerate(hosts):
            groups.setdefault(host, []).append(rank)
        if len({len(g) for g in groups.values()}) != 1:
            counts = {h: len(g) for h, g in sorted(groups.items())}
            raise DecompError(f"ranks group into unequal slices {counts}; "
                              "pass n_slices to split explicitly")
        ordered = [r for _, g in sorted(groups.items()) for r in g]
        n_slices = len(groups)
    else:
        n_slices = int(n_slices)
        if n_slices < 1 or world % n_slices:
            raise DecompError(f"n_slices={n_slices} does not divide the "
                              f"world size {world}")
        ordered = list(range(world))
    layout = torch.tensor(ordered, dtype=torch.int).reshape(
        n_slices, world // n_slices)
    return DeviceMesh(_device_type(), layout,
                      mesh_dim_names=tuple(axis_names))


def shard_rows(arr, mesh: DeviceMesh, axis: Optional[AxisSpec] = "rows",
               col_axis: Optional[AxisSpec] = None) -> torch.Tensor:
    """The calling rank's block of a global host array or tensor: its rows
    along ``axis`` (one dim name, or a tuple for hierarchical sharding;
    None keeps every row, as for ``d``'s column block) and, with
    ``col_axis``, its columns along that axis, on the rank's device
    (``local_device``). The global row (column) count must divide the
    axis' extent."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr))
    for dim, ax in ((0, axis), (1, col_axis)):
        if ax is None:
            continue
        n = validate_axis(mesh, ax)
        if t.shape[dim] % n:
            raise DecompError(f"dimension {dim} of size {t.shape[dim]} is "
                              f"not divisible by mesh axis {ax!r} of size "
                              f"{n}")
        size = t.shape[dim] // n
        t = t.narrow(dim, axis_index(mesh, ax) * size, size)
    return t.contiguous().to(local_device(mesh))


def reducer(mesh: DeviceMesh, axis: AxisSpec):
    """The sum over ``axis`` of a rank's partial statistic: a function
    that all-reduces a tensor in place over each named dim's process
    group in turn, innermost first, and returns it. The groups are the
    mesh's own (no group is made per call)."""
    names = axis_tuple(axis)
    groups = [mesh.get_group(n) for n in reversed(names)]

    def reduce(t):
        t = t.contiguous()
        for group in groups:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return reduce


def agree(error, signature=None):
    """Make argument checks collective: every rank of the default process
    group passes the error its own checks raised (or None) and a
    ``signature`` of its block (shapes and dtypes, which must be equal on
    every rank), and every rank raises if any rank failed or if the
    signatures differ: the failing rank its own error, the others a
    ``DecompError`` naming it. No rank is left waiting in a collective for
    one that raised. The check spans the whole default process group."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(
        gathered, (None if error is None else
                   f"{type(error).__name__}: {error}", signature))
    failed = [(r, msg) for r, (msg, _) in enumerate(gathered)
              if msg is not None]
    if error is not None:
        raise error
    if failed:
        rank, msg = failed[0]
        raise DecompError(f"rank {rank} refused the arguments: {msg}")
    sigs = [sig for _, sig in gathered]
    if any(sig != sigs[0] for sig in sigs):
        raise DecompError("the ranks' blocks differ (every rank must pass a "
                          f"block of the same shapes and dtypes): {sigs}")


def checked(fn):
    """``fn()``'s result, with its ``ValueError`` (``DecompError``) made
    collective by ``agree``."""
    out, err = None, None
    try:
        out = fn()
    except ValueError as e:
        err = e
    agree(err)
    return out


def require_process_group():
    """Refuse a sharded call outside an initialised process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise DecompError("sharded solves need an initialised process group "
                          "(torch.distributed.init_process_group), one "
                          "process per rank")


def placement(mesh, y) -> torch.device:
    """The calling rank's device (``local_device``) for its data ``y`` on
    ``mesh``, refusing a mesh that is not a ``DeviceMesh`` and one whose
    device type is not that of a tensor ``y`` (a tensor is never moved)."""
    if not isinstance(mesh, DeviceMesh):
        raise DecompError(f"mesh must be a torch DeviceMesh, got "
                          f"{type(mesh).__name__}")
    if isinstance(y, torch.Tensor) and mesh.device_type != y.device.type:
        raise DecompError(f"the mesh's device type is {mesh.device_type!r} "
                          f"but y is on {y.device}")
    return local_device(mesh)
