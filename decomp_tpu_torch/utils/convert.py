"""Carry solver state between ``decomp_tpu`` (JAX) and this package.

A JAX solve's factors warm-start the port, and the port's factors go
back, as numpy arrays: ``from_numpy(np_tree, device)`` and
``to_numpy(torch_tree)``. A tree is an array, a scalar, None, or a
tuple, list, dict or NamedTuple of trees. A NamedTuple whose class name
matches one of this package's result types (``NMFResult`` from the JAX
side, say) becomes that type; any other keeps its own class.

The caller converts JAX arrays with ``np.asarray`` (or hands them over
as they are: anything ``np.asarray`` accepts converts), so this module
never imports JAX. ``lasso_resume`` turns a ``decomp_tpu`` lasso result
into the warm start and ``state=`` that continue its trajectory here, and
``batch_indices`` takes the rows a ``decomp_tpu`` minibatch solve drew, for
the private ``_solve(batch_idx=)`` hooks of ``nmf`` and
``dictionary_learning``.
"""

import numpy as np
import torch

from decomp_tpu_torch.utils import result as _result

_PORT_TYPES = {
    "NMFResult": _result.NMFResult,
    "LassoResult": _result.LassoResult,
    "DictionaryLearningResult": _result.DictionaryLearningResult,
}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _map(fn, tree, leaf_types):
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, leaf_types):
        return fn(tree)
    if _is_namedtuple(tree):
        cls = _PORT_TYPES.get(type(tree).__name__, type(tree))
        return cls(*(_map(fn, v, leaf_types) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, leaf_types) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, leaf_types) for k, v in tree.items()}
    # Anything else array-like (a JAX array, a numpy scalar).
    return fn(tree)


def _array_to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.dtype.is_floating_point:
        t = t.to(dtype)
    return t.to(device)


def from_numpy(tree, device, dtype=None):
    """numpy (or array-like) leaves -> tensors on ``device``. ``dtype``,
    when given, applies to floating leaves only (``niter`` stays an
    integer)."""
    return _map(lambda a: _array_to_tensor(a, device, dtype), tree,
                (np.ndarray, np.generic))


def _tensor_to_array(t):
    if not isinstance(t, torch.Tensor):   # already a host array
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16; the f32 widening is exact.
        t = t.float()
    return t.cpu().numpy()


def to_numpy(tree):
    """Tensor leaves -> numpy arrays on the host (bf16 widens to f32);
    array-like leaves become numpy arrays as they are."""
    return _map(_tensor_to_array, tree, (torch.Tensor,))


def lasso_resume(result, device, dtype=None):
    """``(x, state)`` that resume the lasso solve ``result`` (a
    ``decomp_tpu`` ``LassoResult``, or any with array-like fields) where it
    stopped, on ``device``:
    ``lasso.solve(y, a, alpha, x, state=state, ...)``. ``state`` holds the
    momentum pair ``aux["z"]``, ``aux["t"]`` when the result has one, and,
    for a ``per_problem`` result, its per-row ``converged`` and ``niter``
    as ``"done"`` and ``"niter"``; it is None when there is neither. A
    ``per_problem`` resume must pass ``per_problem=True`` again."""
    res = from_numpy(result, device, dtype)
    state = {}
    if res.aux is not None:
        state["z"], state["t"] = res.aux["z"], res.aux["t"]
    if torch.as_tensor(res.converged).dim() == 1:
        state["done"], state["niter"] = res.converged, res.niter
    return res.x, state or None


def batch_indices(draws, device, n_samples=None):
    """The minibatch rows of each iteration, ``draws`` (maxiter, minibatch)
    array-like (e.g. ``np.stack`` of ``decomp_tpu``'s per-iteration
    ``jax.random.randint`` draws), as an int64 tensor on ``device`` for
    ``_solve(batch_idx=)``. With ``n_samples``, every row must lie in
    [0, n_samples)."""
    idx = np.asarray(draws)
    if idx.ndim != 2 or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError("draws must be a (maxiter, minibatch) integer "
                         f"array, got {idx.dtype} of shape {idx.shape}")
    if n_samples is not None and idx.size and (
            idx.min() < 0 or idx.max() >= n_samples):
        raise ValueError(f"draws must lie in [0, {n_samples})")
    return torch.from_numpy(idx.astype(np.int64)).to(device)
