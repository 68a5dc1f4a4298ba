"""Solver iteration loop (counterpart of ``decomp_tpu.ops.loop``).

PyTorch has no ``lax.while_loop``, so this is a host loop over eager
device work. It keeps the JAX loop's contract exactly: ``niter``,
``converged``, the NaN-padded objective curve, ``check_every`` blocks
whose trip count shrinks near ``maxiter``, ``min_iter``, and the same
``ValueError``s. The host reads the convergence quantity once per check.
A caller whose ``diff_fn`` is nonnegative (a norm ratio) says so with
``diff_nonnegative``: with ``tol <= 0`` its stop test can never fire, so
the loop neither evaluates nor reads it and the device runs ahead of the
host. Any other diff is tested as the JAX loop tests it, at every tol: a
held-out improvement goes negative when the validation error rises.
"""

import math
from typing import Any, Callable, NamedTuple, Optional

import torch


class IterationResult(NamedTuple):
    state: Any              # final solver state
    niter: int              # iterations actually executed
    converged: bool         # diff < tol reached before maxiter
    objective: torch.Tensor  # (maxiter,) objective curve (NaN-padded) or (0,)


def run_iterations(
    step: Callable[[Any, int], Any],
    init_state: Any,
    *,
    tol,
    maxiter: int,
    diff_fn: Callable[[Any, Any], torch.Tensor],
    objective_fn: Optional[Callable[[Any], torch.Tensor]] = None,
    record_objective: bool = False,
    objective_dtype=None,
    check_every: int = 1,
    verbose: bool = False,
    min_iter: int = 0,
    diff_nonnegative: bool = False,
) -> IterationResult:
    """Run ``state <- step(state, it)`` until converged or ``maxiter``.

    step:          (state, iteration index) -> new state.
    tol:           threshold on ``diff_fn(old, new)``, compared in
                   ``diff``'s dtype; 0 runs all ``maxiter`` iterations.
    diff_fn:       (old_state, new_state) -> real scalar tensor.
    objective_fn:  state -> real scalar tensor; evaluated per iteration
                   only when ``record_objective``.
    objective_dtype: dtype of the curve; default the objective's own.
    check_every:   evaluate the criterion every this many iterations;
                   ``diff_fn`` then spans the whole block. ``niter`` stays
                   exact. Requires record_objective=False unless 1.
    verbose:       print the iteration index and diff at every check.
    min_iter:      suppress the convergence verdict before this many
                   iterations have run.
    diff_nonnegative: ``diff_fn`` never returns a negative value, so at
                   ``tol <= 0`` (and not verbose) the stop test is skipped.
    """
    if maxiter < 1:
        raise ValueError(f"maxiter must be >= 1, got {maxiter}")
    if record_objective and objective_fn is None:
        raise ValueError("record_objective=True requires objective_fn")
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if check_every > 1 and record_objective:
        raise ValueError("check_every > 1 is incompatible with "
                         "record_objective")

    tol = float(tol)
    test_diff = tol > 0 or verbose or not diff_nonnegative
    obj = None
    it, converged, state = 0, False, init_state
    while it < maxiter and not converged:
        n_steps = min(check_every, maxiter - it)
        new_state = state
        for j in range(n_steps):
            new_state = step(new_state, it + j)
        if test_diff:
            diff = diff_fn(state, new_state)
            converged = bool(diff < torch.tensor(tol, dtype=diff.dtype,
                                                 device=diff.device))
            if min_iter > 0:
                converged = converged and it + n_steps >= min_iter
            if verbose:
                print(f"iter {it + n_steps}: diff={float(diff)}")
        if record_objective:
            val = objective_fn(new_state)
            if obj is None:
                obj = torch.full((maxiter,), math.nan,
                                 dtype=objective_dtype or val.dtype,
                                 device=val.device)
            obj[it] = val
        it += n_steps
        state = new_state
    if obj is None:
        obj = torch.zeros((0,), dtype=objective_dtype or torch.float32)
    return IterationResult(state=state, niter=it, converged=converged,
                           objective=obj)
