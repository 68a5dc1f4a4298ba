"""Checkpoint and resume (counterpart of ``decomp_tpu.utils.checkpoint``).

The resume contract is the solvers' warm-start arguments: pass the factors
back in. This module adds persistence for long runs: factor snapshots as
atomic .npz files, and ``checkpointed_solve``, which runs any
``decomp_tpu_torch`` solver in fixed-iteration chunks and snapshots the
warm-start fields between chunks, so that an interrupted run resumes where
it stopped. Results are tensors, often on the card: they reach the host
through ``utils.convert.to_numpy`` (bf16 widens exactly to f32), and the
snapshot's numpy arrays go back in as they are, since the entry points put
host companions on ``y``'s device. The snapshot keys are
``decomp_tpu``'s, so a snapshot written by either package resumes in the
other.
"""

import inspect
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from decomp_tpu_torch.utils.convert import to_numpy
from decomp_tpu_torch.utils.exceptions import DecompError

_STEP_KEY = "__decomp_tpu_step__"
_AUX_PREFIX = "__decomp_tpu_aux_"


class CheckpointManager:
    """Atomic .npz snapshots of a {name: array} state dict at ``path``."""

    def __init__(self, path: str):
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        self.path = str(path)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, step: int, state: Dict[str, np.ndarray]) -> None:
        """Write atomically (tmp file + fsync + rename) so a crash —
        including power loss, not just a killed process — can never
        corrupt the previous snapshot: the tmp file's blocks are forced
        to disk BEFORE the rename, and the directory entry after it."""
        payload = {k: to_numpy(v) for k, v in state.items()}
        payload[_STEP_KEY] = np.asarray(int(step))
        directory = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            try:
                dfd = os.open(directory, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:  # pragma: no cover - fs without dir fsync
                pass
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self) -> Tuple[int, Dict[str, np.ndarray]]:
        with np.load(self.path) as data:
            state = {k: data[k] for k in data.files if k != _STEP_KEY}
            step = int(data[_STEP_KEY])
        return step, state


def checkpointed_solve(
    solve_fn: Callable,
    *args,
    manager: CheckpointManager,
    chunk_iters: int = 100,
    maxiter: int = 1000,
    warm_fields: Optional[Sequence[str]] = None,
    **kwargs,
):
    """Run ``solve_fn`` in chunks of ``chunk_iters``, checkpointing between.

    ``solve_fn`` is any ``decomp_tpu_torch`` ``solve`` (nmf / lasso /
    dictionary_learning); ``warm_fields`` names
    the result fields that are both returned and accepted as warm-start
    kwargs (the reference's resume contract); the default (``None``)
    derives them per solver — each of ``x`` / ``d`` is threaded when the
    result carries it AND ``solve_fn`` accepts it as a keyword — so
    lasso (no ``d`` in its result) works without spelling
    ``warm_fields=("x",)``. If the manager's file exists, the run
    resumes from it: completed iterations count against ``maxiter``.

    Chunking is exact for solvers whose state is exactly the warm-start
    fields (MU-NMF, ISTA, coordinate descent). Momentum methods (FISTA /
    acc_ista) are ALSO exact when ``solve_fn`` supports the
    ``return_state``/``momentum_state`` contract (``lasso.solve``):
    the (z, t) acceleration state is checkpointed alongside the factors
    and threaded between chunks, so the chunked run reproduces the
    uninterrupted trajectory bit-for-bit. With ``per_problem=True`` and a
    solver exposing the ``state=`` dict (``lasso.solve``), the
    per-row converged mask and iteration counts are checkpointed too:
    resumed rows stay frozen, the returned per-row ``niter`` is
    CUMULATIVE across chunks, and each chunk charges the budget by the
    loop iterations it actually executed (the largest per-row increment),
    so a chunked per-problem run equals the uninterrupted one row-for-row.
    Solvers without these
    contracts restart acceleration (and per-row freezing) at each chunk
    boundary — still convergent, marginally slower.

    Returns (last_result, total_iterations_run_across_all_sessions).
    """
    if chunk_iters < 1:
        raise ValueError("chunk_iters must be >= 1")
    total = 0
    warm: Dict[str, np.ndarray] = {}
    aux: Dict[str, np.ndarray] = {}
    if manager.exists():
        total, state = manager.load()
        warm = {k: v for k, v in state.items()
                if not k.startswith(_AUX_PREFIX)}
        aux = {k[len(_AUX_PREFIX):]: v for k, v in state.items()
               if k.startswith(_AUX_PREFIX)}

    try:
        sig = inspect.signature(solve_fn)
        params = sig.parameters
    except (TypeError, ValueError):  # pragma: no cover - exotic callables
        sig = None
        params = {}
    auto_warm = warm_fields is None
    if auto_warm:
        # Auto: thread each factor the solver both returns and accepts.
        # Acceptance is judged from the signature; with an inscrutable
        # signature fall back to the historical ("x", "d") and let the
        # per-chunk hasattr filter below prune.
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
        warm_fields = tuple(f for f in ("x", "d")
                            if not params or f in params or has_var_kw)
        # A factor supplied POSITIONALLY (e.g. dictionary learning's d)
        # cannot also be injected as a warm kwarg; catch it here with a
        # usable message instead of a TypeError on the second chunk.
        if sig is not None:
            try:
                taken = sig.bind_partial(*args).arguments
            except TypeError:  # pragma: no cover - mismatched call
                taken = {}
            clash = [f for f in warm_fields if f in taken]
            if clash:
                raise DecompError(
                    f"checkpointed_solve needs to re-inject {clash} as "
                    "keyword arguments between chunks; pass them as "
                    "keywords (e.g. d=d0) instead of positionally")
    per_problem = bool(kwargs.get("per_problem"))
    supports_state_kw = "state" in params and "state" not in kwargs
    return_state_ok = ("return_state" in params
                       and "return_state" not in kwargs)
    momentum_resume = return_state_ok and not per_problem
    pp_resume = per_problem and supports_state_kw

    result = None
    prev_nit = np.asarray(aux["niter"]) if (pp_resume and "niter" in aux) \
        else None
    while total < maxiter:
        it = min(chunk_iters, maxiter - total)
        call_kwargs = dict(kwargs)
        call_kwargs.update(warm)
        if momentum_resume:
            call_kwargs["return_state"] = True
            if aux and "x" in warm:
                call_kwargs["momentum_state"] = (aux["z"], aux["t"])
        elif pp_resume:
            if return_state_ok:
                call_kwargs["return_state"] = True
            if aux and "x" in warm and "niter" in aux:
                st = {"done": aux["done"], "niter": aux["niter"]}
                if "z" in aux:
                    st["z"] = aux["z"]
                    st["t"] = aux["t"]
                call_kwargs["state"] = st
        result = solve_fn(*args, maxiter=it, **call_kwargs)
        if pp_resume:
            # Budget = loop iterations this chunk actually executed = the
            # largest per-row increment of the (cumulative) counts.
            nit_after = to_numpy(result.niter)
            base = prev_nit if prev_nit is not None else 0
            total += int(np.max(nit_after - base))
            prev_nit = nit_after
        else:
            # per_problem without state support: the chunk's budget is
            # the slowest row's count (rows restart their freeze).
            total += int(np.max(to_numpy(result.niter)))
        warm = {f: to_numpy(getattr(result, f))
                for f in warm_fields if not auto_warm or hasattr(result, f)}
        res_aux = getattr(result, "aux", None)
        aux = ({k: to_numpy(v) for k, v in res_aux.items()}
               if res_aux is not None else {})
        if pp_resume:
            aux["done"] = to_numpy(result.converged)
            aux["niter"] = to_numpy(result.niter)
        manager.save(total, {**warm,
                             **{_AUX_PREFIX + k: v for k, v in aux.items()}})
        if bool(np.all(to_numpy(result.converged))):
            break
    if result is None:
        raise RuntimeError(
            f"checkpoint at {manager.path} already holds {total} >= "
            f"maxiter={maxiter} iterations; raise maxiter to continue, or "
            "read the factors directly via manager.load()")
    return result, total
