"""Solver results: the NamedTuples of ``decomp_tpu.utils.result`` with the
same fields in the same order, holding torch tensors. ``niter`` is a
Python int and ``converged`` a Python bool: the port's loop runs on the
host, so it knows both without a device read."""

from typing import Any, NamedTuple, Optional

import torch


class LassoResult(NamedTuple):
    """Result of a lasso solve."""

    x: torch.Tensor
    niter: Any
    converged: Any
    objective: torch.Tensor
    aux: Optional[Any] = None


class SplitComplex(NamedTuple):
    """A complex array as its real and imaginary parts
    (``decomp_tpu.ops.complex_split.SplitComplex``), here real tensors."""

    re: Any
    im: Any


class NMFResult(NamedTuple):
    """Result of ``decomp_tpu_torch.nmf.solve``."""

    x: torch.Tensor       # activations, shape (n_samples, rank)
    d: torch.Tensor       # dictionary / basis, shape (rank, n_channels)
    niter: int            # iterations actually run
    converged: bool       # tol reached before maxiter
    objective: torch.Tensor  # (maxiter,) NaN-padded if record_objective,
                             # else (0,)
    aux: Optional[Any] = None


class DictionaryLearningResult(NamedTuple):
    """Result of a dictionary-learning solve."""

    x: torch.Tensor
    d: torch.Tensor
    niter: Any
    converged: Any
    objective: torch.Tensor
    aux: Optional[Any] = None
