"""decomp_tpu_torch — the PyTorch / CUDA port of ``decomp_tpu``.

It mirrors ``decomp_tpu``'s layout (``models/``, ``ops/``, ``utils/``) and
``solve()`` surface; its CUDA kernels live in ``csrc/`` and are built for
Hopper (``sm_90a``) on first use. Ported so far:
- NMF (``nmf.solve``: methods 'mu' and 'kl-mu', full batch or minibatch,
  dense or masked, with ``inner_iter``, mixed precision and held-out
  stopping, and 'hals', dense full batch; the ``nmf.masked_completion``
  preset), whose full-batch MU and KL x update and d statistics run in the
  hand-written kernels of ``ops.cuda_mu``;
- batch lasso (``lasso.solve``, methods 'ista', 'fista', 'acc_ista',
  'parallel_cd' and 'cd', masked or not, global or per-problem stopping,
  exact resume; ``lasso.solve_streaming``), whose per-problem solve and
  masked gradient run in the hand-written kernels of ``ops.cuda_lasso``;
- dictionary learning (``dictionary_learning.solve``, full batch or
  minibatch, masked or not, held-out stopping, native complex), whose
  dictionary updates run in the hand-written kernels of ``ops.cuda_dl``;
- chunked solves with atomic snapshots (``utils.checkpoint``), whose
  snapshots pass between this package and ``decomp_tpu``;
- out-of-core NMF, masked completion and dictionary learning
  (``nmf.solve_streaming``, ``nmf.masked_completion_streaming``,
  ``dictionary_learning.solve_streaming``), which stream row chunks of
  host arrays or loaders through the card's kernels;
- the sharded solvers (``parallel``: ``nmf.solve``, ``lasso.solve`` and
  ``dictionary_learning.solve`` over a ``torch.distributed`` device mesh,
  one process per rank, and ``nmf.masked_completion(mesh=...)``; out of
  core, ``nmf.solve_streaming``, ``lasso.solve_streaming``,
  ``dictionary_learning.solve_streaming`` and
  ``nmf.masked_completion_streaming(mesh=...)``), which run those kernels
  on each rank's block or chunks and all-reduce the statistics;
- solver artifacts for serving (``utils.aot``): a solve with its inputs
  pinned and its configuration baked, carrying the built ``sm_90a``
  libraries that it launches, so that a serving process needs no
  ``nvcc``.
An entry point runs on the card unless the caller asks for the CPU: a
tensor stays on its device, and host arrays go to ``device=`` or, by
default, the CUDA device (``utils.device``). ``decomp_tpu`` (JAX) stays the
reference the port is tested against; this package never imports JAX.
"""

from decomp_tpu_torch import parallel
from decomp_tpu_torch.models import dictionary_learning, lasso, nmf
from decomp_tpu_torch.utils.result import (DictionaryLearningResult,
                                           LassoResult, NMFResult,
                                           SplitComplex)

__version__ = "0.1.0"

__all__ = ["dictionary_learning", "lasso", "nmf", "parallel",
           "SplitComplex", "DictionaryLearningResult",
           "LassoResult", "NMFResult"]
