"""decomp_tpu_torch — the PyTorch / CUDA port of ``decomp_tpu``.

It mirrors ``decomp_tpu``'s layout (``models/``, ``ops/``, ``utils/``) and
``solve()`` surface; its CUDA kernels live in ``csrc/`` and are built for
Hopper (``sm_90a``) on first use. Ported so far: dense multiplicative-update
NMF (``nmf.solve``, method 'mu', full batch, with ``inner_iter`` and mixed
precision), whose x update and d statistics run in the hand-written
kernel ``ops.cuda_mu.mu_stats_dense`` on a CUDA tensor. ``decomp_tpu``
(JAX) stays the reference the port is tested against; this package never
imports JAX.
"""

from decomp_tpu_torch.models import nmf
from decomp_tpu_torch.utils.result import NMFResult

__version__ = "0.1.0"

__all__ = ["nmf", "NMFResult"]
