"""Compute building blocks: the solver loop and the MU / KL-MU kernels
with their plain twins. Importing this package builds nothing: a kernel
is compiled on its first launch on a CUDA tensor."""

from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.ops.loop import IterationResult, run_iterations

__all__ = ["cuda_mu", "run_iterations", "IterationResult"]
