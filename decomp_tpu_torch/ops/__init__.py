"""Compute building blocks: the solver loop and the dense MU kernel with
its plain twin. Importing this package builds nothing: the kernel is
compiled on its first launch on a CUDA tensor."""

from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.ops.loop import IterationResult, run_iterations

__all__ = ["cuda_mu", "run_iterations", "IterationResult"]
