"""Compute building blocks: the solver loop, soft-thresholding, the
spectral-norm estimate, and the MU / KL-MU, lasso and dictionary-learning
kernels with their plain twins. Importing this package builds nothing: a
kernel is compiled on its first launch on a CUDA tensor."""

from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu
from decomp_tpu_torch.ops.loop import IterationResult, run_iterations
from decomp_tpu_torch.ops.soft_threshold import soft_threshold
from decomp_tpu_torch.ops.spectral import lipschitz_gram, spectral_norm_psd

__all__ = ["cuda_dl", "cuda_lasso", "cuda_mu", "run_iterations",
           "IterationResult", "soft_threshold", "spectral_norm_psd",
           "lipschitz_gram"]
