"""Public solver families: ``nmf`` ('mu' and 'kl-mu') and ``lasso``;
dictionary learning follows (ROADMAP Queue 1)."""

from decomp_tpu_torch.models import lasso, nmf

__all__ = ["lasso", "nmf"]
