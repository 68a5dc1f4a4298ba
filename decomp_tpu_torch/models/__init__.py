"""Public solver families: ``nmf`` ('mu' and 'kl-mu'), ``lasso`` and
``dictionary_learning``."""

from decomp_tpu_torch.models import dictionary_learning, lasso, nmf

__all__ = ["dictionary_learning", "lasso", "nmf"]
