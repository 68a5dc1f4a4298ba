"""Public solver families. Only ``nmf`` ('mu' and 'kl-mu') is ported so
far; lasso and dictionary learning follow (ROADMAP Queue 1)."""

from decomp_tpu_torch.models import nmf

__all__ = ["nmf"]
