"""Normalisation helpers (counterpart of ``decomp_tpu.utils.normalize``)."""

import torch

from decomp_tpu_torch.utils.dtypes import real_dtype


def l2_norm(x, axis=None, keepdims=False):
    """Real L2 norm, complex-safe (sums |x|^2, returns the real dtype)."""
    sq = (x * x.conj()).real if x.is_complex() else x * x
    if axis is None:
        s = torch.sum(sq)
        if keepdims:
            s = s.reshape((1,) * x.dim())
    else:
        s = torch.sum(sq, dim=axis, keepdim=keepdims)
    return torch.sqrt(s)


def l2_normalize(x, axis=-1, eps=None):
    """Scale ``x`` to unit L2 norm along ``axis`` (zero-safe): rows with
    zero norm are left unchanged."""
    rdt = real_dtype(x.dtype)
    if eps is None:
        eps = torch.finfo(rdt).tiny
    norms = l2_norm(x, axis=axis, keepdims=True)
    return x / torch.clamp(norms, min=eps).to(rdt)
