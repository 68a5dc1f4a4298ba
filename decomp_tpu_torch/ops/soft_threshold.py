"""Soft-thresholding, the proximal operator of the L1 norm (counterpart of
``decomp_tpu.ops.soft_threshold``)."""

import torch


def soft_threshold(x, thresh):
    """prox_{thresh * ||.||_1}(x), elementwise.

    For real x:    sign(x) * max(|x| - thresh, 0)
    For complex x: (x / |x|) * max(|x| - thresh, 0)   (0 at x == 0)

    ``thresh`` is a nonnegative real scalar or tensor broadcastable to ``x``.
    """
    if x.is_complex():
        mag = torch.abs(x)
        shrunk = torch.clamp(mag - thresh, min=0)
        # x / mag is the unit phase; guard the 0/0 at x == 0 (shrunk is 0
        # there).
        safe_mag = torch.where(mag > 0, mag, torch.ones_like(mag))
        return x * (shrunk / safe_mag).to(mag.dtype)
    return torch.sign(x) * torch.clamp(torch.abs(x) - thresh, min=0)
