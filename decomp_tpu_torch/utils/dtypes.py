"""Dtype helpers for ``torch.dtype`` (counterpart of ``decomp_tpu.utils.dtypes``)."""

import torch

_COMPLEX_TO_REAL = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype underlying ``dtype`` (complex64 -> float32, etc.).

    Used for thresholds, norms and convergence tolerances, which are real
    quantities even for complex problems.
    """
    return _COMPLEX_TO_REAL.get(dtype, dtype)


def is_complex(x_or_dtype) -> bool:
    dtype = getattr(x_or_dtype, "dtype", x_or_dtype)
    return dtype.is_complex


def result_real_dtype(*tensors) -> torch.dtype:
    """Common real dtype for scalar results derived from ``tensors``."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return real_dtype(dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The >= f32 dtype that norms and objectives accumulate in: sums of
    bf16 values over a large matrix are rounding noise."""
    return torch.promote_types(torch.float32, real_dtype(dtype))


def eps_for(dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """A small positive constant of the right real dtype."""
    rdt = real_dtype(dtype)
    return torch.tensor(torch.finfo(rdt).eps * scale, dtype=rdt)
