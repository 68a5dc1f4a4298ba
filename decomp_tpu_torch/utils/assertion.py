"""Host-side input validation (counterpart of ``decomp_tpu.utils.assertion``).

These run before any device work, so they raise rich Python exceptions
with the offending shapes and dtypes in the message.
"""

import torch

from decomp_tpu_torch.utils.exceptions import DtypeError, ShapeError


def _shape(arr):
    return tuple(arr.shape)


def assert_ndim(name: str, arr, ndims) -> None:
    if isinstance(ndims, int):
        ndims = (ndims,)
    if len(_shape(arr)) not in ndims:
        raise ShapeError(
            f"{name} must have ndim in {tuple(ndims)}, got "
            f"ndim={len(_shape(arr))} (shape {_shape(arr)})"
        )


def assert_axis_size(name: str, arr, axis: int, size: int,
                     size_name: str) -> None:
    actual = _shape(arr)[axis]
    if actual != size:
        raise ShapeError(
            f"{name}.shape[{axis}] must equal {size_name}={size}, got "
            f"{actual} (shape {_shape(arr)})"
        )


def assert_same_shape(name_a: str, a, name_b: str, b) -> None:
    if _shape(a) != _shape(b):
        raise ShapeError(
            f"{name_a} (shape {_shape(a)}) and {name_b} (shape {_shape(b)}) "
            "must have identical shapes"
        )


def assert_inexact(name: str, arr) -> None:
    if not (arr.dtype.is_floating_point or arr.dtype.is_complex):
        raise DtypeError(
            f"{name} must be floating or complex, got dtype {arr.dtype}")


def assert_real(name: str, arr) -> None:
    if arr.dtype.is_complex:
        raise DtypeError(f"{name} must be real-valued, got dtype {arr.dtype}")


def assert_nonnegative(name: str, value) -> None:
    """Check value (scalar or tensor) is >= 0."""
    if not bool(torch.all(torch.as_tensor(value) >= 0)):
        raise DtypeError(f"{name} must be >= 0, got {value}")
