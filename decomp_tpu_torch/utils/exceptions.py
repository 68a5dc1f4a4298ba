"""Library-specific exception types, the same three as ``decomp_tpu``."""


class DecompError(ValueError):
    """Base class for decomp_tpu_torch input/usage errors."""


class ShapeError(DecompError):
    """Raised when input tensor shapes are inconsistent."""


class DtypeError(DecompError):
    """Raised when input tensor dtypes are inconsistent or unsupported."""
