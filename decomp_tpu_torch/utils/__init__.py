"""Shared utilities: input validation, where an entry point runs
(``device``), dtype helpers, normalisation, results, the numpy bridge to
``decomp_tpu`` (``convert``) and chunked solves with atomic snapshots
(``checkpoint``)."""

from decomp_tpu_torch.utils import (assertion, checkpoint, convert, device,
                                    dtypes, normalize)
from decomp_tpu_torch.utils.exceptions import DecompError, DtypeError, ShapeError
from decomp_tpu_torch.utils.result import (
    DictionaryLearningResult,
    LassoResult,
    NMFResult,
)

__all__ = [
    "assertion",
    "checkpoint",
    "convert",
    "device",
    "dtypes",
    "normalize",
    "DecompError",
    "DtypeError",
    "ShapeError",
    "LassoResult",
    "NMFResult",
    "DictionaryLearningResult",
]
