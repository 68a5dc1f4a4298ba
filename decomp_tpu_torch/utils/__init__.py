"""Shared utilities: input validation, where an entry point runs
(``device``), dtype helpers, normalisation, results, and the numpy bridge
to ``decomp_tpu``. ``checkpoint`` is not ported yet (ROADMAP Queue 1)."""

from decomp_tpu_torch.utils import assertion, convert, device, dtypes, normalize
from decomp_tpu_torch.utils.exceptions import DecompError, DtypeError, ShapeError
from decomp_tpu_torch.utils.result import (
    DictionaryLearningResult,
    LassoResult,
    NMFResult,
)

__all__ = [
    "assertion",
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
