"""Shared utilities: input validation, where an entry point runs
(``device``), dtype helpers, normalisation, results, the numpy bridge to
``decomp_tpu`` (``convert``), chunked solves with atomic snapshots
(``checkpoint``) and solver artifacts for serving (``aot``)."""

from decomp_tpu_torch.utils import (aot, assertion, checkpoint, convert,
                                    device, dtypes, normalize)
from decomp_tpu_torch.utils.checkpoint import CheckpointManager, checkpointed_solve
from decomp_tpu_torch.utils.exceptions import DecompError, DtypeError, ShapeError
from decomp_tpu_torch.utils.result import (
    DictionaryLearningResult,
    LassoResult,
    NMFResult,
)

__all__ = [
    "aot",
    "assertion",
    "checkpoint",
    "CheckpointManager",
    "checkpointed_solve",
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
