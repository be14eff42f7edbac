"""Streaming model updates: incremental train → surgical invalidate →
epoch-fenced refresh (port of ``fia_tpu/stream/``).

:func:`~fia_tpu_torch.stream.update.apply_updates` is the entry point
(``FIAModel.apply_updates`` delegates here);
:func:`~fia_tpu_torch.stream.footprint.compute_footprint` derives the
touched (user, item) block set an appended interaction batch can reach
through the shared-row Hessian structure — the same read set the factor
bank's per-entry ``dep_crcs`` digest covers.
"""

from fia_tpu_torch.stream.footprint import Footprint, compute_footprint
from fia_tpu_torch.stream.update import (
    UpdateResult,
    apply_updates,
    project_params,
)

__all__ = [
    "Footprint",
    "compute_footprint",
    "UpdateResult",
    "apply_updates",
    "project_params",
]
