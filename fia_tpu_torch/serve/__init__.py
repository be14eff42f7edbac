"""Online influence-query serving (port of ``fia_tpu/serve/``).

The offline drivers (``cli/rq1.py``, ``cli/rq2.py``) answer influence
queries in one-shot experiment sweeps; this package turns the engine
into a *service*: a stream of ``(user, item)`` requests answered under
a latency budget, with micro-batching into one flat dispatch a batch (one
captured CUDA graph a geometry on the card), a hot-block cache over
per-query iHVP results, and admission control so overload sheds load
deterministically instead of running out of memory.

Layers (each its own module, composable without the service):

- :mod:`fia_tpu_torch.serve.request`   — request/response records.
- :mod:`fia_tpu_torch.serve.cache`     — bounded in-memory hot-block LRU
  and the verified on-disk tier beneath it (reliability/artifacts.py).
- :mod:`fia_tpu_torch.serve.scheduler` — the micro-batching planner.
- :mod:`fia_tpu_torch.serve.admission` — queue-depth/deadline admission.
- :mod:`fia_tpu_torch.serve.health`    — the brownout ladder
  (``full → bank_preferred → cache_only``) and its hysteresis.
- :mod:`fia_tpu_torch.serve.metrics`   — per-request JSONL events +
  rollups, in the reference's schema.
- :mod:`fia_tpu_torch.serve.service`   — :class:`InfluenceService`, the
  event loop tying the above to an :class:`InfluenceEngine`.
- :mod:`fia_tpu_torch.serve.hostshard` — the journal-sharded dispatch
  of host roles (``ServeConfig.host_role``).

The service serves over a device mesh, row-sharded tables and meshes
that span processes included, shrinks it on device loss by a slot and on
host loss by a whole host, and splits a drain's dispatch across host
roles through verified journals (docs/design.md §25).
"""

from fia_tpu_torch.serve.admission import (  # noqa: F401
    DEFAULT_CLASS_QUOTAS,
    REASON_DEADLINE,
    REASON_DEGRADED,
    REASON_INVALID,
    REASON_OVERLOAD,
    AdmissionController,
)
from fia_tpu_torch.serve.cache import CacheStats, HotBlockCache  # noqa: F401
from fia_tpu_torch.serve.health import (  # noqa: F401
    MODE_BANK_PREFERRED,
    MODE_CACHE_ONLY,
    MODE_FULL,
    HealthConfig,
    HealthController,
)
from fia_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from fia_tpu_torch.serve.request import (  # noqa: F401
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    CLASS_SCAVENGER,
    CLASSES,
    DEFAULT_CLASS,
    Request,
    Response,
)
from fia_tpu_torch.serve.scheduler import (  # noqa: F401
    CLASS_WEIGHTS,
    FairScheduler,
    MicroBatcher,
)
from fia_tpu_torch.serve.service import InfluenceService, ServeConfig  # noqa: F401
