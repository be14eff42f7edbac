"""Request/response records for the serving layer (copy of
``fia_tpu/serve/request.py``: the same names, fields and JSON keys).

A :class:`Request` is one ``(user, item)`` influence query plus its
serving metadata (id, arrival time, optional per-request deadline). A
:class:`Response` carries the answer — the unpadded related-row scores
and the iHVP/test-grad block vectors — or a taxonomy-classified
rejection, plus the per-request latency breakdown the metrics layer
logs (queue wait, solve time, cache tier, batch placement).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Cache tiers a response can be served from. ``compute`` = this request
# triggered (or rode) a device dispatch this drain; ``hot`` = in-memory
# LRU hit (including duplicates coalesced within one drain); ``disk`` =
# verified on-disk entry promoted into the hot tier; ``precomputed`` =
# the dispatch was an O(1) factor-bank hit (solver='precomputed'):
# device work happened, but it was one triangular-solve/matvec against
# the preloaded bank rather than a from-scratch ladder solve.
TIER_COMPUTE = "compute"
TIER_HOT = "hot"
TIER_DISK = "disk"
TIER_PRECOMPUTED = "precomputed"

STATUS_OK = "ok"
STATUS_REJECTED = "rejected"

# Priority classes (multi-tenant serving, docs/reliability.md
# "Multi-tenant serving & fairness"). Order = priority: interactive
# dispatches ahead of batch ahead of scavenger under the fair-queueing
# scheduler, and the brownout ladder degrades the tail first.
# Unclassed requests are `batch` — the pre-multi-tenant behaviour
# (full brownout/approx semantics) unchanged.
CLASS_INTERACTIVE = "interactive"
CLASS_BATCH = "batch"
CLASS_SCAVENGER = "scavenger"
CLASSES = (CLASS_INTERACTIVE, CLASS_BATCH, CLASS_SCAVENGER)
DEFAULT_CLASS = CLASS_BATCH

# Per-class latency SLOs in seconds — the published service objectives
# each priority class is sold under. `ServeConfig.class_deadlines=True`
# adopts these as per-class deadline defaults for requests that carry
# none of their own, and derives `deadline_slack_s` (the urgent-lane
# promotion threshold) from the tightest class SLO so the dispatcher's
# notion of "about to miss" tracks the strictest promise actually made.
CLASS_SLOS = {
    CLASS_INTERACTIVE: 0.5,
    CLASS_BATCH: 10.0,
    CLASS_SCAVENGER: 60.0,
}


@dataclass
class Request:
    """One influence query entering the service."""

    user: int
    item: int
    id: str | None = None
    # wall-clock budget in seconds, measured from arrival; None adopts
    # the service default (ServeConfig.default_deadline_s)
    deadline_s: float | None = None
    # priority class ("interactive" | "batch" | "scavenger") — drives
    # admission quotas, fair-queueing weight, and the class-aware
    # brownout ladder; an unknown class is rejected "invalid" at the
    # door. JSON wire key: "class".
    cls: str = DEFAULT_CLASS
    # opaque tenant label for per-tenant accounting; never interpreted
    tenant: str | None = None

    def key(self) -> tuple[int, int]:
        return (int(self.user), int(self.item))


@dataclass
class Ticket:
    """A queued admitted request (service-internal)."""

    req: Request
    t_arrival: float
    t_deadline: float | None  # absolute, on the service clock
    # serving epoch this ticket was admitted under: a drain resolves it
    # against that epoch's fenced (engine, fingerprint) even if a
    # streaming update swapped the model in between (docs/design.md §17)
    epoch: int = 0

    def expired(self, now: float) -> bool:
        return self.t_deadline is not None and now > self.t_deadline


@dataclass
class Response:
    """The service's answer to one request."""

    id: str | None
    user: int
    item: int
    status: str = STATUS_OK
    # taxonomy kind ("deadline", "oom", ...) or an admission reason
    # ("overload", "invalid") when status == "rejected"
    reason: str | None = None
    scores: np.ndarray | None = None  # (count,) unpadded related scores
    related: np.ndarray | None = None  # (count,) train-row ids
    ihvp: np.ndarray | None = None  # (d,) block inverse-HVP
    test_grad: np.ndarray | None = None  # (d,) test-side block vector
    cache_tier: str | None = None
    queue_wait_s: float = 0.0
    solve_s: float = 0.0
    batch_id: int | None = None
    batch_size: int | None = None
    # serving mode active when this response was produced ("full" /
    # "bank_preferred" / "cache_only", serve/health.py) — every answer
    # AND every rejection says what regime produced it
    mode: str | None = None
    # certified-approximate answers (the 'sampled' rung, docs/design.md
    # §22): approx marks a subsampled payload and err_bound carries its
    # concentration bound on the max per-row score error (0.0 when the
    # sample covered every related row). Exact answers keep the
    # defaults, so absence reads as exactness.
    approx: bool = False
    err_bound: float | None = None
    # priority class and tenant echoed from the request (wire keys
    # "class"/"tenant") — every answer AND every rejection says which
    # tenant lane produced it
    cls: str = DEFAULT_CLASS
    tenant: str | None = None
    extra: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    def json(self, include_payload: bool = True) -> dict:
        """JSON-encodable form (the CLI's stdout line)."""
        out = {
            "id": self.id,
            "user": int(self.user),
            "item": int(self.item),
            "status": self.status,
            "reason": self.reason,
            "tier": self.cache_tier,
            "queue_wait_ms": round(self.queue_wait_s * 1e3, 3),
            "solve_ms": round(self.solve_s * 1e3, 3),
            "batch_id": self.batch_id,
            "batch_size": self.batch_size,
            "mode": self.mode,
            "approx": bool(self.approx),
            "err_bound": (None if self.err_bound is None
                          else float(self.err_bound)),
            "class": self.cls,
            "tenant": self.tenant,
        }
        if include_payload and self.scores is not None:
            out["scores"] = np.asarray(self.scores).tolist()
            if self.related is not None:
                out["related"] = np.asarray(self.related).tolist()
        return out
