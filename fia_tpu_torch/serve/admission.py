"""Admission control: overload sheds load deterministically (copy of
``fia_tpu/serve/admission.py``).

The alternative to admission control on an accelerator-backed service
is not slowness, it is death: an unbounded queue turns a traffic burst
into unbounded host memory plus ever-larger coalesced batches, and the
engine's own memory envelope (docs/design.md §9b) then learns failure
ceilings from load spikes rather than real capacity. The controller
bounds the queue and stamps every rejection with a classified reason,
reusing the reliability failure taxonomy where one applies
(``deadline``) and serve-specific reasons otherwise (``overload``,
``invalid``) — "dropped without reason" is a bug class the smoke test
asserts against.

Decisions are a pure function of (request, queue depth, clock), so a
replayed request stream sheds exactly the same requests.
"""

from __future__ import annotations

from fia_tpu_torch.reliability import taxonomy
from fia_tpu_torch.serve.request import CLASSES, Request, Ticket

# Rejection reasons. DEADLINE is the taxonomy kind (a request whose
# budget expired is the same failure class as a Deadline-guarded
# workload stopping); the others are admission-specific. DEGRADED is
# stamped by the service, not this controller: a brownout mode
# (serve/health.py) shedding miss-path work — the request was valid and
# the queue had room, but the active mode serves only bank/cache hits.
REASON_DEADLINE = taxonomy.DEADLINE
REASON_OVERLOAD = "overload"
REASON_INVALID = "invalid"
REASON_DEGRADED = "degraded"

# Per-class queue quotas as fractions of max_queue. The defaults keep
# the pre-multi-tenant behaviour for interactive/batch (full queue)
# and cap only the new scavenger class, so a scavenger flood can never
# evict interactive/batch headroom; stricter isolation is opt-in via
# ServeConfig.class_quotas. A class's quota bounds how many of ITS
# tickets may wait — the total queue bound still applies on top.
DEFAULT_CLASS_QUOTAS = {
    "interactive": 1.0,
    "batch": 1.0,
    "scavenger": 0.5,
}


class AdmissionController:
    """Bounded-queue, deadline-aware admission.

    ``max_queue``: tickets allowed to wait; a submit finding the queue
    full is rejected (newest-sheds — deterministic, and the queued work
    keeps its arrival-order latency bound).
    ``default_deadline_s``: budget stamped on requests that carry none
    (None = unbounded).
    ``num_users``/``num_items``: id-range validation — an out-of-range
    id must be refused at the door, not discovered as a host-side
    IndexError inside a coalesced batch dispatch.
    ``class_quotas``: per-class queue quota fractions merged over
    ``DEFAULT_CLASS_QUOTAS`` — each class's waiting tickets are bounded
    by ``max(1, round(frac * max_queue))`` so a lower-priority flood
    fills only its own lane.
    ``tenant_quotas``: the same bound one level down — fractions keyed
    by tenant label, applied UNDER the class quotas (both must pass).
    Only listed tenants are capped; unlisted tenants (and unlabelled
    requests) see no per-tenant bound, so the knob is opt-in per
    tenant exactly like ``class_quotas`` is per class. One noisy
    tenant inside a class can otherwise starve its own class's lane —
    the class quota is blind to who filled it.
    ``class_deadlines``: per-class deadline defaults in seconds
    (typically the class SLOs, ``request.CLASS_SLOS``) consulted for
    requests that carry no deadline of their own, BEFORE the global
    ``default_deadline_s``. A request's explicit ``deadline_s`` always
    wins — the SLO is the promise made to a class, not a cap on what
    one caller may ask for.
    """

    def __init__(self, max_queue: int = 256,
                 default_deadline_s: float | None = None,
                 num_users: int | None = None,
                 num_items: int | None = None,
                 class_quotas: dict[str, float] | None = None,
                 tenant_quotas: dict[str, float] | None = None,
                 class_deadlines: dict[str, float] | None = None):
        self.max_queue = max(int(max_queue), 1)
        self.default_deadline_s = default_deadline_s
        for cls in (class_deadlines or {}):
            if cls not in CLASSES:
                raise ValueError(f"class_deadlines names unknown class "
                                 f"{cls!r} (know {CLASSES})")
        self.class_deadlines = dict(class_deadlines or {})
        self.num_users = num_users
        self.num_items = num_items
        quotas = dict(DEFAULT_CLASS_QUOTAS)
        quotas.update(class_quotas or {})
        for cls, frac in quotas.items():
            if cls not in CLASSES:
                raise ValueError(f"class_quotas names unknown class "
                                 f"{cls!r} (know {CLASSES})")
            if not 0.0 < float(frac) <= 1.0:
                raise ValueError(
                    f"class quota for {cls!r} must be in (0, 1], "
                    f"got {frac}")
        self.class_caps = {
            cls: max(1, int(round(float(frac) * self.max_queue)))
            for cls, frac in quotas.items()
        }
        for tenant, frac in (tenant_quotas or {}).items():
            if not 0.0 < float(frac) <= 1.0:
                raise ValueError(
                    f"tenant quota for {tenant!r} must be in (0, 1], "
                    f"got {frac}")
        self.tenant_caps = {
            tenant: max(1, int(round(float(frac) * self.max_queue)))
            for tenant, frac in (tenant_quotas or {}).items()
        }

    def reject_reason(self, req: Request, queue_depth: int,
                      class_depth: int = 0,
                      tenant_depth: int = 0) -> str | None:
        """The rejection reason for ``req`` at ``queue_depth``, or None
        when it is admitted. ``class_depth`` is the count of queued
        tickets already in ``req``'s class, ``tenant_depth`` the count
        already carrying ``req``'s tenant label (0 keeps the
        single-tenant behaviour: only the total bound applies)."""
        u, i = int(req.user), int(req.item)
        if u < 0 or i < 0:
            return REASON_INVALID
        if self.num_users is not None and u >= self.num_users:
            return REASON_INVALID
        if self.num_items is not None and i >= self.num_items:
            return REASON_INVALID
        if req.cls not in CLASSES:
            return REASON_INVALID
        if queue_depth >= self.max_queue:
            return REASON_OVERLOAD
        if class_depth >= self.class_caps[req.cls]:
            return REASON_OVERLOAD
        cap = (self.tenant_caps.get(req.tenant)
               if req.tenant is not None else None)
        if cap is not None and tenant_depth >= cap:
            return REASON_OVERLOAD
        return None

    def ticket(self, req: Request, now: float) -> Ticket:
        """An admitted request's queue ticket (absolute deadline on the
        service clock)."""
        budget = req.deadline_s
        if budget is None:
            budget = self.class_deadlines.get(req.cls)
        if budget is None:
            budget = self.default_deadline_s
        t_deadline = None if budget is None or budget <= 0 else now + budget
        return Ticket(req=req, t_arrival=now, t_deadline=t_deadline)
