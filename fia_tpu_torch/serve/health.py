"""The brownout ladder: health-driven serving modes (copy of
``fia_tpu/serve/health.py``: the same transition log for the same
signals).

Under sustained overload or a sick backend, a binary admit/shed door
(serve/admission.py) wastes the one asset the service still has: tiers
that answer without device miss-work. The factor bank serves O(1) hits
(docs/design.md §14) and the hot/disk caches serve for free — so
instead of shedding uniformly, the service *browns out*: it steps down
a ladder of modes that keep the cheap tiers answering and shed only
the expensive miss path.

Modes (severity order)::

    full            everything serves (the healthy steady state)
    bank_preferred  cache hits + precomputed-bank hits serve; misses
                    that would need a ladder solve serve from the
                    certified ``sampled`` rung instead — answered
                    ``approx=True`` with a stamped error bound — when
                    ``approx_ok`` allows it, and are shed "degraded"
                    otherwise
    cache_only      only hot/disk cache hits serve; every miss is shed
                    (the one mode where "degraded" rejections remain)

The :class:`HealthController` drives the mode from two windowed
signals observed once per drain:

- **error rate** — classified dispatch failures / dispatches, over the
  last ``window`` drains that dispatched anything;
- **queue fraction** — queue depth / queue capacity at drain start.

Transitions are hysteretic in both directions. Stepping DOWN needs
*sustained* evidence — the error signal only counts once the window
holds ``min_evidence`` dispatches (two shed micro-batches are a blip,
not a trend), and the queue signal only counts after ``queue_hold``
consecutive saturated samples (a full queue at drain start is the
NORMAL maximal-coalescing pattern; only a queue that stays pinned is
pressure). Once the evidence is in, the step down is immediate and
jumps as far as the signals demand. Stepping UP requires ``hold``
consecutive calm samples (both signals at or below their ``*_recover``
thresholds) and moves one rung at a time. The dead band between
recover and degrade thresholds means a signal hovering at the degrade
line cannot flap: crossing down requires strictly hotter evidence
than crossing up tolerates.

Determinism: the controller consumes only the numbers passed to
:meth:`HealthController.observe` — no wall clock, no randomness — so a
replayed signal stream yields the identical transition log
(tests/test_degraded.py pins this).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from fia_tpu_torch.serve.request import (
    CLASS_INTERACTIVE,
    CLASS_SCAVENGER,
    DEFAULT_CLASS,
)

MODE_FULL = "full"
MODE_BANK_PREFERRED = "bank_preferred"
MODE_CACHE_ONLY = "cache_only"

# severity order: index = rungs below full serving
LADDER = (MODE_FULL, MODE_BANK_PREFERRED, MODE_CACHE_ONLY)


@dataclass
class HealthConfig:
    """Thresholds for the brownout ladder.

    Each signal has a degrade threshold (at or above ⇒ step down) and a
    recover threshold (at or below ⇒ counts toward stepping up); the
    gap between them is the anti-flap dead band, validated > 0. Error
    rate escalates two rungs at ``err_cache_only`` (a backend failing
    most dispatches should not waste bank solves either); queue
    pressure alone never forces ``cache_only`` — a deep queue with a
    healthy backend is what the bank tier is FOR.
    """

    window: int = 8            # drains remembered per signal
    err_degrade: float = 0.5   # windowed error rate ⇒ bank_preferred
    err_cache_only: float = 0.9  # windowed error rate ⇒ cache_only
    err_recover: float = 0.25  # calm when at or below
    # dispatches the error window must hold before the error signal is
    # trusted: a single two-batch drain shedding both is 100% "error
    # rate" on no evidence
    min_evidence: int = 4
    queue_degrade: float = 0.9  # queue_depth/queue_cap ⇒ bank_preferred
    queue_recover: float = 0.5  # calm when at or below
    # consecutive saturated queue samples before queue pressure counts:
    # a full queue at one drain is maximal coalescing working as
    # intended, a queue pinned full across drains is overload
    queue_hold: int = 3
    hold: int = 2              # consecutive calm samples per rung up
    # degraded modes may answer misses from the certified sampled rung
    # (approx=True + err_bound) instead of shedding them "degraded";
    # False restores the shed-everything brownout
    approx_ok: bool = True

    def validate(self) -> "HealthConfig":
        if self.window < 1 or self.hold < 1:
            raise ValueError("health window and hold must be >= 1")
        if self.min_evidence < 1 or self.queue_hold < 1:
            raise ValueError("min_evidence and queue_hold must be >= 1")
        if not (0.0 <= self.err_recover < self.err_degrade
                <= self.err_cache_only):
            raise ValueError(
                "need 0 <= err_recover < err_degrade <= err_cache_only "
                "(the gap is the anti-flap dead band)"
            )
        if not 0.0 <= self.queue_recover < self.queue_degrade:
            raise ValueError("need 0 <= queue_recover < queue_degrade")
        return self


class HealthController:
    """Windowed-signal mode ladder with hysteresis.

    Feed :meth:`observe` once per drain; read :attr:`mode` (or the
    return value) for the regime the NEXT drain serves under — the mode
    is fixed for the whole of a drain, so within-drain decisions stay
    deterministic. :attr:`transitions` is the append-only log of every
    mode change with the signal values that drove it.
    """

    def __init__(self, config: HealthConfig | None = None):
        self.config = (config or HealthConfig()).validate()
        self.mode = MODE_FULL
        self.transitions: list[dict] = []
        self._errors: deque = deque(maxlen=self.config.window)
        self._queue: deque = deque(maxlen=self.config.window)
        self._calm = 0
        self._queue_hot = 0  # consecutive saturated queue samples
        self._tick = 0

    # -- signals ----------------------------------------------------------
    def error_rate(self) -> float:
        """Classified-failure fraction over the remembered dispatching
        drains (0.0 while nothing has dispatched)."""
        disp = sum(d for _, d in self._errors)
        if disp == 0:
            return 0.0
        return sum(e for e, _ in self._errors) / disp

    def queue_frac(self) -> float:
        """Most recent queue_depth/queue_cap sample (the queue signal
        is about NOW, not history — old depth says nothing once the
        queue drains)."""
        return self._queue[-1] if self._queue else 0.0

    # -- the ladder -------------------------------------------------------
    def observe(self, *, errors: int = 0, dispatches: int = 0,
                queue_depth: int = 0, queue_cap: int = 1) -> str:
        """Fold one drain's signals in; returns the (possibly new) mode.

        ``errors``/``dispatches``: classified dispatch failures out of
        device dispatches this drain (drains that dispatched nothing
        leave the error window untouched — no evidence either way).
        ``queue_depth``/``queue_cap``: admission queue occupancy at
        drain start.
        """
        self._tick += 1
        if dispatches > 0:
            self._errors.append((min(int(errors), int(dispatches)),
                                 int(dispatches)))
        self._queue.append(min(int(queue_depth) / max(int(queue_cap), 1),
                               1.0))
        err = self.error_rate()
        q = self.queue_frac()
        cfg = self.config
        self._queue_hot = (self._queue_hot + 1
                           if q >= cfg.queue_degrade else 0)
        err_trusted = (
            sum(d for _, d in self._errors) >= cfg.min_evidence
        )

        # target severity demanded by the current windows
        want = 0
        if err_trusted and err >= cfg.err_degrade:
            want = 1
        if self._queue_hot >= cfg.queue_hold:
            want = max(want, 1)
        if err_trusted and err >= cfg.err_cache_only:
            want = 2
        cur = LADDER.index(self.mode)

        if want > cur:
            # degrade immediately, as far as the signals demand
            self._calm = 0
            self._step(LADDER[want], err, q)
        elif cur > 0 and err <= cfg.err_recover and q <= cfg.queue_recover:
            # calm sample: one rung up after `hold` of them in a row
            self._calm += 1
            if self._calm >= cfg.hold:
                self._calm = 0
                self._step(LADDER[cur - 1], err, q)
        else:
            # in the dead band (or still failing): recovery restarts
            self._calm = 0
        return self.mode

    def _step(self, to: str, err: float, q: float) -> None:
        self.transitions.append({
            "from": self.mode, "to": to, "tick": self._tick,
            "error_rate": round(err, 4), "queue_frac": round(q, 4),
        })
        self.mode = to

    # -- mode predicates the service consults -----------------------------
    # Class-aware brownout (docs/reliability.md "Multi-tenant serving &
    # fairness"): the ladder position is GLOBAL (one signal history, one
    # transition log — replay determinism is unchanged) but each rung
    # degrades the classes in reverse priority order. At severity 1
    # (bank_preferred) interactive traffic still takes full ladder
    # solves — it sheds only at severity 2 — while batch browns out to
    # bank/approx and scavenger loses the bank tier too (approx or
    # shed: the cheap-tier capacity the bank preserves is exactly the
    # headroom the brownout protects for higher classes). Severity 2
    # (cache_only) is the exhaustion floor for everyone. The default
    # ``cls`` is the legacy/batch class, so every pre-multi-tenant
    # call site keeps the single-class semantics bit-for-bit.
    def class_mode(self, cls: str = DEFAULT_CLASS) -> str:
        """The effective serving mode ``cls`` experiences under the
        current global ladder position."""
        if self.mode == MODE_FULL:
            return MODE_FULL
        if self.mode == MODE_CACHE_ONLY:
            return MODE_CACHE_ONLY
        # global bank_preferred: interactive rides above the brownout
        if cls == CLASS_INTERACTIVE:
            return MODE_FULL
        return MODE_BANK_PREFERRED

    def allows_solve(self, cls: str = DEFAULT_CLASS) -> bool:
        """May a miss of ``cls`` take a from-scratch ladder solve?"""
        return self.class_mode(cls) == MODE_FULL

    def allows_bank(self, cls: str = DEFAULT_CLASS) -> bool:
        """May a miss of ``cls`` take the O(1) precomputed-bank path?
        Scavenger loses it one rung early: under brownout the bank's
        O(1) capacity is reserved for the classes above."""
        if self.class_mode(cls) == MODE_CACHE_ONLY:
            return False
        return not (self.mode != MODE_FULL and cls == CLASS_SCAVENGER)

    def allows_approx(self, cls: str = DEFAULT_CLASS) -> bool:
        """May a brownout miss of ``cls`` serve a certified approximate
        answer (the ``sampled`` rung) instead of shedding?
        ``cache_only`` is the exhaustion floor — by then the backend is
        failing most dispatches and even a subsampled solve is work it
        cannot do. Interactive never answers approx: its contract is
        exact-or-shed."""
        return (self.config.approx_ok
                and self.class_mode(cls) == MODE_BANK_PREFERRED)
