"""Composable recovery policies (copy of
``fia_tpu/reliability/policy.py``):

- :class:`Clock` — the injectable monotonic time source (``:49-66``);
  production uses :data:`WALL`, tests a :class:`VirtualClock`, so
  deadline expiry and backoff schedules run in virtual time;
- :class:`Deadline` — a monotonic time budget (``:93-123``); expiry is a
  clean, resumable stop (kind ``DEADLINE``), not an error;
- :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter (``:126-202``), used by the trainer's dispatches;
- the query solver degradation ladder (``:220-271``): a non-finite
  influence payload escalates one rung toward the exact direct solve
  (``lissa → cg → direct``, ``schulz → direct``); ``precomputed`` sits
  ahead of it and ``sampled`` is the certified-approximate rung before
  ``lissa``.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable, Iterable

from fia_tpu_torch.reliability import taxonomy


def _mix64(*vals: int) -> int:
    """Deterministic 64-bit hash (splitmix64 over folded inputs)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (v & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 % (1 << 64)
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB % (1 << 64)
        h ^= h >> 31
    return h


class Clock:
    """Injectable monotonic time source (the wall-clock behaviour): one
    object both reads time (:meth:`monotonic`) and spends it
    (:meth:`sleep`), so a policy that backs off and a deadline that
    expires agree on what "now" means."""

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0.0:
            _time.sleep(seconds)


WALL = Clock()


class VirtualClock(Clock):
    """Deterministic virtual time: ``sleep`` advances ``monotonic``
    instantly, so retry and deadline interactions run in zero wall time
    and reproduce exactly."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += max(float(seconds), 0.0)

    def advance(self, seconds: float) -> None:
        """Move time forward without a sleeper (an external event)."""
        self._now += float(seconds)


class Deadline:
    """A monotonic-clock budget on a unit of work. ``seconds=None`` (or
    <= 0) is the unbounded deadline, so call sites can thread one object
    unconditionally."""

    def __init__(self, seconds: float | None = None,
                 clock: Clock | None = None):
        self.seconds = None if not seconds or seconds <= 0 else float(seconds)
        self.clock = WALL if clock is None else clock
        self._t0 = self.clock.monotonic()

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return self.seconds - (self.clock.monotonic() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "work") -> None:
        """Raise :class:`~fia_tpu_torch.reliability.taxonomy.
        DeadlineExpired` when the budget is spent."""
        if self.expired():
            raise taxonomy.DeadlineExpired(
                f"deadline of {self.seconds:.3f}s expired during {what}"
            )


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter:
    ``delay(attempt)`` is ``min(base_delay * multiplier**attempt,
    max_delay)`` scaled by a factor in ``[1 - jitter, 1 + jitter]``
    derived from ``(seed, attempt)``, so one policy always produces the
    same schedule."""

    max_attempts: int = 4
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def delay(self, attempt: int) -> float:
        raw = min(
            self.base_delay * (self.multiplier ** attempt), self.max_delay
        )
        if self.jitter <= 0.0 or raw <= 0.0:
            return raw
        frac = (_mix64(self.seed, attempt) % (1 << 24)) / float(1 << 24)
        return raw * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def delays(self) -> list[float]:
        """The full backoff schedule (between-attempt sleeps)."""
        return [self.delay(i) for i in range(max(self.max_attempts - 1, 0))]

    def run(
        self,
        fn: Callable,
        *,
        retry_on: Iterable[str] = taxonomy.TRANSIENT,
        classify: Callable[[BaseException], str | None] = taxonomy.classify,
        deadline: Deadline | None = None,
        sleep: Callable[[float], None] | None = None,
        clock: Clock | None = None,
        on_retry: Callable[[str, int, BaseException], None] | None = None,
    ):
        """Call ``fn`` with bounded retries on classified-transient
        failures. Unclassified failures, kinds outside ``retry_on`` and
        a failure whose next backoff would overshoot ``deadline`` surface
        at once. (The reference also counts each retry in its metrics
        registry, which the port does not have yet: ROADMAP A.10.)"""
        if sleep is None:
            sleep = (WALL if clock is None else clock).sleep
        retry_on = frozenset(retry_on)
        attempts = max(int(self.max_attempts), 1)
        for attempt in range(attempts):
            try:
                return fn()
            except Exception as e:
                kind = classify(e)
                if kind not in retry_on or attempt + 1 >= attempts:
                    raise
                d = self.delay(attempt)
                if deadline is not None and deadline.remaining() < d:
                    raise
                if on_retry is not None:
                    on_retry(kind, attempt, e)
                if d > 0.0:
                    sleep(d)


QUERY_SOLVER_FALLBACK = {"precomputed": "sampled", "sampled": "lissa",
                         "lissa": "cg", "schulz": "direct",
                         "cg": "direct"}
#: the full-parameter engine's ladder (CG's best-iterate freeze cannot
#: diverge)
FULL_SOLVER_FALLBACK = {"lissa": "cg"}

#: solver names the block engine accepts, ladder-ordered robust-last
BLOCK_SOLVERS = ("precomputed", "sampled", "lissa", "schulz", "cg",
                 "direct")
#: solver names the full-parameter engine accepts: it has no block bank
#: and no subsampled block estimator, so ``precomputed`` or ``sampled``
#: requested there walks the ladder down to ``lissa`` (resolve_solver)
FULL_SOLVERS = ("lissa", "cg")


def next_solver(current: str, fallback: dict[str, str] = QUERY_SOLVER_FALLBACK
                ) -> str | None:
    """The next (more robust) rung under ``current``, or ``None`` at the
    ladder's bottom."""
    return fallback.get(current)


def resolve_solver(requested: str | None, default: str = "direct",
                   supported: tuple[str, ...] = BLOCK_SOLVERS) -> str:
    """``requested`` (``None``: ``default``), walked down the ladder
    until a ``supported`` rung, else the most robust supported one."""
    name = default if requested is None else str(requested)
    seen = set()
    while name not in supported:
        if name in seen:  # ladder cycle guard (config maps are data)
            break
        seen.add(name)
        nxt = next_solver(name)
        if nxt is None:
            break
        name = nxt
    if name not in supported:
        name = supported[-1]
    return name
