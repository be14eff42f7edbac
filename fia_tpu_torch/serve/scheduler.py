"""Micro-batching: coalesce compatible queries into one dispatch (copy
of ``fia_tpu/serve/scheduler.py``: its plans are the reference's, index
for index, on the same counts, classes and urgency).

A single influence query is a tiny device program drowning in fixed
costs (host→device transfer of the test point, dispatch RPC, result
fetch); the engine's whole design is batch amortization
(docs/design.md §2). The scheduler recovers that amortization for a
*stream*: queued queries sharing one engine configuration are packed
into batches of at most ``max_batch``.

Two coalescing orders:

- ``"bucket"`` (default): a *stable* sort by the query's padded-size
  bucket (``data/index.py:bucketed_pad`` over its related count)
  before chunking — queries landing in the same bucket share compiled
  programs on the padded path, and on the flat path similar-degree
  neighbours tighten the total-row buckets. The sort is stable, so
  arrival order is preserved within a bucket and the plan is
  deterministic for a given queue.
- ``"fifo"``: strict arrival order (lowest queue-position jitter).

The plan is pure (no engine calls): a list of batches over the caller's
items, so the service can apply it to tickets and the warmup path can
apply the SAME planner to a sample stream — the shapes warmup compiles
are exactly the shapes serving will dispatch.
"""

from __future__ import annotations

import numpy as np

from fia_tpu_torch.data.index import bucketed_pad
from fia_tpu_torch.serve.request import CLASSES


class MicroBatcher:
    def __init__(self, max_batch: int = 32, coalesce: str = "bucket",
                 pad_bucket: int = 128):
        if coalesce not in ("bucket", "fifo"):
            raise ValueError(f"unknown coalesce policy {coalesce!r}")
        self.max_batch = max(int(max_batch), 1)
        self.coalesce = coalesce
        self.pad_bucket = int(pad_bucket)

    def order(self, counts: np.ndarray) -> np.ndarray:
        """Dispatch order over queue positions (stable)."""
        n = len(counts)
        if self.coalesce == "fifo" or n <= 1:
            return np.arange(n)
        buckets = np.array(
            [bucketed_pad(int(c), self.pad_bucket) for c in counts]
        )
        return np.argsort(buckets, kind="stable")

    def planned_shapes(self, counts: np.ndarray) -> list[tuple[int, int]]:
        """``(n_queries, total_related_rows)`` per planned batch — the
        pure packing preview warmup/bench reports use to show what the
        mega-batch coalescing produced without touching the engine
        (the engine's ``flat_geometry`` turns these into compile
        geometries by applying its query/row buckets)."""
        counts = np.asarray(counts)
        return [
            (len(b), int(counts[b].sum())) for b in self.plan(counts)
        ]

    def plan(self, counts: np.ndarray) -> list[np.ndarray]:
        """Batches of queue positions: the coalesced order chunked into
        consecutive ``max_batch`` slices.

        Chunking the *ordered stream* (rather than emitting one batch
        per bucket) keeps batches full: a bucket with 3 queries rides
        with its neighbour bucket instead of paying a 3-query dispatch.
        It also makes the dispatch stream reproducible by
        ``engine.query_many(points[order], batch_queries=max_batch)`` —
        the byte-identity contract the serving tests pin.
        """
        order = self.order(np.asarray(counts))
        return [
            order[s: s + self.max_batch]
            for s in range(0, len(order), self.max_batch)
        ]


# Deficit-round-robin quanta per class, in units of max_batch query
# slots per visit. Interactive drains ~8 batches for every 1 scavenger
# batch under sustained contention; the deficit counters make the
# ratio exact over time instead of per-plan (a class skipped this plan
# accumulates credit for the next).
CLASS_WEIGHTS = {
    "interactive": 8,
    "batch": 3,
    "scavenger": 1,
}


class FairScheduler:
    """Deficit-weighted fair queueing over per-class lanes.

    Wraps a :class:`MicroBatcher`: each class's queue positions are
    coalesced by the SAME bucket/fifo policy into class-pure batches
    (never coalesce an interactive request behind a bulk chunk), then
    the batches interleave by deficit round-robin — per round each
    class earns ``weight × max_batch`` query slots of credit and emits
    its next batch while the credit covers it, visiting classes in
    priority order so ties break toward interactive.

    Single-class streams (including every unclassed/legacy stream:
    ``classes=None`` or all-equal) bypass the DRR machinery entirely
    and return ``MicroBatcher.plan`` verbatim — the pre-multi-tenant
    byte-identity contract is untouched (tests/test_serve.py pins it).

    Deadline-aware packing: ``urgent`` marks queue positions whose
    deadline is near; batches containing any urgent position are
    stably promoted to the front of the interleaved plan (multi-class
    plans only — a single-class plan is already the pinned contract).

    Deficits persist across :meth:`plan` calls (deterministic for a
    replayed drain sequence; :meth:`reset` forgets them).
    """

    def __init__(self, batcher: MicroBatcher,
                 class_weights: dict[str, int] | None = None):
        self.batcher = batcher
        weights = dict(CLASS_WEIGHTS)
        weights.update(class_weights or {})
        for cls, w in weights.items():
            if cls not in CLASSES:
                raise ValueError(f"class_weights names unknown class "
                                 f"{cls!r} (know {CLASSES})")
            if int(w) < 1:
                raise ValueError(f"class weight for {cls!r} must be "
                                 f">= 1, got {w}")
        self.weights = {cls: int(weights[cls]) for cls in CLASSES}
        self._deficit = {cls: 0 for cls in CLASSES}

    def reset(self) -> None:
        self._deficit = {cls: 0 for cls in CLASSES}

    def _class_plan(self, counts: np.ndarray,
                    positions: np.ndarray) -> list[np.ndarray]:
        """One class's batches: the wrapped batcher's coalescing over
        the class's own positions, mapped back to global queue
        positions — class-pure by construction, and per batch the
        dispatch order is exactly what a single-class stream of these
        requests would have produced."""
        order = self.batcher.order(counts[positions])
        ordered = positions[order]
        mb = self.batcher.max_batch
        return [ordered[s: s + mb] for s in range(0, len(ordered), mb)]

    def plan(self, counts: np.ndarray, classes=None,
             urgent=None) -> list[np.ndarray]:
        """Batches of queue positions (same contract as
        :meth:`MicroBatcher.plan`), fair-interleaved across classes.

        ``classes``: per-position class labels (None = single lane).
        ``urgent``: optional per-position bools — deadline pressure.
        """
        counts = np.asarray(counts)
        if classes is None:
            return self.batcher.plan(counts)
        classes = list(classes)
        if len(classes) != len(counts):
            raise ValueError("classes must label every queue position")
        present = [c for c in CLASSES if c in classes]
        unknown = set(classes) - set(CLASSES)
        if unknown:
            raise ValueError(f"unknown class label(s) {sorted(unknown)}")
        if len(present) <= 1:
            return self.batcher.plan(counts)

        lanes = {
            cls: self._class_plan(
                counts,
                np.array([p for p, c in enumerate(classes) if c == cls],
                         dtype=np.int64),
            )
            for cls in present
        }
        quantum = self.batcher.max_batch
        plan: list[np.ndarray] = []
        remaining = sum(len(lane) for lane in lanes.values())
        while remaining:
            for cls in present:
                if not lanes[cls]:
                    continue
                self._deficit[cls] += self.weights[cls] * quantum
                while lanes[cls] and \
                        self._deficit[cls] >= len(lanes[cls][0]):
                    batch = lanes[cls].pop(0)
                    self._deficit[cls] -= len(batch)
                    plan.append(batch)
                    remaining -= 1
                if not lanes[cls]:
                    # an idle lane banks no credit (classic DRR: the
                    # deficit exists to honour backlog, not absence)
                    self._deficit[cls] = 0
        for cls in present:
            if not lanes[cls]:
                self._deficit[cls] = 0
        if urgent is not None:
            hot = {int(p) for p, u in zip(range(len(counts)), urgent)
                   if u}
            if hot:
                front = [b for b in plan
                         if any(int(p) in hot for p in b)]
                back = [b for b in plan
                        if not any(int(p) in hot for p in b)]
                plan = front + back
        return plan
