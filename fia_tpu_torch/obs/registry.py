"""Process-wide metrics registry: counters, gauges, µs histograms (copy
of ``fia_tpu/obs/registry.py``; the same series keys and snapshot form).

Design constraints:

- **lock-cheap** — instruments are plain attribute bumps on the hot
  path; the only dict lookup happens at instrument *creation*, so call
  sites hoist ``REGISTRY.counter(...)`` handles where it matters.
- **fixed-bucket histograms** — latency histograms share one global
  µs bucket ladder (1µs..60s, roughly 1-2.5-5 per decade) so p50/p99
  can be merged across processes and rendered by consumers that never
  saw the raw samples (scripts/latency_report.py).
- **deterministic snapshot order** — ``snapshot()`` sorts series keys,
  so two runs with the same traffic produce byte-identical snapshots
  and the Prometheus/JSONL exporters diff cleanly across runs.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# Shared µs bucket upper bounds (last bucket is +inf, implicit). The
# ladder spans sub-µs noise to a one-minute stall; it is the reference's
# ladder, so snapshots of either package merge (changing it is a schema
# break for dashboard consumers).
US_BUCKETS: tuple[float, ...] = (
    1, 2, 5, 10, 25, 50, 100, 250, 500,
    1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5, 2.5e5, 5e5,
    1e6, 2.5e6, 5e6, 1e7, 3e7, 6e7,
)


class Counter:
    """Monotonic count. ``inc`` is one float add under no lock —
    last-writer races lose at most one bump, acceptable for stats."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Point-in-time value, plus a high-water convenience."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def max(self, value: float) -> None:
        if value > self.value:
            self.value = float(value)

    def add(self, amount: float) -> None:
        self.value += amount


class Histogram:
    """Fixed-bucket histogram over :data:`US_BUCKETS` (+inf tail)."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts = [0] * (len(US_BUCKETS) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(US_BUCKETS, value)] += 1
        self.count += 1
        self.sum += value

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation inside the containing bucket. Returns 0.0 when
        empty; the +inf bucket clamps to the last finite bound."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target:
                if i >= len(US_BUCKETS):  # +inf bucket: clamp
                    return float(US_BUCKETS[-1])
                lo = US_BUCKETS[i - 1] if i > 0 else 0.0
                hi = US_BUCKETS[i]
                frac = (target - seen) / c if c else 0.0
                return float(lo + (hi - lo) * frac)
            seen += c
        return float(US_BUCKETS[-1])


def _series_key(name: str, labels: dict) -> str:
    """Flat series key, Prometheus-ish: ``name{a=1,b=x}`` with labels
    sorted — the canonical identity a snapshot is ordered by."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Keyed instrument store. Creation is locked; use is not."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, store: dict, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.setdefault(key, cls())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def snapshot(self) -> dict:
        """Deterministically-ordered plain-dict dump (sorted series
        keys). This is the ``obs.metrics`` payload and the input to
        the Prometheus exporter."""
        with self._lock:
            counters = {k: self._counters[k].value
                        for k in sorted(self._counters)}
            gauges = {k: self._gauges[k].value
                      for k in sorted(self._gauges)}
            hists = {}
            for k in sorted(self._histograms):
                h = self._histograms[k]
                hists[k] = {
                    "counts": list(h.counts),
                    "count": h.count,
                    "sum": round(h.sum, 3),
                }
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "buckets_us": list(US_BUCKETS),
        }

    def reset(self) -> None:
        """Drop every series (tests and bench A/B sections)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# The process-wide registry every fia_tpu_torch instrument writes to.
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


def percentile_from_snapshot(hist: dict, q: float,
                             buckets=US_BUCKETS) -> float:
    """Percentile from a snapshot-form histogram dict (``counts`` /
    ``count``), for consumers that only have the JSONL snapshot."""
    h = Histogram.__new__(Histogram)
    h.counts = list(hist["counts"])
    h.count = int(hist["count"])
    h.sum = float(hist.get("sum", 0.0))
    return h.percentile(q)
