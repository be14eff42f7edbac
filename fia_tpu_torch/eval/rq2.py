"""RQ2: wall-clock cost of influence queries (port of
``fia_tpu/eval/rq2.py:24-104``).

Parity target: reference ``src/scripts/RQ2.py`` + ``experiments.py:4-15``
(``record_time_cost``): time one influence query — inverse-HVP solve plus
scoring every related training row.

Each timed run ends with its results on the host (``query_batch`` and
``query_many`` return host arrays), so it is fenced. The first call is
timed apart from the others (``compile_time_s``): on the card it builds
the kernels and captures one CUDA graph for each flat geometry it
dispatches, the port's counterpart of the reference's trace and compile;
later calls replay those graphs. The report gives queries/s and
scores/s over a batch of test points.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from fia_tpu_torch.influence.engine import InfluenceEngine


@dataclass
class TimingResult:
    num_queries: int
    num_scores: int  # total related rows scored
    compile_time_s: float
    total_time_s: float  # steady-state wall clock (excl. compile)
    queries_per_sec: float
    scores_per_sec: float
    per_query_ms: float
    repeats: int = 1
    times_s: list = field(default_factory=list)

    def json(self) -> dict:
        return {
            "num_queries": self.num_queries,
            "num_scores": self.num_scores,
            "compile_time_s": round(self.compile_time_s, 4),
            "total_time_s": round(self.total_time_s, 4),
            "queries_per_sec": round(self.queries_per_sec, 2),
            "scores_per_sec": round(self.scores_per_sec, 2),
            "per_query_ms": round(self.per_query_ms, 4),
        }


def time_influence_queries(
    engine: InfluenceEngine,
    test_points: np.ndarray,
    repeats: int = 3,
    pad_to: int | None = None,
    batch_queries: int | None = None,
) -> TimingResult:
    """Time batched influence queries over ``test_points`` (T, 2).

    The first call (kernel builds, graph captures and the run) is
    measured separately; steady-state time is the best of ``repeats``
    fenced runs.

    ``batch_queries``: cap the per-dispatch query count, routing through
    the engine's pipelined ``query_many``.
    """
    # pad_to=None lets the engine pick per its own pad_policy — its choice
    # is deterministic across repeats, so timing measures the same
    # compiled program production queries would use.
    test_points = np.asarray(test_points)
    if batch_queries is not None and batch_queries < 1:
        # a negative cap would make query_many's range() empty and
        # silently bank a zero-score "benchmark"
        raise ValueError(f"batch_queries must be >= 1, got {batch_queries}")

    def run():
        if batch_queries and batch_queries < len(test_points):
            return engine.query_many(
                test_points, batch_queries=batch_queries, pad_to=pad_to
            )
        return [engine.query_batch(test_points, pad_to=pad_to)]

    t0 = time.perf_counter()
    res = run()
    compile_time = time.perf_counter() - t0

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = run()
        times.append(time.perf_counter() - t0)
    best = min(times)

    num_scores = int(sum(int(r.counts.sum()) for r in res))
    return TimingResult(
        num_queries=len(test_points),
        num_scores=num_scores,
        compile_time_s=compile_time,
        total_time_s=best,
        queries_per_sec=len(test_points) / best,
        scores_per_sec=num_scores / best,
        per_query_ms=1e3 * best / len(test_points),
        repeats=repeats,
        times_s=times,
    )
