"""Schedule shrinking by delta debugging (Zeller's ddmin; copy of
``fia_tpu/chaos/shrink.py``).

A failing chaos schedule found by a seed sweep typically carries
faults that have nothing to do with the violation. ``ddmin`` reduces
the fault list to a *1-minimal* subset — removing any single remaining
fault makes the failure disappear — by alternately re-running subsets
and their complements. The test predicate re-executes the scenario
(deterministic: same faults ⇒ same run), so the shrunk schedule is a
true repro, not a heuristic guess.
"""

from __future__ import annotations

from typing import Callable, Sequence


def _chunks(items: list, n: int) -> list[list]:
    k, out, start = len(items) / float(n), [], 0.0
    for _ in range(n):
        end = start + k
        out.append(items[int(start):int(end)])
        start = end
    return [c for c in out if c]


def ddmin(
    faults: Sequence,
    still_fails: Callable[[list], bool],
    max_tests: int = 64,
) -> list:
    """The minimal sublist of ``faults`` for which ``still_fails`` holds.

    Classic ddmin: try each of ``n`` chunks, then each complement;
    recurse on any reduction with granularity reset (subset) or
    decremented (complement); double granularity when nothing shrinks.
    ``max_tests`` bounds predicate evaluations — on exhaustion the best
    reduction found so far is returned (still failing, maybe not
    minimal). The caller guarantees ``still_fails(faults)`` is true.
    """
    current = list(faults)
    n = 2
    tests = 0
    while len(current) >= 2:
        chunks = _chunks(current, n)
        reduced = False
        for candidate_set, next_n in (
            (chunks, 2),  # subsets: reset granularity
            ([[f for c2 in chunks if c2 is not c for f in c2]
              for c in chunks], None),  # complements: n - 1
        ):
            for cand in candidate_set:
                if not cand or len(cand) == len(current):
                    continue
                tests += 1
                if tests > max_tests:
                    return current
                if still_fails(list(cand)):
                    current = list(cand)
                    n = next_n if next_n is not None else max(n - 1, 2)
                    reduced = True
                    break
            if reduced:
                break
        if not reduced:
            if n >= len(current):
                break
            n = min(len(current), 2 * n)
    return current
