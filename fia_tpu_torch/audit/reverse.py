"""Reverse top-k influence sweep: train rows ranked by harm to a test set
(port of ``fia_tpu/audit/reverse.py``: the same fold, sweep id and
selection).

The forward query asks "which train rows influence THIS test point";
the reverse sweep transposes it — "which train rows most influence
this TEST SET" — by streaming every (test point, related train row)
interaction through the engine's windowed flat dispatch
(:meth:`InfluenceEngine.query_many`: one captured CUDA graph a geometry
on the card, the score kernels and ``segment_hessian``) and folding the
per-point scores into one group-influence accumulator over train rows,
following the group aggregation of "Scaling Up Influence Functions"
(arXiv:2112.03052).

Scoring. The engine's score ``s[j,t]`` is the predicted change in the
model's rating for test point ``t`` when train row ``j`` is removed.
Given that shift the test-set SSE moves by (exact in ``s``, no
first-order truncation — the quadratic term matters for exactly the
large-|s| rows a sweep exists to surface)::

    G[j] = Σ_t (ŷ_t + s[j,t] − y_t)² − (ŷ_t − y_t)²
         = Σ_t (2·(ŷ_t − y_t) + s[j,t]) · s[j,t]

so the rows with the most *negative* ``G`` are the ones whose removal
is predicted to help the test set most — the deletion/reweighting
candidates ``audit/plan.py`` acts on.

Determinism. The result is **bitwise identical under any chunking of
the stream**, which is what makes sweep artifacts comparable across
runs:

- engine scores are pinned bitwise across batch splits (the flat
  path's split invariance);
- the residual weights are computed ONCE over the whole test set
  before any chunking;
- the fold applies scores with ``np.add.at`` on arrays concatenated
  in test-point stream order — ``ufunc.at`` accumulates elements in
  array order, so per-slot addition order equals the global stream
  order no matter how the stream was split into batches;
- the final selection is a per-segment selection on the model's device
  over FIXED-size accumulator segments, merged on host with a total
  (value, row id) order — ties can never reorder across runs.

The reference selects each segment with ``lax.top_k``, which returns the
lower index first among equal values. ``torch.topk`` promises no order
among ties on CUDA, and the accumulator is full of exact ties (every
train row no test point reaches stays ``0.0``), so each segment is
instead sorted stably by value (``torch.sort(..., stable=True)``): the
first ``kk`` entries are then the segment's least values in (value, row
id) order, the reference's selection, on the CPU and the card alike.

Reliability: ``audit.sweep`` fires at sweep start; pass a reliability
:class:`Journal` opened against :func:`sweep_fingerprint` and every
finalized engine batch is durable — a killed sweep resumes where it
stopped, and the host fold is recomputed from journaled scores.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.device import resolve_device
from fia_tpu_torch.reliability import inject, sites

# Accumulator segment width for the device-side selection. Fixed (never
# derived from chunking) so the segment geometry — and with it the
# selection — is part of the deterministic contract.
SEGMENT = 1 << 16


@dataclass
class SweepResult:
    """Outcome of one :func:`reverse_topk` sweep."""

    row_ids: np.ndarray      # (k,) train rows, most negative G first
    loss_deltas: np.ndarray  # (k,) predicted test-SSE delta on removal
    group_scores: np.ndarray  # (num_train,) full accumulator, float32
    sweep_id: str
    test_points: np.ndarray  # (T, 2) provenance
    rows_scored: int         # Σ related counts streamed through
    chunks: int
    seconds: float

    @property
    def rows_per_s(self) -> float:
        return self.rows_scored / self.seconds if self.seconds > 0 else 0.0


class _PrefixJournal:
    """Namespace a shared Journal per outer chunk: ``query_many``
    journals under ``batch:<k>`` keys, so two chunks sharing one file
    would collide without a prefix."""

    def __init__(self, journal, prefix: str):
        self._j = journal
        self._p = prefix

    def done(self, key: str) -> bool:
        return self._j.done(self._p + key)

    def get(self, key: str):
        return self._j.get(self._p + key)

    def record(self, key: str, payload) -> None:
        self._j.record(self._p + key, payload)


def sweep_fingerprint(engine, test_points, test_y, *, k: int,
                      batch_queries: int = 256,
                      chunk_points: int | None = None,
                      pad_to: int | None = None, **extra) -> dict:
    """Journal identity of one reverse sweep (see ``Journal.open``).

    Extends the engine's ``query_many`` fingerprint: the outer chunk
    split and the (labels, k) that shape the fold are part of the
    identity — resuming a sweep journaled under a different split
    would stitch batches onto the wrong keys.
    """
    ty = np.ascontiguousarray(np.asarray(test_y, np.float32))
    return engine.journal_fingerprint(
        np.asarray(test_points), batch_queries=batch_queries, pad_to=pad_to,
        kind="audit.sweep", k=int(k),
        chunk_points=None if chunk_points is None else int(chunk_points),
        y_sha1=hashlib.sha1(ty.tobytes()).hexdigest(),
        **extra,
    )


def _segmented_topk_negative(acc32: np.ndarray, k: int,
                             segment: int = SEGMENT, device=None):
    """The k most-negative entries of ``acc32``, deterministically.

    Device side (``device``; None: the CUDA device, raising without
    one): each fixed-width segment sorted stably by value, its first
    ``kk`` kept — the segment's least values, ties by row id (+inf
    padding can never win "most negative"). Host side: merge the S·kk
    candidates under the total order (value asc, row id asc) —
    ``lexsort`` is stable and the key is total, so ties break
    identically everywhere.
    """
    n = int(acc32.shape[0])
    segment = max(int(segment), 1)
    kk = min(int(k), segment, n)
    if kk <= 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.float32))
    s = -(-n // segment)
    padded = np.full(s * segment, np.inf, np.float32)
    padded[:n] = acc32
    acc = torch.as_tensor(padded.reshape(s, segment)).to(
        resolve_device(device))
    vals, idx = torch.sort(acc, dim=1, stable=True)
    cand_val = vals[:, :kk].cpu().numpy().ravel()
    cand_idx = (
        idx[:, :kk].cpu().numpy().astype(np.int64)
        + np.arange(s, dtype=np.int64)[:, None] * segment
    ).ravel()
    real = cand_idx < n  # padding slots of a short last segment
    cand_val, cand_idx = cand_val[real], cand_idx[real]
    order = np.lexsort((cand_idx, cand_val))[: int(k)]
    return cand_idx[order], cand_val[order]


def reverse_topk(model, test_points, test_y, *, k: int = 32,
                 engine=None, solver: str | None = None,
                 batch_queries: int = 256,
                 chunk_points: int | None = None,
                 pad_to: int | None = None, window: int = 4,
                 journal=None, deadline=None,
                 segment: int = SEGMENT) -> SweepResult:
    """Rank train rows by predicted harm to ``(test_points, test_y)``.

    ``chunk_points`` splits the test stream into outer chunks (one
    ``query_many`` workload each; None = single workload) and
    ``batch_queries`` the inner query batches — both are pure
    throughput knobs, the result is bitwise identical for any setting
    (module doc). ``journal``/``deadline`` thread straight through to
    the engine for resumable, cleanly-stoppable sweeps.
    """
    test_points = np.asarray(test_points, np.int64).reshape(-1, 2)
    test_y = np.asarray(test_y, np.float32).reshape(-1)
    if len(test_points) != len(test_y):
        raise ValueError("test_points and test_y disagree on length")
    if len(test_points) == 0:
        raise ValueError("reverse_topk needs at least one test point")
    if engine is None:
        engine = model.engine(solver)
    num_rows = len(model.data_sets["train"].x)
    sweep_id = hashlib.sha1(
        repr((int(model.state.step), test_points.tobytes(),
              test_y.tobytes(), int(k))).encode()
    ).hexdigest()[:12]

    # Residual weights once, over the WHOLE test set, before any
    # chunking: w_t = dL_t/dŷ_t for SSE.
    with torch.no_grad():
        preds = model.model.predict(
            model.state.params, torch.as_tensor(test_points).to(model.device))
    preds = preds.cpu().numpy().astype(np.float32)
    weights = 2.0 * (preds.astype(np.float64) - test_y.astype(np.float64))

    cp = len(test_points) if not chunk_points else int(chunk_points)
    starts = list(range(0, len(test_points), cp))
    acc = np.zeros(num_rows, np.float64)
    rows_scored = 0
    # sweep timing metadata: lands in logs and reports only, never in
    # the result's row ids or deltas
    t0 = time.monotonic()
    inject.fire(sites.AUDIT_SWEEP)
    with obs.span("audit.sweep", trace_seed=f"sweep-{sweep_id}",
                  sweep_id=sweep_id, test_points=len(test_points),
                  train_rows=num_rows, k=int(k), chunks=len(starts)):
        for ci, start in enumerate(starts):
            chunk = test_points[start : start + cp]
            jnl = (_PrefixJournal(journal, f"c{ci}:")
                   if journal is not None else None)
            results = engine.query_many(
                chunk, batch_queries=batch_queries, pad_to=pad_to,
                window=window, journal=jnl, deadline=deadline,
            )
            pos = start  # global test-point cursor, in stream order
            for res in results:
                idx_parts, val_parts = [], []
                for t in range(len(res.counts)):
                    rel = np.asarray(res.related_of(t), np.int64)
                    if len(rel):
                        idx_parts.append(rel)
                        s = np.asarray(res.scores_of(t), np.float64)
                        val_parts.append((weights[pos] + s) * s)
                    pos += 1
                if idx_parts:
                    idx = np.concatenate(idx_parts)
                    np.add.at(acc, idx, np.concatenate(val_parts))
                    rows_scored += len(idx)
        acc32 = acc.astype(np.float32)
        row_ids, deltas = _segmented_topk_negative(acc32, k, segment,
                                                   device=model.device)
    seconds = time.monotonic() - t0

    result = SweepResult(
        row_ids=row_ids, loss_deltas=deltas, group_scores=acc32,
        sweep_id=sweep_id, test_points=test_points,
        rows_scored=rows_scored, chunks=len(starts), seconds=seconds,
    )
    model._log_event(
        "audit.sweep", sweep_id=sweep_id,
        test_points=len(test_points), train_rows=num_rows,
        rows_scored=rows_scored, chunks=len(starts), k=int(k),
        seconds=round(seconds, 3), rows_per_s=round(result.rows_per_s, 1),
    )
    return result
