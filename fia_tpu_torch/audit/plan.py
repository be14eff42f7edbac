"""Unlearning plans: from a reverse sweep to a live, fenced apply (port
of ``fia_tpu/audit/plan.py``, plain numpy: the same plan ids, artifact
fingerprints and ``audit.apply`` line).

A plan is the auditable middle artifact between "these rows hurt the
test set" (:mod:`fia_tpu_torch.audit.reverse`) and "the serving model no
longer reflects them" (``stream.apply_removal``): a concrete row set,
an action, and the predicted test-loss delta the fidelity gate
(:mod:`fia_tpu_torch.audit.verify`) will hold it to. Plans round-trip
through the artifact-integrity layer (checksummed manifest + atomic
publish), so the thing that was applied is provably the thing that
was reviewed.

Predicted deltas are first-order: a removal plan's total is the sum
of its rows' group scores (group additivity per arXiv:2112.03052);
a reweight plan softening labels by ``y' = w·y + (1-w)·ŷ`` removes a
``(1-w)`` fraction of each row's residual pull, so its per-row delta
is ``(1-w)`` times the removal delta — a documented heuristic the
verify gate checks against real retraining.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import artifacts
from fia_tpu_torch.stream.update import UpdateResult, apply_removal

ACTIONS = ("remove", "reweight")


@dataclass
class UnlearnPlan:
    """A reviewed, appliable unlearning decision."""

    plan_id: str
    action: str               # "remove" | "reweight"
    row_ids: np.ndarray       # (R,) train rows, worst first
    per_row_delta: np.ndarray  # (R,) predicted test-SSE delta, plan-scaled
    predicted_delta: float    # Σ per_row_delta (first-order additive)
    reweight: float | None    # label weight w for "reweight", else None
    train_rows: int           # len(train) the row ids index into
    base_step: int            # model step the sweep ran against
    model_key: str
    test_points: np.ndarray   # (T, 2) the audited test set

    @property
    def rows(self) -> int:
        return len(self.row_ids)


def _plan_id(action: str, row_ids: np.ndarray, reweight,
             base_step: int, model_key: str) -> str:
    h = hashlib.sha1()
    h.update(action.encode())
    h.update(np.ascontiguousarray(row_ids, np.int64).tobytes())
    h.update(repr(None if reweight is None else float(reweight)).encode())
    h.update(str(int(base_step)).encode())
    h.update(model_key.encode())
    return h.hexdigest()[:12]


def build_plan(model, sweep, *, action: str = "remove",
               max_rows: int | None = None, reweight: float = 0.5,
               only_negative: bool = True) -> UnlearnPlan:
    """Turn a :class:`SweepResult` into an :class:`UnlearnPlan`.

    ``only_negative`` (default) keeps only rows whose removal is
    predicted to HELP the test set — deleting helpful rows is never
    what a data-debugging pass wants, and a sweep whose top-k ran out
    of negative rows pads with zeros/positives. ``max_rows`` caps the
    plan after that filter.
    """
    if action not in ACTIONS:
        raise ValueError(f"action must be one of {ACTIONS}, got {action!r}")
    rows = np.asarray(sweep.row_ids, np.int64)
    deltas = np.asarray(sweep.loss_deltas, np.float32)
    if only_negative:
        neg = deltas < 0
        rows, deltas = rows[neg], deltas[neg]
    if max_rows is not None:
        rows, deltas = rows[: int(max_rows)], deltas[: int(max_rows)]
    if len(rows) == 0:
        raise ValueError(
            "sweep yielded no candidate rows (no negative-influence "
            "rows found) — nothing to plan"
        )
    w = float(reweight) if action == "reweight" else None
    if w is not None and not (0.0 <= w < 1.0):
        raise ValueError("reweight must be in [0, 1)")
    per_row = deltas if w is None else (np.float32(1.0 - w) * deltas)
    return UnlearnPlan(
        plan_id=_plan_id(action, rows, w, model.state.step,
                         model.model_name),
        action=action, row_ids=rows, per_row_delta=per_row,
        predicted_delta=float(per_row.sum()), reweight=w,
        train_rows=len(model.data_sets["train"].x),
        base_step=int(model.state.step), model_key=model.model_name,
        test_points=np.asarray(sweep.test_points, np.int64),
    )


def _plan_fingerprint(plan: UnlearnPlan) -> dict:
    return {
        "kind": "audit.plan", "plan_id": plan.plan_id,
        "action": plan.action,
        "reweight": repr(plan.reweight),
        "train_rows": int(plan.train_rows),
        "base_step": int(plan.base_step),
        "model_key": plan.model_key,
        "predicted_delta": repr(plan.predicted_delta),
    }


def save_plan(plan: UnlearnPlan, path: str) -> str:
    """Durably publish ``plan`` (atomic npz + checksummed manifest)."""
    return artifacts.publish_npz(path, {
        "row_ids": np.asarray(plan.row_ids, np.int64),
        "per_row_delta": np.asarray(plan.per_row_delta, np.float32),
        "test_points": np.asarray(plan.test_points, np.int64),
    }, fingerprint=_plan_fingerprint(plan))


def load_plan(path: str) -> UnlearnPlan:
    """Verified read of a published plan (manifest required — an
    unattested plan must not reach the apply path)."""
    arrays = artifacts.load_npz(path, require_manifest=True)
    man = artifacts.read_manifest(path)
    fp = dict(man["fingerprint"])
    rw = fp["reweight"]  # repr of None or a float
    reweight = None if rw == "None" else float(rw)
    return UnlearnPlan(
        plan_id=fp["plan_id"], action=fp["action"],
        row_ids=arrays["row_ids"],
        per_row_delta=arrays["per_row_delta"],
        predicted_delta=float(np.asarray(
            arrays["per_row_delta"], np.float64).sum()),
        reweight=reweight,
        train_rows=int(fp["train_rows"]), base_step=int(fp["base_step"]),
        model_key=fp["model_key"], test_points=arrays["test_points"],
    )


def apply_plan(model, plan: UnlearnPlan, *, steps: int = 100,
               checkpoint_every: int | None = None,
               keep_checkpoints: int = 3) -> UpdateResult:
    """Flow ``plan`` through the live epoch-fenced unlearning loop.

    Delegates to ``stream.apply_removal`` (fine-tune on the shrunk/
    reweighted set → footprint projection → fenced swap with surgical
    invalidation; classified failures roll back and keep serving) and
    stamps the ``audit.apply`` metrics line + obs span around it. A
    plan built against a different train set is refused — row ids are
    positional, and applying them after the set changed would delete
    the wrong interactions.
    """
    if plan.train_rows != len(model.data_sets["train"].x):
        raise ValueError(
            f"stale plan: built against {plan.train_rows} train rows, "
            f"model now has {len(model.data_sets['train'].x)}"
        )
    with obs.span("audit.apply", trace_seed=f"plan-{plan.plan_id}",
                  plan_id=plan.plan_id, action=plan.action,
                  rows=plan.rows):
        res = apply_removal(
            model, plan.row_ids, steps=steps, reweight=plan.reweight,
            checkpoint_every=checkpoint_every,
            keep_checkpoints=keep_checkpoints,
        )
    model._log_event(
        "audit.apply", plan_id=plan.plan_id, action=plan.action,
        status=res.status, reason=res.reason,
        rows_removed=plan.rows if plan.action == "remove" else 0,
        rows_reweighted=plan.rows if plan.action == "reweight" else 0,
        predicted_delta=round(plan.predicted_delta, 6),
        steps=res.steps, touched_users=res.touched_users,
        touched_items=res.touched_items, seconds=round(res.seconds, 3),
    )
    return res
