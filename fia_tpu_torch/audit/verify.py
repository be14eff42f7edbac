"""Fidelity verification: predicted unlearning deltas vs real retraining
(port of ``fia_tpu/audit/verify.py``: the same estimator, journal keys
and artifact fingerprint; the retraining lanes and their predictions
run on the model's device).

The reverse sweep's per-row loss deltas are influence predictions;
before a plan is trusted at scale, this module retrains the model on a
small slice with each candidate row actually left out (the RQ1
machinery — vmapped :func:`loo_retrain_many` lanes with a no-removal
bias lane) and compares the measured test-SSE deltas against the
plan's predictions.

The **fidelity gate**: sign agreement ≥ gate AND Spearman rank
correlation ≥ gate (default 0.9 each). Sign agreement is what deletion
decisions ride on ("does removing this row help or hurt"); Spearman is
what prioritization rides on ("are the worst rows really the worst").

Three estimator choices matter for getting a faithful measurement out
of noisy SGD retraining (each found the hard way; see the committed
gate artifact of the reference in ``output/``):

- **Related restriction.** A row's actual delta sums only over test
  points sharing its user or item — the block model predicts zero
  effect elsewhere, so unrelated points contribute retraining noise,
  not signal.
- **Same-seed pairwise differencing.** Each removal repeat is
  differenced against the bias-lane repeat with the SAME seed (same
  shuffle schedule), so shared optimization drift cancels per repeat
  before averaging.
- **Spread controls.** Rank fidelity among near-tied top-k rows is
  noise-bound; the verified slice should span the prediction range —
  pass the sweep's most-POSITIVE rows as ``control_rows`` so the gate
  measures discrimination (help vs harm), which is what decisions use.

Retraining lanes are journaled per chunk (reliability Journal, exact
numeric round-trip) so a killed verification resumes instead of
re-spending retrain compute, and the outcome publishes through the
artifact-integrity layer as a committed, checksummed record.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import artifacts
from fia_tpu_torch.train.trainer import loo_retrain_many

DEFAULT_GATE = 0.9


@dataclass
class VerifyResult:
    """Outcome of one :func:`verify_plan` run."""

    sign_agreement: float
    spearman: float
    predicted: np.ndarray   # (R,) removal-scale predicted SSE deltas
    actual: np.ndarray      # (R,) measured SSE deltas, drift-corrected
    row_ids: np.ndarray     # (R,) plan rows first, then controls
    plan_rows: int          # how many of row_ids came from the plan
    gate: float
    passed: bool


def _ranks(a: np.ndarray) -> np.ndarray:
    """Average-tie ranks (the standard Spearman convention)."""
    a = np.asarray(a, np.float64)
    order = np.argsort(a, kind="stable")
    ranks = np.empty(len(a), np.float64)
    ranks[order] = np.arange(len(a), dtype=np.float64)
    vals, inv, counts = np.unique(a, return_inverse=True,
                                  return_counts=True)
    sums = np.zeros(len(vals), np.float64)
    np.add.at(sums, inv, ranks)
    return sums[inv] / counts[inv]


def spearman(a, b) -> float:
    """Spearman rank correlation (0.0 on a degenerate constant input)."""
    ra, rb = _ranks(a), _ranks(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def sign_agreement(pred, actual) -> float:
    return float(np.mean(np.sign(pred) == np.sign(actual)))


def verify_fingerprint(model, plan, test_points, *, num_steps: int,
                       batch_size: int, learning_rate: float,
                       retrain_times: int, seed: int, max_rows: int,
                       control_rows=None) -> dict:
    """Journal identity of one verification run."""
    tp = np.ascontiguousarray(np.asarray(test_points, np.int64))
    cr = np.ascontiguousarray(
        np.zeros(0, np.int64) if control_rows is None
        else np.asarray(control_rows, np.int64))
    return {
        "kind": "audit.verify", "plan_id": plan.plan_id,
        "model_key": model.model_name,
        "base_step": int(model.state.step),
        "num_steps": int(num_steps), "batch_size": int(batch_size),
        "learning_rate": repr(float(learning_rate)),
        "retrain_times": int(retrain_times), "seed": int(seed),
        "max_rows": int(max_rows),
        "points_sha1": hashlib.sha1(tp.tobytes()).hexdigest(),
        "controls_sha1": hashlib.sha1(cr.tobytes()).hexdigest(),
    }


def verify_plan(model, plan, test_points, test_y, *, num_steps: int = 3000,
                batch_size: int = 256, learning_rate: float = 1e-3,
                retrain_times: int = 3, lane_chunk: int | None = None,
                max_rows: int = 8, seed: int = 0,
                control_rows=None, control_deltas=None,
                gate: float = DEFAULT_GATE, journal=None,
                artifact_path: str | None = None,
                mesh=None) -> VerifyResult:
    """Retrain-and-compare the first ``max_rows`` rows of ``plan``.

    The retraining default is deliberately *gentle* (lr 1e-3, many
    steps): influence predicts the counterfactual minimum NEAR the
    trained params, and a high-lr SGD walk lands on a different one —
    gentle fine-tuning from the trained params is the counterfactual
    the prediction is actually about. Predictions are rescaled to
    removal terms for a reweight plan (÷(1-w)): the LOO lanes
    physically remove rows.

    ``control_rows``/``control_deltas``: extra rows (typically the
    sweep's most-positive) with their predicted removal-scale deltas,
    appended to the verified slice (module doc, "Spread controls").

    ``journal``: an open reliability Journal (fingerprint from
    :func:`verify_fingerprint`) — finished lane chunks are recorded
    and skipped on resume. ``artifact_path``: publish the verdict as
    a checksummed npz artifact. ``mesh``: the lanes are sharded over
    its ``data`` slots (:func:`~fia_tpu_torch.train.trainer.
    loo_retrain_many`).
    """
    train = model.data_sets["train"]
    if plan.train_rows != len(train.x):
        raise ValueError(
            f"stale plan: built against {plan.train_rows} train rows, "
            f"model now has {len(train.x)}"
        )
    test_points = np.asarray(test_points, np.int64).reshape(-1, 2)
    test_y = np.asarray(test_y, np.float64).reshape(-1)
    rows = np.asarray(plan.row_ids, np.int64)[: int(max_rows)]
    predicted = np.asarray(plan.per_row_delta, np.float64)[: int(max_rows)]
    if plan.reweight is not None:
        predicted = predicted / (1.0 - float(plan.reweight))
    n_plan = len(rows)
    if control_rows is not None:
        rows = np.concatenate([rows, np.asarray(control_rows, np.int64)])
        predicted = np.concatenate(
            [predicted, np.asarray(control_deltas, np.float64)])

    params0 = model.state.params
    dev = model.device
    tx = torch.as_tensor(test_points).to(dev)

    # one vmapped program per chunk: R removal lanes + the bias lane,
    # each repeated retrain_times with distinct seeds (rq1 layout)
    lanes = np.concatenate([rows, [-1]])
    all_removed = np.repeat(lanes, retrain_times)
    all_seeds = np.tile(
        seed + np.arange(retrain_times), len(lanes)
    ).astype(np.uint32)
    lane_chunk = len(all_removed) if not lane_chunk else int(lane_chunk)
    pad = (-len(all_removed)) % lane_chunk
    padded_removed = np.concatenate(
        [all_removed, np.full(pad, -1, all_removed.dtype)])
    padded_seeds = np.concatenate(
        [all_seeds, np.full(pad, seed, all_seeds.dtype)])

    def pred_fn(stack):
        """(lanes, T) predictions of the stacked params, a lane at a
        time on the device."""
        lanes_n = next(iter(stack.values())).shape[0]
        with torch.no_grad():
            out = torch.stack([
                model.model.predict({k: v[r] for k, v in stack.items()}, tx)
                for r in range(lanes_n)])
        return out.cpu().numpy()

    chunks = []
    n_chunks = len(padded_removed) // lane_chunk
    with obs.span("audit.verify", trace_seed=f"plan-{plan.plan_id}",
                  plan_id=plan.plan_id, lanes=len(all_removed),
                  steps=int(num_steps), chunks=n_chunks):
        for ci, c in enumerate(range(0, len(padded_removed), lane_chunk)):
            key = f"lanes:{ci}"
            if journal is not None and journal.done(key):
                chunks.append(np.asarray(journal.get(key), np.float32))
                continue
            params_stack = loo_retrain_many(
                model.model, params0, train.x, train.y,
                padded_removed[c : c + lane_chunk],
                num_steps=num_steps, batch_size=batch_size,
                learning_rate=learning_rate,
                seeds=padded_seeds[c : c + lane_chunk], mesh=mesh,
                device=dev,
            )
            preds = np.asarray(pred_fn(params_stack), np.float32)
            if journal is not None:
                journal.record(key, preds)
            chunks.append(preds)
    preds = np.concatenate(chunks)[: len(all_removed)]
    preds = np.asarray(preds, np.float64).reshape(
        len(lanes), retrain_times, -1)

    train_x = np.asarray(train.x)
    bias = preds[-1]  # (retrain_times, T)
    actual = np.zeros(len(rows), np.float64)
    for i, j in enumerate(rows):
        u, it = train_x[j]
        mask = (test_points[:, 0] == u) | (test_points[:, 1] == it)
        # per-repeat same-seed difference against the bias lane, then a
        # NaN-robust mean (a diverged repeat drops out, rq1 idiom)
        d = (np.sum((preds[i][:, mask] - test_y[mask]) ** 2, axis=1)
             - np.sum((bias[:, mask] - test_y[mask]) ** 2, axis=1))
        with np.errstate(invalid="ignore"):
            actual[i] = np.nanmean(d)

    sa = sign_agreement(predicted, actual)
    sp = spearman(predicted, actual)
    result = VerifyResult(
        sign_agreement=sa, spearman=sp,
        predicted=predicted.astype(np.float32),
        actual=actual.astype(np.float32), row_ids=rows,
        plan_rows=n_plan, gate=float(gate),
        passed=bool(sa >= gate and sp >= gate),
    )
    if artifact_path:
        artifacts.publish_npz(artifact_path, {
            "row_ids": rows,
            "predicted": result.predicted,
            "actual": result.actual,
        }, fingerprint={
            "kind": "audit.verify", "plan_id": plan.plan_id,
            "sign_agreement": repr(round(sa, 6)),
            "spearman": repr(round(sp, 6)),
            "gate": repr(float(gate)), "passed": str(result.passed),
            "plan_rows": int(n_plan),
            "num_steps": int(num_steps),
            "retrain_times": int(retrain_times),
        })
    return result
