"""RQ1: influence against leave-one-out retraining (port of
``fia_tpu/eval/rq1.py:30-173``).

Parity target: reference ``src/influence/experiments.py:17-150``
(``test_retraining``) driven by ``src/scripts/RQ1.py:142-165``: for one
test interaction, predict the rating change from removing each selected
training row by influence, measure the actual change by retraining
without it, and correlate.

The reference retrains sequentially (num_to_remove × retrain_times
runs). Here every (removed row, repeat) pair — the no-removal drift
lanes included — is one lane of :func:`~fia_tpu_torch.train.trainer.
loo_retrain_many`, in fixed-size chunks of lanes padded with -1 lanes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.train.trainer import loo_retrain_many


@dataclass
class RetrainResult:
    actual_y_diffs: np.ndarray  # (R,) retraining ground truth
    predicted_y_diffs: np.ndarray  # (R,) influence predictions
    indices_to_remove: np.ndarray  # (R,) positions into the related set
    removed_train_rows: np.ndarray  # (R,) train-row ids
    bias_retrain: float  # no-removal drift (subtracted from actuals)
    # raw per-repeat retrained predictions, (R+1, retrain_times): row r
    # holds lane r's repeats, the final row the no-removal drift lane
    per_repeat_y: np.ndarray = None
    y0: float = 0.0  # original (pre-removal) prediction on the test point


def test_retraining(
    engine: InfluenceEngine,
    train: RatingDataset,
    test_ds: RatingDataset,
    test_idx: int,
    num_to_remove: int = 50,
    num_steps: int = 1000,
    batch_size: int = 100,
    learning_rate: float = 1e-3,
    retrain_times: int = 4,
    remove_type: str = "maxinf",
    random_seed: int = 17,
    clamp: float = 1.0,
    lane_chunk: int = 32,
    steps_per_dispatch: int = 2000,
    verbose: bool = True,
    mesh=None,
    event_log=None,
) -> RetrainResult:
    """Run the RQ1 experiment for one test point, on ``engine``'s
    device and params.

    remove_type: 'maxinf' picks the |influence|-largest related rows
    (reference ``experiments.py:36-48``); 'random' samples uniformly from
    the related set (numpy ``default_rng(random_seed)``, as the
    reference). ``mesh``: the retraining lanes are sharded over its
    ``data`` slots (:func:`~fia_tpu_torch.train.trainer.loo_retrain_many`).
    """

    def stage(msg):
        if verbose:
            obs.diag(
                "rq1",
                f"{time.strftime('%H:%M:%S')} test {test_idx}: {msg}",
            )

    model = engine.model
    params0 = engine.full_params()
    rng = np.random.default_rng(random_seed)

    point = test_ds.x[test_idx]
    res = engine.query_batch(point[None, :])
    scores = res.scores_of(0)
    related = res.related_of(0)
    stage(f"influence query done ({len(related)} related rows)")
    if event_log is not None:
        event_log.log("influence_query", test_idx=int(test_idx),
                      related=int(len(related)))

    if remove_type == "maxinf":
        # descending |influence|, first num_to_remove — a [-n:] slice
        # would select EVERYTHING for n=0
        sel = np.argsort(np.abs(scores))[::-1][:num_to_remove].copy()
    elif remove_type == "random":
        sel = rng.choice(len(related), size=min(num_to_remove, len(related)),
                         replace=False)
    else:
        raise ValueError(f"remove_type {remove_type!r} not well specified")

    predicted = scores[sel]
    removed_rows = related[sel]

    # Original prediction on the test point.
    tx = torch.as_tensor(np.asarray(point[None, :], np.int32)).to(engine.device)
    with torch.no_grad():
        y0 = float(model.predict(params0, tx)[0])

    # (num_to_remove + 1) removal lanes x retrain_times repeats; lane -1
    # removes nothing and measures retraining drift.
    lanes = np.concatenate([removed_rows, [-1]])
    all_removed = np.repeat(lanes, retrain_times)
    all_seeds = np.tile(
        random_seed + np.arange(retrain_times), len(lanes)
    ).astype(np.uint32)

    # Lanes run in fixed-size chunks, keeping peak memory independent of
    # num_to_remove x retrain_times.
    lane_chunk = max(int(lane_chunk), 1)
    pad_lanes = (-len(all_removed)) % lane_chunk
    padded_removed = np.concatenate(
        [all_removed, np.full(pad_lanes, -1, all_removed.dtype)]
    )
    padded_seeds = np.concatenate(
        [all_seeds, np.full(pad_lanes, random_seed, all_seeds.dtype)]
    )
    chunks = []
    n_chunks = len(padded_removed) // lane_chunk
    stage(f"retraining {len(all_removed)} lanes x {num_steps} steps "
          f"({n_chunks} chunks of {lane_chunk})")
    for ci, c in enumerate(range(0, len(padded_removed), lane_chunk)):
        t0 = time.time()
        params_stack = loo_retrain_many(
            model, params0, train.x, train.y, padded_removed[c : c + lane_chunk],
            num_steps=num_steps, batch_size=batch_size,
            learning_rate=learning_rate, seeds=padded_seeds[c : c + lane_chunk],
            steps_per_dispatch=steps_per_dispatch, mesh=mesh,
            device=engine.device,
        )
        with torch.no_grad():
            preds = torch.func.vmap(lambda p: model.predict(p, tx)[0])(
                params_stack)
        chunks.append(preds.cpu().numpy())
        stage(f"retrain chunk {ci + 1}/{n_chunks} done")
        if event_log is not None:
            event_log.log("retrain_chunk", test_idx=int(test_idx),
                          chunk=ci + 1, of=n_chunks, lanes=int(lane_chunk),
                          steps=int(num_steps), secs=round(time.time() - t0, 3))
    preds = np.concatenate(chunks)[: len(all_removed)]
    preds = preds.reshape(len(lanes), retrain_times)

    # NaN-robust means (reference drops NaN retrain outcomes,
    # experiments.py:136-137).
    with np.errstate(invalid="ignore"):
        lane_means = np.nanmean(preds, axis=1)
    bias = float(lane_means[-1] - y0)
    actual = lane_means[:-1] - y0 - bias

    # |predicted| > clamp is zeroed (reference experiments.py:139-140).
    predicted = np.where(np.abs(predicted) > clamp, 0.0, predicted)

    return RetrainResult(
        actual_y_diffs=np.asarray(actual),
        predicted_y_diffs=np.asarray(predicted),
        indices_to_remove=np.asarray(sel),
        removed_train_rows=np.asarray(removed_rows),
        bias_retrain=bias,
        per_repeat_y=np.asarray(preds, np.float32),
        y0=y0,
    )
