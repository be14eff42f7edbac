"""The streaming update loop: append → fine-tune → project → swap (port
of ``fia_tpu/stream/update.py``: the same order, ids, fingerprints and
metrics lines).

``apply_updates(model, new_x, new_y, steps)`` is the one write path for
online model updates (``FIAModel.apply_updates`` delegates here). The
loop is crash-safe and epoch-fenced:

1. **Append + fine-tune.** The new interactions are appended to the
   train set and the model fine-tunes ``steps`` minibatch steps on the
   grown set through the ordinary
   :class:`~fia_tpu_torch.train.trainer.Trainer` with a
   :class:`~fia_tpu_torch.train.checkpoint.PeriodicCheckpointer` under
   ``<train_dir>/stream/upd-<id>/``. A mid-update kill leaves rotated
   generations behind; the next call with the same arguments resumes via
   ``restore_latest_valid`` and — thanks to the trainer's absolute-step
   epoch keys — converges bit-identically to an uninterrupted run.
2. **Local-update projection.** The fine-tuned parameters are projected
   onto the update's footprint (:mod:`fia_tpu_torch.stream.footprint`):
   embedding/bias rows outside the touched user/item sets, and every
   global leaf, are pinned to their pre-update bytes. Untouched
   influence blocks therefore stay *bit-identical* — which is what makes
   surgical re-keying of caches sound (and what the factor bank's
   ``dep_crcs`` revalidation independently verifies).
3. **Epoch-fenced swap.** Each registered service fences its current
   (engine, fingerprint) under the serving epoch, the model state is
   swapped, the new engine is built (resident on the model's device)
   and the factor bank surgically refreshed, then every service advances
   its epoch: queued tickets admitted before the swap resolve against
   the fenced old state, new tickets against the new, and only touched
   blocks are dropped from the hot/disk tiers — untouched entries are
   re-keyed to the new fingerprint without recompute.

A classified failure (taxonomy kind) at any point rolls the model back
to the fenced old state and returns ``status="rolled_back"`` — serving
never stops and never answers from a half-swapped state. Unclassified
failures surface. Fault sites: ``stream.update`` fires at the start of
every attempt, ``stream.swap`` immediately before the commit touches
any model state.

``apply_removal`` is the unlearning twin: the delta is rows *leaving*
the train set (or having their labels softened toward the model's
prediction), but steps 1-3 are the same machinery — removed rows'
users/items are the footprint, and the ``audit.apply`` site replaces
``stream.update`` at attempt start.

The ids hash the host params in the reference's flattening order
(sorted keys, :func:`fia_tpu_torch.train.checkpoint.leaves`), so an
update or removal of the same params and rows has the reference's id,
checkpoint directory and fingerprint. The fine-tune, the new engine and
the reweight path's predictions run on the model's device.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.models.base import params_from_numpy
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.stream.footprint import Footprint, compute_footprint
from fia_tpu_torch.train import checkpoint
from fia_tpu_torch.train.trainer import TrainState


@dataclass
class UpdateResult:
    """Outcome of one :func:`apply_updates` call."""

    status: str  # "committed" | "rolled_back"
    update_id: str
    steps: int
    new_rows: int
    reason: str | None = None  # taxonomy kind on rollback
    base_step: int = 0
    resumed_step: int | None = None  # checkpoint step resumed from
    touched_users: int = 0
    touched_items: int = 0
    staleness_s: float = 0.0  # params-ready -> swap-complete window
    seconds: float = 0.0
    footprint: Footprint | None = None

    @property
    def committed(self) -> bool:
        return self.status == "committed"


def _leaf_tags(model, arr: np.ndarray) -> set:
    """The keying-axis tags ``factor._classify_leaves`` would assign."""
    tags = set()
    if arr.ndim >= 1 and arr.shape[0] == int(model.num_users):
        tags.add("user")
    if arr.ndim >= 1 and arr.shape[0] == int(model.num_items):
        tags.add("item")
    return tags or {"global"}


def project_params(model, old_host: dict, new_host: dict,
                   fp: Footprint) -> dict:
    """Project fine-tuned params onto the update footprint (host dicts
    of numpy arrays).

    Rows of user-keyed leaves outside ``fp.user_touched`` (and item-keyed
    outside ``fp.item_touched``) are restored to their pre-update bytes;
    global leaves are pinned entirely. An ambiguous leaf (leading dim
    matching BOTH table sizes) keeps a fine-tuned row only where user
    AND item are touched — a row visible to any untouched reader must
    not move (ambiguity costs update reach, never correctness, mirroring
    ``dep_crcs``' every-matching-axis hashing).

    The result is the strongest property surgical invalidation needs:
    every influence block outside the footprint computes bit-identically
    under the projected params.
    """

    def leaf(old, new):
        old = np.asarray(old)
        new = np.asarray(new)
        tags = _leaf_tags(model, old)
        if "global" in tags:
            return old
        if tags == {"user"}:
            keep_new = fp.user_touched
        elif tags == {"item"}:
            keep_new = fp.item_touched
        else:  # ambiguous: both axes must agree the row moved
            keep_new = fp.user_touched & fp.item_touched
        out = np.array(old)
        out[keep_new] = new[keep_new]
        return out

    return {k: leaf(old_host[k], new_host[k]) for k in sorted(old_host)}


def _hash_params(h, model) -> None:
    """The step, then every host leaf in the reference's order."""
    h.update(str(int(model.state.step)).encode())
    for leaf in checkpoint.leaves(model._host_params()):
        h.update(np.ascontiguousarray(leaf).tobytes())


def _update_id(model, new_x: np.ndarray, new_y: np.ndarray,
               steps: int) -> str:
    """Deterministic id binding this update to (base params, rows, steps)
    — a killed attempt and its resuming retry agree on the checkpoint
    directory and fingerprint."""
    h = hashlib.sha1()
    _hash_params(h, model)
    h.update(np.ascontiguousarray(new_x).tobytes())
    h.update(np.ascontiguousarray(new_y).tobytes())
    h.update(str(int(steps)).encode())
    return h.hexdigest()[:12]


def _coerce_rows(new_x, new_y):
    """Accept (N,2)+(N,), an (N,3) combined array, or a RatingDataset."""
    if isinstance(new_x, RatingDataset):
        return np.asarray(new_x.x, np.int32), np.asarray(new_x.y, np.float32)
    x = np.asarray(new_x)
    if new_y is None:
        if x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(
                "without new_y, new_x must be (N, 3) [user, item, rating]"
            )
        return np.asarray(x[:, :2], np.int32), np.asarray(x[:, 2], np.float32)
    return (
        np.asarray(x, np.int32).reshape(-1, 2),
        np.asarray(new_y, np.float32).reshape(-1),
    )


def _apply_fenced(model, prepare, *, steps: int, uid: str, fp_kind: str,
                  entry_site: str, new_rows: int,
                  checkpoint_every: int | None = None,
                  keep_checkpoints: int = 3) -> UpdateResult:
    """The shared fine-tune → project → epoch-fenced-swap core.

    ``prepare()`` runs after the entry fault site fires (so a site
    fault rolls back before any work) and returns
    ``(new_train, footprint, warm_x)``: the post-delta train set, the
    invalidation footprint, and one (user, item) row to pre-warm the
    new engine's dispatch with. Both write paths — append
    (:func:`apply_updates`) and removal/reweight
    (:func:`apply_removal`) — differ only in that closure.
    """
    clock = model._trainer.clock
    t0 = clock.monotonic()
    old_state = model.state
    old_train = model.data_sets["train"]
    base_step = int(old_state.step)
    ckpt_dir = (
        os.path.join(model.train_dir, "stream", f"upd-{uid}")
        if model.train_dir else None
    )
    cfg = model._trainer.config
    saved_switches = (cfg.iter_to_switch_to_batch, cfg.iter_to_switch_to_sgd)
    mutated = False
    resumed_step = None
    footprint = None
    try:
        inject.fire(entry_site)
        new_train, footprint, warm_x = prepare()

        fp = {
            "kind": fp_kind,
            "model_key": model.model_name,
            "base_step": base_step,
            "steps": int(steps),
            "update_sha": uid,
        }
        state = old_state
        if ckpt_dir:
            restored = checkpoint.restore_latest_valid(
                ckpt_dir, old_state.params, old_state.opt_state,
                fingerprint=fp, verbose=False,
            )
            if restored is not None:
                p, o, s = restored  # on the templates' (the model's) device
                state = TrainState(p, o, int(s))
                resumed_step = int(s)

        target_step = base_step + int(steps)
        remaining = target_step - int(state.step)
        if remaining > 0:
            ck = None
            if ckpt_dir:
                every = (max(1, int(steps) // 4) if checkpoint_every is None
                         else int(checkpoint_every))
                ck = checkpoint.PeriodicCheckpointer(
                    ckpt_dir, every=every, keep=keep_checkpoints,
                    fingerprint=fp,
                )
                ck._last_step = int(state.step)
            # incremental fine-tune is pure minibatch: a lingering
            # late-phase switch from a previous full train() must not
            # leak into the update (and must not vary across resumes)
            cfg.iter_to_switch_to_batch = None
            cfg.iter_to_switch_to_sgd = None
            with obs.span("stream.fit", trace_seed=f"update-{uid}",
                          update_id=uid, steps=remaining):
                state = model._trainer.fit(
                    state, new_train.x, new_train.y,
                    num_steps=remaining, checkpointer=ck,
                )

        # local-update projection: untouched blocks stay bit-identical
        old_host = model._host_params()
        new_host = {k: v.detach().cpu().numpy()
                    for k, v in state.params.items()}
        with obs.span("stream.project", trace_seed=f"update-{uid}",
                      update_id=uid):
            projected = project_params(model.model, old_host, new_host,
                                       footprint)
        t_ready = clock.monotonic()

        inject.fire(sites.STREAM_SWAP)  # last no-mutation-yet fault point
        mutated = True
        with obs.span("stream.fence_swap", trace_seed=f"update-{uid}",
                      update_id=uid, services=len(model._serving)):
            # fence first: each service pins its current (engine, fp)
            # under the serving epoch so queued tickets keep answering
            # on the state they were admitted against
            services = list(model._serving)
            for svc in services:
                svc.pin_epoch()
            model.state = TrainState(
                params_from_numpy(model.model, projected, model.device),
                state.opt_state, target_step,
            )
            model.data_sets["train"] = new_train
            model._engines.clear()
            model.engine()  # new engine resident before any fence drops
            model._refresh_factor_bank()  # dep_crc survivors re-keyed
            for svc in services:
                # hand over a WARM engine: build (on the card, capture)
                # the new engine's dispatch for the touched footprint
                # while queued tickets still answer on the fenced old
                # state — the first post-swap request must never pay a
                # build. A warmup failure means the new engine cannot
                # serve, so it (rightly) flows to the classified
                # rollback below.
                svc.warmup(warm_x)
            for svc in services:
                svc.advance_epoch(footprint)
        staleness_s = clock.monotonic() - t_ready
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        result = UpdateResult(
            status="committed", update_id=uid, steps=int(steps),
            new_rows=new_rows, base_step=base_step,
            resumed_step=resumed_step,
            touched_users=footprint.num_touched_users,
            touched_items=footprint.num_touched_items,
            staleness_s=staleness_s,
            seconds=clock.monotonic() - t0,
            footprint=footprint,
        )
    except Exception as e:
        kind = taxonomy.classify(e)
        if kind is None:
            raise
        # rollback: restore the fenced old state and keep serving on it.
        # Checkpoints stay on disk — a retry with the same arguments
        # resumes instead of restarting.
        if mutated:
            model.state = old_state
            model.data_sets["train"] = old_train
            model._engines.clear()
        result = UpdateResult(
            status="rolled_back", update_id=uid, steps=int(steps),
            new_rows=new_rows, reason=kind, base_step=base_step,
            resumed_step=resumed_step,
            touched_users=(footprint.num_touched_users if footprint else 0),
            touched_items=(footprint.num_touched_items if footprint else 0),
            seconds=clock.monotonic() - t0,
            footprint=footprint,
        )
    finally:
        cfg.iter_to_switch_to_batch = saved_switches[0]
        cfg.iter_to_switch_to_sgd = saved_switches[1]
    return result


def apply_updates(model, new_x, new_y=None, steps: int = 100,
                  checkpoint_every: int | None = None,
                  keep_checkpoints: int = 3) -> UpdateResult:
    """Run one streaming update against ``model`` (see module doc).

    ``checkpoint_every``: steps between rotated mid-update checkpoints
    (default ``max(1, steps // 4)``; saves land at the trainer's
    dispatch boundaries). Returns an :class:`UpdateResult`; a classified
    failure rolls back and reports, an unclassified one raises.
    """
    nx, ny = _coerce_rows(new_x, new_y)
    if len(nx) == 0:
        raise ValueError("apply_updates needs at least one new interaction")
    if nx[:, 0].min() < 0 or nx[:, 0].max() >= model.model.num_users or \
            nx[:, 1].min() < 0 or nx[:, 1].max() >= model.model.num_items:
        raise ValueError(
            "new interaction ids fall outside the model's user/item tables"
        )
    old_train = model.data_sets["train"]
    uid = _update_id(model, nx, ny, steps)

    def prepare():
        footprint = compute_footprint(
            np.asarray(old_train.x), nx,
            model.model.num_users, model.model.num_items,
        )
        new_train = RatingDataset(
            np.concatenate([np.asarray(old_train.x, np.int32), nx]),
            np.concatenate([np.asarray(old_train.y, np.float32), ny]),
        )
        return new_train, footprint, nx[:1]

    result = _apply_fenced(
        model, prepare, steps=steps, uid=uid, fp_kind="stream-update",
        entry_site=sites.STREAM_UPDATE, new_rows=len(nx),
        checkpoint_every=checkpoint_every,
        keep_checkpoints=keep_checkpoints,
    )
    model._log_event(
        "stream.update",
        update_id=result.update_id, status=result.status,
        reason=result.reason, steps=result.steps,
        new_rows=result.new_rows, base_step=result.base_step,
        resumed_step=result.resumed_step,
        touched_users=result.touched_users,
        touched_items=result.touched_items,
        staleness_ms=round(result.staleness_s * 1e3, 3),
        seconds=round(result.seconds, 3),
    )
    return result


def _removal_id(model, row_ids: np.ndarray, tag: str, steps: int) -> str:
    """Deterministic id binding a removal/reweight to (base params, rows,
    action, steps) — the resuming retry of a killed unlearning apply
    agrees on the checkpoint directory and fingerprint."""
    h = hashlib.sha1()
    _hash_params(h, model)
    h.update(tag.encode())
    h.update(np.ascontiguousarray(row_ids).tobytes())
    h.update(str(int(steps)).encode())
    return h.hexdigest()[:12]


def apply_removal(model, row_ids, steps: int = 100,
                  reweight: float | None = None,
                  checkpoint_every: int | None = None,
                  keep_checkpoints: int = 3) -> UpdateResult:
    """Unlearn training rows through the same epoch-fenced loop.

    ``row_ids``: indices into the current train set. ``reweight=None``
    deletes the rows outright (the GDPR path); ``reweight=w`` with
    ``0 <= w < 1`` keeps them but softens each label toward the model's
    own prediction, ``y' = w*y + (1-w)*ŷ`` — at ``w=0`` the row carries
    no residual signal, so the label-noise-triage path shades into
    deletion continuously. Everything downstream is shared with
    :func:`apply_updates`: the removed rows' users/items are the
    footprint delta (second-order reach through the OLD adjacency,
    exactly the read set the removed rows participated in), fine-tuning
    runs on the shrunk set, untouched blocks are projected back to
    their pre-update bytes, and the swap is epoch-fenced with surgical
    invalidation and classified-failure rollback. Fault site:
    ``audit.apply`` fires at the start of every attempt (the swap keeps
    its own ``stream.swap`` site).
    """
    old_train = model.data_sets["train"]
    rows = np.unique(np.asarray(row_ids, np.int64).reshape(-1))
    if len(rows) == 0:
        raise ValueError("apply_removal needs at least one row to unlearn")
    if rows[0] < 0 or rows[-1] >= len(old_train.x):
        raise ValueError(
            "row ids fall outside the current train set "
            f"(0..{len(old_train.x) - 1})"
        )
    if reweight is not None and not (0.0 <= float(reweight) < 1.0):
        raise ValueError("reweight must be in [0, 1) — 1.0 is a no-op")
    tag = "remove" if reweight is None else f"reweight:{float(reweight)!r}"
    uid = _removal_id(model, rows, tag, steps)

    def prepare():
        old_x = np.asarray(old_train.x, np.int32)
        old_y = np.asarray(old_train.y, np.float32)
        removed_x = old_x[rows]
        footprint = compute_footprint(
            old_x, removed_x,
            model.model.num_users, model.model.num_items,
        )
        if reweight is None:
            keep = np.ones(len(old_x), bool)
            keep[rows] = False
            new_train = RatingDataset(old_x[keep], old_y[keep])
        else:
            w = np.float32(reweight)
            rx = torch.as_tensor(removed_x, dtype=torch.int64).to(
                model.device)
            with torch.no_grad():
                preds = model.model.predict(model.state.params, rx)
            preds = preds.detach().cpu().numpy().astype(np.float32)
            new_y = np.array(old_y)
            new_y[rows] = w * old_y[rows] + (np.float32(1.0) - w) * preds
            new_train = RatingDataset(old_x, new_y)
        return new_train, footprint, removed_x[:1]

    return _apply_fenced(
        model, prepare, steps=steps, uid=uid, fp_kind="audit-apply",
        entry_site=sites.AUDIT_APPLY, new_rows=len(rows),
        checkpoint_every=checkpoint_every,
        keep_checkpoints=keep_checkpoints,
    )
