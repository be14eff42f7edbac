"""Minibatch training and leave-one-out retraining (port of
``fia_tpu/train/trainer.py``).

The reference's protocol: Adam on the total loss over epoch-shuffled
exact-divisor minibatches, then optionally full-batch Adam from
``iter_to_switch_to_batch`` and full-batch SGD at 10x the learning rate
from ``iter_to_switch_to_sgd`` (``trainer.py:175-280``); the Adam state
reset before retraining (``:85-87``, ``:282-288``); and leave-one-out
retraining as lanes stacked on a leading axis, each lane masking its
removed row out of the loss (``:378-496``).

Where the reference scans a whole epoch in one XLA program, this port
runs eager PyTorch, one step at a time: a step is a gather, the loss, one
backward and an update per tensor. The leave-one-out lanes are stacked,
so one step costs the same launches for 32 lanes as for 1
(``torch.func.vmap`` over the model's own loss, one backward).

Adam and SGD are plain functions over the parameter dict in optax's
formula (:func:`adam_update`, :func:`sgd_update`); their state is the
pytree the reference checkpoints (``ScaleByAdamState(count, mu, nu)``,
:mod:`fia_tpu_torch.train.checkpoint`) and works unchanged on stacked
lanes.

Batch schedules are drawn on the host by :func:`epoch_permutation`, a
function of (seed, epoch) alone, so a run's batches do not depend on
``steps_per_dispatch``, the lane chunking or the step a run resumed
from. The draws cannot match ``jax.random``'s (ROADMAP Queue C); the
tests hand the reference's permutations to this one function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fia_tpu_torch.parallel import distributed as pdist
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy

# Transient device failures during a training dispatch retry on this
# schedule; updates are out of place (params in, params out), so a
# retried dispatch replays its segment exactly. Unclassified failures
# surface at once.
_TRAIN_RETRY = rpolicy.RetryPolicy(
    max_attempts=3, base_delay=2.0, max_delay=30.0, jitter=0.25
)

# optax.adam's defaults (optax/_src/alias.py: b1, b2, eps, eps_root = 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2**31 - 1


@dataclass
class TrainConfig:
    batch_size: int
    num_steps: int
    learning_rate: float = 1e-3
    seed: int = 0
    iter_to_switch_to_batch: int | None = None  # full-batch Adam after this step
    iter_to_switch_to_sgd: int | None = None  # full-batch SGD (10x lr) after this
    log_every: int = 0  # 0 = silent


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the int32 step ``count`` (a scalar,
    or one per lane when stacked) and the first and second moments, each
    a dict shaped like the params."""

    count: torch.Tensor
    mu: dict
    nu: dict


@dataclass
class TrainState:
    params: dict
    opt_state: AdamState
    step: int = 0


# -- the optimizers ---------------------------------------------------------
def adam_init(params: dict, lanes: tuple = ()) -> AdamState:
    """Zero moments and count; ``lanes`` is the leading shape of stacked
    params (``(R,)``), which the count takes."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(torch.zeros(lanes, dtype=torch.int32, device=dev), zeros,
                     {k: torch.zeros_like(v) for k, v in params.items()})


def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the count's shape) broadcastable against ``like``."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def adam_update(grads: dict, state: AdamState, params: dict,
                learning_rate: float) -> tuple[dict, AdamState]:
    """One Adam step out of place, in optax's formula and order
    (``scale_by_adam`` then ``scale_by_learning_rate``, then
    ``apply_updates``): m = (1-b1)g + b1 m, v = (1-b2)g² + b2 v, the bias
    corrections 1 - b**count in float32, u = m̂ / (sqrt(v̂ + 0) + eps),
    p + u·(-lr)."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    count = torch.where(state.count < _INT32_MAX, state.count + 1,
                        state.count)
    # the scalar base is taken in float32; no tensor is made from a host
    # scalar, which on the card would wait for a copy
    cf = count.to(torch.float32)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    new_p, mu, nu = {}, {}, {}
    for k, g in grads.items():
        m = (1 - b1) * g + b1 * state.mu[k]
        v = (1 - b2) * (g * g) + b2 * state.nu[k]
        u = (m / _lead(bc1, m)) / (torch.sqrt(v / _lead(bc2, v)) + eps)
        new_p[k] = params[k] + u * (-learning_rate)
        mu[k], nu[k] = m, v
    return new_p, AdamState(count, mu, nu)


def sgd_update(grads: dict, params: dict, learning_rate: float) -> dict:
    """``optax.sgd`` without momentum (stateless): p + g·(-lr)."""
    return {k: params[k] + g * (-learning_rate) for k, g in grads.items()}


# -- batch schedules --------------------------------------------------------
def epoch_permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """The (n,) row permutation of epoch ``epoch`` under ``seed``: a CPU
    ``torch.Generator`` seeded from (seed, epoch) alone. Every schedule
    of the port — ``Trainer.fit``'s minibatches and each
    ``loo_retrain_many`` lane — comes from here."""
    g = torch.Generator().manual_seed(rpolicy._mix64(int(seed), int(epoch)))
    return torch.randperm(n, generator=g)


def _schedule(seed: int, epoch: int, n: int, nb: int, batch: int,
              device: torch.device) -> torch.Tensor:
    """(nb, batch) int64 row indices of one epoch on ``device``: the
    permutation's first nb·batch rows (the ragged tail is dropped, as in
    the reference). The copy to the card does not block the host."""
    perm = epoch_permutation(seed, epoch, n).to(torch.int64)
    sched = perm[: nb * batch].reshape(nb, batch)
    if device.type == "cuda":
        return sched.pin_memory().to(device, non_blocking=True)
    return sched


def _place(params: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device)
            for k, v in params.items()}


def _put(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device)


def _loss_and_grads(model, params: dict, x, y, w):
    """(loss, grads) of ``model.loss`` at ``params`` on rows (x, y, w)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = model.loss(leaves, x, y, w)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _lane_loss_and_grads(model, params: dict, x, y, w):
    """Stacked lanes: ((R,) losses, grads) of each lane's own loss, with
    params (R, ...) and rows x (R, B, 2), y and w (R, B). One backward
    through the summed losses gives every lane its own gradient."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    losses = torch.func.vmap(model.loss)(leaves, x, y, w)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    return losses.detach(), dict(zip(leaves, grads))


def _fence(device: torch.device) -> None:
    """Wait for the card at a dispatch boundary, so a device failure
    surfaces inside the retried dispatch that caused it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_devices(tensors: tuple, devices) -> dict:
    """``tensors`` on each device of ``devices`` (no copy where they
    already are): the per-physical-device replicas of a mesh."""
    return {dev: tuple(t.to(dev) for t in tensors) for dev in devices}


def _mesh_loss_and_grads(model, params: dict, reps: dict, slots, idx,
                         batch_p: int):
    """(loss, grads) of ``model.loss`` on the minibatch ``idx``, data
    parallel over the mesh's ``data`` slots: the batch is padded to
    ``batch_p`` (a multiple of the slot count) with zero-weight
    positions, slot k takes positions ``[k b, (k+1) b)`` (b = batch_p /
    slots) and computes, on its device, the gradient of its rows'
    weighted error sum; the partial gradients, error sums and weight sums
    are added in slot order on the params' device, then divided by the
    batch's weight (``_weighted_mean``'s clamp at 1) and the L2 term's
    gradient added. Every slot is queued before any partial is summed.
    Over a mesh spanning processes each process computes its own slots'
    partials and every process sums all of them, all-gathered, in the
    same slot order (``slots`` of another process's are ``None``)."""
    home = next(iter(params.values())).device
    n = idx.shape[0]
    pad = batch_p - n
    idx = torch.cat([idx, idx.new_zeros(pad)])
    posw = torch.cat([torch.ones(n, device=home),
                      torch.zeros(pad, device=home)])
    b = batch_p // len(slots)
    on_dev = {dev: params if dev == home
              else {k: v.to(dev) for k, v in params.items()}
              for dev in reps}
    parts = []
    me = pmesh.process_index()
    for k, slot in enumerate(slots):
        if int(slot.process_index) != me:
            parts.append(None)
            continue
        dev = slot.device
        x, y, w = reps[dev]
        sl = idx[k * b:(k + 1) * b].to(dev)
        bw = w[sl] * posw[k * b:(k + 1) * b].to(dev)
        leaves = {kk: v.detach().requires_grad_(True)
                  for kk, v in on_dev[dev].items()}
        err = torch.sum(model.indiv_loss(leaves, x[sl], y[sl]) * bw)
        g = torch.autograd.grad(err, list(leaves.values()),
                                allow_unused=True)
        parts.append((err.detach(), torch.sum(bw),
                      {kk: torch.zeros_like(leaves[kk]) if gi is None else gi
                       for kk, gi in zip(leaves, g)}))
    parts = pdist.fill_shards(parts)
    err, wsum, grads = parts[0][0].to(home), parts[0][1].to(home), \
        {kk: gi.to(home) for kk, gi in parts[0][2].items()}
    for e, ws, g in parts[1:]:
        err, wsum = err + e.to(home), wsum + ws.to(home)
        grads = {kk: grads[kk] + g[kk].to(home) for kk in grads}
    wsum = torch.clamp(wsum, min=1.0)
    leaves = {kk: v.detach().requires_grad_(True) for kk, v in params.items()}
    reg = model.reg_loss(leaves)
    greg = torch.autograd.grad(reg, list(leaves.values()), allow_unused=True)
    grads = {kk: grads[kk] / wsum + (0.0 if gr is None else gr)
             for kk, gr in zip(leaves, greg)}
    return err / wsum + reg.detach(), grads


class Trainer:
    """Minibatch trainer (``device=None``: the CUDA device, raising
    without one; ``"cpu"`` when asked). ``last_losses`` holds, after
    :meth:`fit`, the loss of every step it ran, in order, as a tensor on
    the device.

    With ``mesh`` (a :class:`fia_tpu_torch.parallel.mesh.Mesh` with a
    ``data`` axis) each minibatch step is data parallel over the mesh's
    ``data`` slots (:func:`_mesh_loss_and_grads`): params stay on the
    mesh's first slot's device, the train rows are replicated once per
    physical device, and a batch size that does not divide the slot
    count (the reference's exact divisors, 3020 / 3009) is padded with
    zero-weight positions, which the weighted mean ignores exactly. The
    full-batch phases run on the first slot's device, as the
    reference's do."""

    def __init__(self, model, config: TrainConfig, event_log=None, mesh=None,
                 retry_policy: "rpolicy.RetryPolicy | None" = None,
                 clock: "rpolicy.Clock | None" = None, device=None):
        self.model = model
        self.config = config
        self.retry_policy = _TRAIN_RETRY if retry_policy is None else retry_policy
        self.clock = rpolicy.WALL if clock is None else clock
        self.event_log = event_log  # utils.logging.EventLog or None
        self.mesh = mesh
        self.device = pmesh.mesh_device(mesh, device)
        self.last_losses = None

    # -- state -------------------------------------------------------------
    def init_state(self, params) -> TrainState:
        params = _place(params, self.device)
        return TrainState(params, adam_init(params), 0)

    def reset_optimizer(self, state: TrainState) -> TrainState:
        """Reference ``reset_optimizer_op`` (genericNeuralNet.py:438-440)."""
        return TrainState(state.params, adam_init(state.params), state.step)

    # -- the step loops ----------------------------------------------------
    def _minibatch_steps(self, params, opt, x, y, w, rows):
        """Adam over the batches ``rows`` ((steps, batch) indices), data
        parallel over the mesh's slots with one."""
        losses = []
        if self.mesh is not None:
            slots = pmesh.data_slots(self.mesh)
            reps = _on_devices((x, y, w), pmesh.physical_devices(self.mesh))
            nd = len(slots)
            batch_p = -(-rows.shape[1] // nd) * nd
        for idx in rows:
            if self.mesh is None:
                loss, g = _loss_and_grads(self.model, params, x[idx],
                                          y[idx], w[idx])
            else:
                loss, g = _mesh_loss_and_grads(self.model, params, reps,
                                               slots, idx, batch_p)
            params, opt = adam_update(g, opt, params,
                                      self.config.learning_rate)
            losses.append(loss)
        return params, opt, torch.stack(losses)

    def _full_steps(self, params, opt, x, y, w, n_steps: int, use_sgd: bool):
        """``n_steps`` full-batch Adam steps, or SGD at 10x the rate."""
        lr = self.config.learning_rate
        losses = []
        for _ in range(n_steps):
            loss, g = _loss_and_grads(self.model, params, x, y, w)
            if use_sgd:
                params = sgd_update(g, params, lr * 10.0)
            else:
                params, opt = adam_update(g, opt, params, lr)
            losses.append(loss)
        return params, opt, losses

    # -- public API --------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        x,
        y,
        weights=None,
        num_steps: int | None = None,
        checkpointer=None,
    ) -> TrainState:
        """Run ``num_steps`` training steps (cfg.num_steps by default).

        ``checkpointer`` (a ``train.checkpoint.PeriodicCheckpointer``)
        publishes a rotated checkpoint generation at epoch-segment
        boundaries, so a killed run restarts from the last good
        generation via ``restore_latest_valid`` instead of step 0. A
        resumed run (any ``state.step``) replays exactly the batches an
        unbroken run would have used.
        """
        cfg = self.config
        dev = self.device
        num_steps = cfg.num_steps if num_steps is None else num_steps
        n = x.shape[0]
        batch = cfg.batch_size
        nb = n // batch
        if nb == 0:
            raise ValueError("batch_size larger than dataset")
        x, y = _put(x, dev), _put(y, dev)
        w = (torch.ones((n,), dtype=torch.float32, device=dev)
             if weights is None else _put(weights, dev).to(torch.float32))

        switch_b = cfg.iter_to_switch_to_batch
        switch_b = num_steps if switch_b is None else switch_b
        switch_s = cfg.iter_to_switch_to_sgd
        switch_s = num_steps if switch_s is None else switch_s
        mini_steps = min(num_steps, switch_b)
        # switch_s <= switch_b keeps the reference's phase test order
        # (genericNeuralNet.py:388-398): minibatch until switch_b, then
        # SGD at once — the full-batch Adam phase is empty
        batch_steps = max(0, min(num_steps, switch_s) - mini_steps)
        sgd_steps = num_steps - mini_steps - batch_steps

        params = _place(state.params, dev)
        opt = state.opt_state
        losses = []
        done = 0
        while done < mini_steps:
            abs_step = state.step + done
            epoch_i, r = divmod(abs_step, nb)
            todo = min(nb - r, mini_steps - done)
            rows = _schedule(cfg.seed, epoch_i, n, nb, batch, dev)[r: r + todo]

            def dispatch_epoch(params=params, opt=opt, rows=rows):
                inject.fire(sites.TRAINER_EPOCH)
                out = self._minibatch_steps(params, opt, x, y, w, rows)
                _fence(dev)
                return out

            params, opt, seg = self.retry_policy.run(
                dispatch_epoch, retry_on=taxonomy.TRANSIENT, clock=self.clock,
            )
            losses.append(seg)
            done += todo
            if checkpointer is not None:
                checkpointer.maybe(params, opt, state.step + done)
            if cfg.log_every and ((epoch_i + 1) % max(1, cfg.log_every // nb) == 0):
                # fialint: disable=FIA402 -- interactive step-progress stdout
                print(f"step {state.step + done}: "
                      f"loss = {float(seg[-1]):.6f}")
            if self.event_log is not None:
                self.event_log.log(
                    "train_epoch", epoch=epoch_i, step=state.step + done,
                    loss=float(seg[-1]),
                )

        if batch_steps > 0:
            params, opt, seg = self._full_steps(params, opt, x, y, w,
                                                batch_steps, use_sgd=False)
            losses.append(torch.stack(seg))
        if sgd_steps > 0:
            # the SGD phase leaves the Adam state as it was (the
            # reference returns it, not SGD's empty state)
            params, _, seg = self._full_steps(params, None, x, y, w,
                                              sgd_steps, use_sgd=True)
            losses.append(torch.stack(seg))
        self.last_losses = (torch.cat(losses) if losses else
                            torch.zeros((0,), device=dev))
        return TrainState(params, opt, state.step + num_steps)

    def retrain(self, state: TrainState, x, y, weights=None,
                num_steps: int | None = None, reset_adam: bool = True) -> TrainState:
        """Reference MF.retrain: reset Adam, then minibatch steps
        (``matrix_factorization.py:69-76``; NCF skips the reset)."""
        if reset_adam:
            state = self.reset_optimizer(state)
        return self.fit(state, x, y, weights=weights, num_steps=num_steps)


def loo_retrain_many(
    model,
    params0,
    x,
    y,
    removed_indices,
    num_steps: int,
    batch_size: int,
    learning_rate: float = 1e-3,
    seeds=None,
    steps_per_dispatch: int = 2000,
    mesh=None,
    retry_policy: "rpolicy.RetryPolicy | None" = None,
    clock: "rpolicy.Clock | None" = None,
    device=None,
) -> dict:
    """Leave-one-out retraining, the lanes stacked on a leading axis.

    The RQ1 ground truth retrains the model once per removed training
    row (reference ``experiments.py:109-133``, strictly sequential).
    Here all R retrains step together: each lane masks its removed row
    out of the loss through a weight vector, and a removed index of -1
    removes nothing (the retraining-drift lane, reference
    ``experiments.py:94-106``). Every lane starts from ``params0`` with
    a fresh Adam state and runs exactly ``num_steps`` minibatch steps.
    ``seeds`` (R,) picks each lane's schedule (default 17, as uint32 as
    in the reference); lanes with equal seeds share one, drawn once.
    Returns the (R, ...) stacked params on the device.

    ``steps_per_dispatch`` sets where the dispatch boundaries fall
    (whole epochs, at least one): each is one retried unit with the
    ``trainer.loo_segment`` injection site. It does not change the
    result.

    With ``mesh`` (a ``data`` axis) the lane axis is sharded over the
    mesh's ``data`` slots with no collective: the lanes are padded to a
    multiple of the slot count with copies of the last lane, slot k
    steps its contiguous group of lanes on its device, and the padding
    lanes are sliced away; the stacked params come back on the mesh's
    first slot's device, each lane the single-device run's lane up to
    float reassociation (a slot steps fewer lanes at once: ~1e-7 at
    ML-1M shape). Over a mesh spanning processes each process steps its
    own slots' lanes and the lanes are all-gathered in slot order.
    """
    dev = pmesh.mesh_device(mesh, device)
    x, y = _put(x, dev), _put(y, dev)
    n = x.shape[0]
    nb = n // batch_size
    if nb == 0:
        raise ValueError("batch_size larger than dataset")
    removed = np.asarray(removed_indices, np.int64).reshape(-1)
    R = removed.shape[0]
    seeds = (np.full(R, 17, np.uint32) if seeds is None
             else np.asarray(seeds).astype(np.uint32).reshape(-1))
    if mesh is None:
        groups = [(dev, removed, seeds)]
    else:
        nd = int(mesh.shape["data"])
        pad = (-R) % nd
        removed = np.concatenate([removed, np.repeat(removed[-1:], pad)])
        seeds = np.concatenate([seeds, np.repeat(seeds[-1:], pad)])
        q = len(removed) // nd
        me = pmesh.process_index()
        groups = [(s.device if int(s.process_index) == me else None,
                   removed[k * q:(k + 1) * q], seeds[k * q:(k + 1) * q])
                  for k, s in enumerate(pmesh.data_slots(mesh))]
    everyone = groups
    groups = [g for g in groups if g[0] is not None]
    data = _on_devices((x, y), {g[0] for g in groups})
    params0 = _place(params0, dev)

    n_epochs = -(-num_steps // nb)
    seg_epochs = max(1, min(n_epochs, steps_per_dispatch // nb or 1))

    def lanes(gdev, rem, sd):
        """One group's schedule keys and its stacked params and Adam
        state on ``gdev``."""
        uniq, slot = np.unique(sd, return_inverse=True)
        p = {k: v.to(gdev).expand((len(rem), *v.shape)).clone()
             for k, v in params0.items()}
        return (uniq, torch.as_tensor(slot.reshape(-1),
                                      dtype=torch.int64).to(gdev),
                torch.as_tensor(rem).to(gdev)), (p, adam_init(p,
                                                             (len(rem),)))

    keys, states = zip(*(lanes(*g) for g in groups))

    def run_epochs(gdev, key, params, opt, start: int):
        uniq, lane_slot, removed_t = key
        gx, gy = data[gdev]
        for e in range(start, min(start + seg_epochs, n_epochs)):
            # (D, nb, batch): one schedule per distinct seed
            sched = torch.stack([_schedule(int(s), e, n, nb, batch_size,
                                           gdev) for s in uniq])
            for r in range(min(nb, num_steps - e * nb)):
                idx = sched[:, r][lane_slot]  # (R, batch)
                bw = (idx != removed_t[:, None]).to(torch.float32)
                _, g = _lane_loss_and_grads(model, params, gx[idx], gy[idx],
                                            bw)
                params, opt = adam_update(g, opt, params, learning_rate)
        return params, opt

    pol = _TRAIN_RETRY if retry_policy is None else retry_policy
    for start in range(0, n_epochs, seg_epochs):

        def dispatch_seg(states=states, start=start):
            inject.fire(sites.TRAINER_LOO_SEGMENT)
            out = tuple(run_epochs(g[0], key, p, o, start)
                        for g, key, (p, o) in zip(groups, keys, states))
            for gdev in data:
                _fence(gdev)
            return out

        states = pol.run(dispatch_seg, retry_on=taxonomy.TRANSIENT,
                         clock=clock)
    mine = iter(p for p, _ in states)
    lanes_of = pdist.fill_shards([None if g[0] is None else next(mine)
                                  for g in everyone])
    if len(lanes_of) == 1:
        return lanes_of[0]
    return {k: torch.cat([p[k].to(dev) for p in lanes_of])[:R]
            for k in lanes_of[0]}
