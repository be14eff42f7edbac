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

from fia_tpu_torch.device import resolve_device
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("not ported yet — mesh: ROADMAP Queue A.13")


class Trainer:
    """Minibatch trainer on one device (``device=None``: the CUDA
    device, raising without one; ``"cpu"`` when asked). ``last_losses``
    holds, after :meth:`fit`, the loss of every step it ran, in order,
    as a tensor on the device. ``mesh`` takes the reference's place in
    the signature; data parallelism over a mesh is not ported (ROADMAP
    Queue A.13), so a non-None mesh raises."""

    def __init__(self, model, config: TrainConfig, event_log=None, mesh=None,
                 retry_policy: "rpolicy.RetryPolicy | None" = None,
                 clock: "rpolicy.Clock | None" = None, device=None):
        _no_mesh(mesh)
        self.model = model
        self.config = config
        self.retry_policy = _TRAIN_RETRY if retry_policy is None else retry_policy
        self.clock = rpolicy.WALL if clock is None else clock
        self.event_log = event_log  # utils.logging.EventLog or None
        self.device = resolve_device(device)
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
        """Adam over the batches ``rows`` ((steps, batch) indices)."""
        losses = []
        for idx in rows:
            loss, g = _loss_and_grads(self.model, params, x[idx], y[idx],
                                      w[idx])
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
    result. A non-None ``mesh`` (the reference's lane sharding) raises:
    ROADMAP Queue A.13.
    """
    _no_mesh(mesh)
    dev = resolve_device(device)
    x, y = _put(x, dev), _put(y, dev)
    n = x.shape[0]
    nb = n // batch_size
    if nb == 0:
        raise ValueError("batch_size larger than dataset")
    removed = np.asarray(removed_indices, np.int64).reshape(-1)
    R = removed.shape[0]
    seeds = (np.full(R, 17, np.uint32) if seeds is None
             else np.asarray(seeds).astype(np.uint32).reshape(-1))
    uniq, slot = np.unique(seeds, return_inverse=True)
    lane_slot = torch.as_tensor(slot.reshape(-1), dtype=torch.int64).to(dev)
    removed_t = torch.as_tensor(removed).to(dev)

    n_epochs = -(-num_steps // nb)
    seg_epochs = max(1, min(n_epochs, steps_per_dispatch // nb or 1))
    params0 = _place(params0, dev)
    params = {k: v.expand((R, *v.shape)).clone() for k, v in params0.items()}
    opt = adam_init(params, lanes=(R,))

    def run_epochs(params, opt, start: int):
        for e in range(start, min(start + seg_epochs, n_epochs)):
            # (D, nb, batch): one schedule per distinct seed
            sched = torch.stack([_schedule(int(s), e, n, nb, batch_size, dev)
                                 for s in uniq])
            for r in range(min(nb, num_steps - e * nb)):
                idx = sched[:, r][lane_slot]  # (R, batch)
                bw = (idx != removed_t[:, None]).to(torch.float32)
                _, g = _lane_loss_and_grads(model, params, x[idx], y[idx], bw)
                params, opt = adam_update(g, opt, params, learning_rate)
        return params, opt

    pol = _TRAIN_RETRY if retry_policy is None else retry_policy
    for start in range(0, n_epochs, seg_epochs):

        def dispatch_seg(params=params, opt=opt, start=start):
            inject.fire(sites.TRAINER_LOO_SEGMENT)
            out = run_epochs(params, opt, start)
            _fence(dev)
            return out

        params, opt = pol.run(dispatch_seg, retry_on=taxonomy.TRANSIENT,
                              clock=clock)
    return params
