"""The reference-shaped facade (port of ``fia_tpu/api.py``).

``FIAModel`` bundles model, trainer and influence engines behind the
method surface a user of the reference's ``GenericNeuralNet``/``MF``/
``NCF`` objects looks for (train / retrain / load_checkpoint /
get_influence_on_test_loss / get_train_indices_of_test_case /
print_model_eval / update_train_x_y ...), over the port's functional
core. Engines are built with ``cache_dir=train_dir``, so the factor bank
(``<train_dir>/factor/<model_name>-bank.npz``) and the iHVP cache live
beside the checkpoints, and every params or train-set change refreshes
the bank surgically.

``serve`` returns an online query service
(:class:`fia_tpu_torch.serve.InfluenceService`) that tracks the model:
every params or train-set change invalidates its caches.
``apply_updates`` and ``apply_removal`` are the write path
(:mod:`fia_tpu_torch.stream`): fine-tune on the grown or shrunk train
set, project onto the footprint, and swap under each service's epoch
fence, re-keying the untouched cache entries. With ``mesh`` (a
:class:`fia_tpu_torch.parallel.mesh.Mesh`) training is data parallel and
the engines shard their query batches over it. Initial
parameters come from the port's own generator (a ``torch.Generator``
seeded with ``seed``): they cannot equal the reference's ``jax.random``
draws (ROADMAP Queue C).
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.index import InteractionIndex
from fia_tpu_torch.influence import grads as G
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.full import FullInfluenceEngine
from fia_tpu_torch.influence.spectral import extreme_eigvals
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.parallel.mesh import mesh_device
from fia_tpu_torch.reliability.policy import FULL_SOLVERS, resolve_solver
from fia_tpu_torch.train import checkpoint
from fia_tpu_torch.train.trainer import Trainer, TrainConfig, TrainState

MODELS = {"MF": MF, "NCF": NCF}


class FIAModel:
    """One object with the reference's workflow methods.

    Args mirror the reference ctor kwargs (``RQ1.py:94-110``):
      model: 'MF' or 'NCF' (or a LatentFactorModel instance)
      num_users, num_items, embedding_size, weight_decay, batch_size,
      data_sets: {'train', 'validation', 'test': RatingDataset},
      initial_learning_rate, damping, avextol, train_dir, model_name,
      solver (the engines' default rung), seed (initial params and batch
      schedules), mesh (a ``data``-axis mesh the trainer and the engines
      run over; the model's device is then its first slot's; a 2-D
      ``('data', 'model')`` mesh row-shards the engines' tables), device
      (``None``: the CUDA device, raising without one; ``"cpu"``).
    """

    def __init__(
        self,
        model,
        num_users: int,
        num_items: int,
        embedding_size: int,
        weight_decay: float,
        batch_size: int,
        data_sets: dict,
        initial_learning_rate: float = 1e-3,
        damping: float = 1e-6,
        avextol: float = 1e-3,
        train_dir: str = "output",
        model_name: str = "fia_model",
        solver: str = "direct",
        seed: int = 0,
        mesh=None,
        device=None,
    ):
        if isinstance(model, str):
            model = MODELS[model](num_users, num_items, embedding_size,
                                  weight_decay)
        self.model = model
        self.device = mesh_device(mesh, device)
        self.data_sets = dict(data_sets)
        self.batch_size = int(batch_size)
        self.damping = float(damping)
        self.avextol = float(avextol)
        self.train_dir = train_dir
        self.model_name = model_name
        self.solver = solver
        self.seed = seed
        self.mesh = mesh
        self.learning_rate = float(initial_learning_rate)
        self._trainer = Trainer(
            model,
            TrainConfig(batch_size=batch_size, num_steps=0,
                        learning_rate=initial_learning_rate, seed=seed),
            mesh=mesh, device=self.device,
        )
        params = model.init_params(torch.Generator().manual_seed(seed),
                                   device=self.device)
        self.state = self._trainer.init_state(params)
        # engines keyed by solve configuration, rebuilt lazily after a
        # params or train-set change
        self._engines: dict = {}
        # derived state memoized on the identity of its inputs (datasets
        # and params dicts are replaced, never mutated)
        self._index_memo: tuple | None = None  # (x, y, InteractionIndex)
        self._host_params_memo: tuple | None = None  # (params, host dict)
        # serving layers derived from this model (FIAModel.serve), told
        # of every params or train-set change; weak, so a dropped
        # service is not kept alive by the model
        self._serving = weakref.WeakSet()

    # -- properties --------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    @property
    def num_train_examples(self) -> int:
        return self.data_sets["train"].num_examples

    def _checkpoint_path(self, step: int) -> str:
        return os.path.join(self.train_dir,
                            f"{self.model_name}-checkpoint-{step}")

    def engine(self, solver: str | None = None, **extra) -> InfluenceEngine:
        """The block engine at ``solver`` (``None``: the model's own,
        resolved down the ladder to a block rung), built once a
        configuration with ``cache_dir=train_dir``."""
        name = resolve_solver(solver, default=self.solver)
        key = (name, tuple(sorted(extra.items())))
        eng = self._engines.get(key)
        if eng is None:
            # an explicit mesh in extra (ServeConfig.mesh through
            # from_model) overrides the model's; the key was built before
            # the pop, so engines on different meshes coexist
            mesh = extra.pop("mesh", self.mesh)
            # a 2-D mesh with a 'model' axis row-shards the tables
            extra.setdefault("shard_tables", mesh is not None and int(
                mesh.shape.get("model", 1)) > 1)
            eng = self._engines[key] = InfluenceEngine(
                self.model, self.state.params, self.data_sets["train"],
                damping=self.damping, solver=name,
                cache_dir=self.train_dir, model_name=self.model_name,
                mesh=mesh, device=self.device, **extra,
            )
        return eng

    def _invalidate(self):
        """The params or train set moved: the published factor bank is
        refreshed (entries whose dependency digests still match survive,
        touched ones are dropped), engines are dropped (rebuilt lazily
        from the new state), and every serving layer clears its hot
        caches and memoized fingerprints."""
        self._refresh_factor_bank()
        self._engines.clear()
        for svc in list(self._serving):
            svc.invalidate()

    def _interaction_index(self) -> InteractionIndex:
        """The interaction index over the current train set, memoized on
        the train arrays' identity."""
        train = self.data_sets["train"]
        memo = self._index_memo
        if memo is None or memo[0] is not train.x or memo[1] is not train.y:
            self._index_memo = memo = (
                train.x, train.y,
                InteractionIndex(np.asarray(train.x), self.model.num_users,
                                 self.model.num_items),
            )
        return memo[2]

    def _host_params(self) -> dict:
        """Host copies of the current params, memoized on the params
        dict's identity (one device-to-host copy a state)."""
        params = self.state.params
        memo = self._host_params_memo
        if memo is None or memo[0] is not params:
            self._host_params_memo = memo = (
                params, {k: v.detach().cpu().numpy()
                         for k, v in params.items()})
        return memo[1]

    def _log_event(self, event: str, **fields) -> None:
        """Route a model-lifecycle event into the serving metrics JSONL:
        mirrored to every registered service's metrics log (the event
        names are declared in ``serve/metrics.py`` SCHEMA). With no
        serving layer attached, one :func:`obs.diag
        <fia_tpu_torch.obs.diag>` line on the event's channel."""
        recorder = {
            "stream.update": "record_update",
            "factor.refresh": "record_factor_refresh",
            "audit.sweep": "record_audit_sweep",
            "audit.apply": "record_audit_apply",
        }.get(event)
        sent = False
        for svc in list(self._serving):
            fn = getattr(svc.metrics, recorder, None) if recorder else None
            if fn is not None:
                fn(**fields)
                sent = True
        if not sent:
            body = " ".join(f"{k}={v}" for k, v in fields.items())
            obs.diag(event, body)

    def _refresh_factor_bank(self):
        """Surgical factor-bank invalidation on a params/train change
        (:func:`fia_tpu_torch.influence.factor.refresh_bank`). A missing
        bank is a no-op."""
        if not self.train_dir:
            return
        from fia_tpu_torch.influence import factor as fbank

        path = fbank.default_bank_path(self.train_dir, self.model_name)
        if not os.path.exists(path):
            return
        train = self.data_sets["train"]
        stats = fbank.refresh_bank(
            self.model, self._host_params(), np.asarray(train.x),
            np.asarray(train.y), self._interaction_index(), self.damping,
            path, self.model_name,
        )
        if stats["kept"] or stats["dropped"]:
            self._log_event("factor.refresh", kept=stats["kept"],
                            dropped=stats["dropped"],
                            model_key=self.model_name)

    def _register_serving(self, svc) -> None:
        self._serving.add(svc)

    def serve(self, config=None, solver: str | None = None, **engine_extra):
        """An online query service over this model
        (:class:`fia_tpu_torch.serve.InfluenceService`) on the model's
        device. The service tracks this model: retrain, checkpoint load
        and train-set mutation invalidate its caches automatically."""
        from fia_tpu_torch.serve import InfluenceService

        return InfluenceService.from_model(
            self, config=config, solver=solver, **engine_extra
        )

    # -- training (genericNeuralNet.py:367-449) ----------------------------
    def train(self, num_steps: int, iter_to_switch_to_batch: int | None = None,
              iter_to_switch_to_sgd: int | None = None,
              save_checkpoints: bool = True, verbose: bool = True,
              load_checkpoints: int | bool = False):
        if load_checkpoints:
            self.load_checkpoint(int(load_checkpoints), do_checks=False)
            done = int(load_checkpoints) + 1
        else:
            done = 0
        remaining = max(0, num_steps - done)
        # the switch thresholds are ABSOLUTE step indices (reference
        # semantics) but the resumed fit() counts from 0: shift them by
        # the steps already trained
        rel = lambda v: None if v is None else max(0, v - done)  # noqa: E731
        self._trainer.config.iter_to_switch_to_batch = rel(
            iter_to_switch_to_batch)
        self._trainer.config.iter_to_switch_to_sgd = rel(iter_to_switch_to_sgd)
        if remaining:
            train = self.data_sets["train"]
            self.state = self._trainer.fit(self.state, train.x, train.y,
                                           num_steps=remaining)
            self._invalidate()
        if save_checkpoints and num_steps > 0:
            checkpoint.save(self._checkpoint_path(num_steps - 1),
                            self.state.params, self.state.opt_state,
                            self.state.step)
        if verbose:
            self.print_model_eval()

    def retrain(self, num_steps: int, train: RatingDataset | None = None,
                reset_adam: bool = True):
        """Reference MF.retrain: reset the optimizer, run minibatch steps
        on the given (possibly leave-one-out) dataset."""
        train = self.data_sets["train"] if train is None else train
        self.state = self._trainer.retrain(self.state, train.x, train.y,
                                           num_steps=num_steps,
                                           reset_adam=reset_adam)
        self._invalidate()

    def load_checkpoint(self, iter_to_load: int, do_checks: bool = True):
        p, o, step = checkpoint.load(self._checkpoint_path(iter_to_load),
                                     self.state.params, self.state.opt_state)
        self.state = TrainState(p, o if o is not None else self.state.opt_state,
                                step)
        self._invalidate()
        if do_checks:
            self.print_model_eval()

    # -- evaluation (genericNeuralNet.py:304-340) ---------------------------
    def print_model_eval(self):
        m, p = self.model, self.state.params
        tr, te = self.data_sets["train"], self.data_sets["test"]
        dev = self.device
        trx, tryy = (torch.as_tensor(a).to(dev) for a in (tr.x, tr.y))
        tex, tey = (torch.as_tensor(a).to(dev) for a in (te.x, te.y))
        with torch.no_grad():
            loss_w = float(m.loss(p, trx, tryy))
            loss_wo = float(m.loss_no_reg(p, trx, tryy))
            test_loss = float(m.loss_no_reg(p, tex, tey))
            train_mae = float(m.mae(p, trx, tryy))
            test_mae = float(m.mae(p, tex, tey))
        g = torch.func.grad(lambda q: m.loss(q, trx, tryy))(p)
        gnorm = float(torch.linalg.norm(
            torch.cat([g[k].reshape(-1) for k in sorted(g)])))
        print(f"Train loss (w reg) on all data: {loss_w}\n"
              f"Train loss (w/o reg) on all data: {loss_wo}\n"
              f"Test loss (w/o reg) on all data: {test_loss}\n"
              f"Train acc on all data:  {train_mae}\n"
              f"Test acc on all data:   {test_mae}\n"
              f"Norm of the mean of gradients: {gnorm}")

    # -- influence (matrix_factorization.py:164-251) ------------------------
    def get_influence_on_test_loss(self, test_indices, train_idx=None,
                                   approx_type: str | None = None,
                                   approx_params=None, force_refresh=True,
                                   test_description=None,
                                   loss_type: str = "normal_loss"):
        if loss_type != "normal_loss":
            raise ValueError("loss must be normal_loss")
        eng = self.engine()
        if approx_type and approx_type not in (
            "direct", "cg", "lissa", "schulz", "precomputed"
        ):
            raise ValueError(
                f"unknown approx_type {approx_type!r}; "
                "use direct|cg|lissa|schulz|precomputed"
            )
        if (approx_type and approx_type != eng.solver) or approx_params:
            # approx_params keys are InfluenceEngine kwargs; engine()
            # keeps one engine a configuration across a solver sweep
            eng = self.engine(approx_type or eng.solver,
                              **(approx_params or {}))
        return eng.get_influence_on_test_loss(
            test_indices, self.data_sets["test"],
            force_refresh=force_refresh, test_description=test_description,
        )

    def get_train_indices_of_test_case(self, test_indices):
        if len(test_indices) != 1:
            raise ValueError("one test index at a time")
        u, i = self.data_sets["test"].x[test_indices[0]]
        return self.engine().index.related(int(u), int(i))

    def get_test_params(self, test_index):
        """The FIA block of a test point, as a dict of tensors."""
        u, i = self.data_sets["test"].x[test_index[0]]
        return self.model.extract_block(self.state.params, int(u), int(i))

    def get_inverse_hvp(self, v, approx_type=None, approx_params=None):
        """Full-parameter inverse HVP (genericNeuralNet.py:503-508):
        ``approx_type=None`` adopts the model's solver, resolved onto what
        the full-parameter engine supports (``direct`` → CG)."""
        full = FullInfluenceEngine(
            self.model, self.state.params, self.data_sets["train"],
            damping=self.damping, mesh=self.mesh, device=self.device,
            solver=resolve_solver(approx_type, default=self.solver,
                                  supported=FULL_SOLVERS),
            **(approx_params or {}),
        )
        return full.get_inverse_hvp(v)

    def find_eigvals_of_hessian(self, num_iters: int = 100):
        """Extreme eigenvalues of the full training-loss Hessian by
        (shifted) power iteration."""
        full = FullInfluenceEngine(
            self.model, self.state.params, self.data_sets["train"],
            damping=0.0, device=self.device,
        )
        lam_max, lam_min = extreme_eigvals(full._hvp, full.num_params,
                                           num_iters=num_iters,
                                           device=self.device)
        return float(lam_max), float(lam_min)

    def get_grad_of_influence_wrt_input(self, test_indices, train_indices):
        """∂(influence of a train row) / ∂(its embedding rows): ids are
        discrete, so the continuous analogue of the reference's input
        gradient is the gradient of ihvp · ∇_block L(z) with respect to
        the training row's own block. Returns a list of dicts, one a
        train index."""
        if len(test_indices) != 1:
            raise ValueError("one test index at a time")
        test_ds = self.data_sets["test"]
        train_ds = self.data_sets["train"]
        u, i = (int(v) for v in test_ds.x[test_indices[0]])
        res = self.engine().query_batch(np.array([[u, i]]))
        dev = self.device
        ihvp = torch.as_tensor(res.ihvp[0]).to(dev)
        model, params = self.model, self.state.params
        out = []
        for t in train_indices:
            xj = torch.as_tensor(train_ds.x[int(t)][None, :]).to(dev)
            yj = torch.as_tensor(train_ds.y[int(t)][None]).to(dev)
            uj, ij = int(train_ds.x[int(t)][0]), int(train_ds.x[int(t)][1])

            def influence_of_embeddings(emb, uj=uj, ij=ij, xj=xj, yj=yj):
                # this train row's block substituted, its block-restricted
                # loss gradient recomputed and dotted with the iHVP
                p2 = model.with_block(params, emb, uj, ij)
                g = G.block_loss_grad(model, p2, u, i, xj, yj)
                return torch.dot(g, ihvp)

            emb0 = model.extract_block(params, uj, ij)
            out.append(torch.func.grad(influence_of_embeddings)(emb0))
        return out

    # -- streaming updates -------------------------------------------------
    def apply_updates(self, new_interactions, new_y=None, steps: int = 100,
                      checkpoint_every: int | None = None):
        """Online model update: append interactions, fine-tune, swap.

        ``new_interactions``: (N, 2) int ids with ``new_y`` (N,) ratings,
        an (N, 3) combined [user, item, rating] array, or a
        :class:`~fia_tpu_torch.data.dataset.RatingDataset`. Fine-tunes
        ``steps`` minibatch steps on the grown train set (crash-safe:
        a killed update resumes bit-identically from its rotated
        checkpoints on the next identical call), then performs the
        epoch-fenced swap — registered services keep answering in-flight
        requests on the old params epoch, and only the touched (user,
        item) blocks are invalidated across the serve/factor-bank tiers.
        A classified failure rolls back to the old state and keeps
        serving. Returns a
        :class:`fia_tpu_torch.stream.update.UpdateResult`.
        """
        from fia_tpu_torch.stream.update import apply_updates as _apply

        return _apply(self, new_interactions, new_y=new_y, steps=steps,
                      checkpoint_every=checkpoint_every)

    def apply_removal(self, row_ids, steps: int = 100, reweight=None,
                      checkpoint_every: int | None = None):
        """Live unlearning: drop (or soften) train rows, fine-tune, swap.

        The removal counterpart of :meth:`apply_updates` (same
        epoch-fenced loop, same crash-safety and rollback): ``row_ids``
        index the CURRENT train set; with ``reweight=w`` in [0, 1) the
        rows stay but their labels soften to ``w·y + (1-w)·ŷ`` instead
        of being deleted. Typically reached through an audited
        :func:`fia_tpu_torch.audit.plan.apply_plan` rather than called
        raw. Returns a :class:`fia_tpu_torch.stream.update.UpdateResult`.
        """
        from fia_tpu_torch.stream.update import apply_removal as _apply

        return _apply(self, row_ids, steps=steps, reweight=reweight,
                      checkpoint_every=checkpoint_every)

    # -- dataset mutation (genericNeuralNet.py:870-891) ---------------------
    def update_train_x(self, new_x):
        ds = self.data_sets["train"]
        self.data_sets["train"] = RatingDataset(np.asarray(new_x), ds.y)
        self._invalidate()

    def update_train_x_y(self, new_x, new_y):
        self.data_sets["train"] = RatingDataset(np.asarray(new_x),
                                                np.asarray(new_y))
        self._invalidate()

    def update_test_x_y(self, new_x, new_y):
        self.data_sets["test"] = RatingDataset(np.asarray(new_x),
                                               np.asarray(new_y))

    def reset_datasets(self):
        """The reference rewinds each dataset's minibatch cursor; the
        port's batch schedules are a function of (seed, epoch)
        (``train/trainer.py:epoch_permutation``), so a dataset holds no
        cursor and this rewinds what has one."""
        for ds in self.data_sets.values():
            if ds is not None and hasattr(ds, "reset_batch"):
                ds.reset_batch()
