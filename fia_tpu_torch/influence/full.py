"""Full-parameter (non-block) influence engine (port of
``fia_tpu/influence/full.py``).

Inverse-HVPs in the FULL parameter space by CG or minibatched LiSSA over
the whole training set, and the Koh & Liang influence of every training
row on a test loss or prediction:
``predicted_loss_diff_j = (H⁻¹ v) · ∇_θ L(z_j) / N``.

Parameters are one flat vector (``hvp.ravel_params``: sorted names, each
leaf row-major, the reference's ``ravel_pytree`` order on a dict). An HVP
is forward-over-reverse ``jvp(grad)`` (``torch.func``); with
``hvp_batch`` it runs over row chunks of the train tensors to bound the
live set. Scoring all N rows needs no per-example gradient: for a fixed
direction u, ∇L_j · u for every j is ONE forward-mode ``jvp`` of the
per-example loss vector.

LiSSA's minibatches come from an explicit ``torch.Generator`` seeded with
the call's ``seed``; they are not the reference's ``jax.random`` draws
(ROADMAP Queue C), so results agree in distribution, not in bits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import solvers
from fia_tpu_torch.influence.engine import _on
from fia_tpu_torch.influence.hvp import ravel_params
from fia_tpu_torch.parallel import distributed as pdist
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, sites
from fia_tpu_torch.reliability import policy as rpolicy


class FullInfluenceEngine:
    """Full-parameter Koh & Liang influence over a trained model.

    Args:
      model, params, train: the model, its parameter dict (tensors or
        numpy arrays) and the training RatingDataset.
      damping: added to every HVP (λ v).
      solver: ``cg`` or ``lissa`` (:data:`policy.FULL_SOLVERS`; resolve
        other names with ``policy.resolve_solver``).
      cg_maxiter, cg_tol: CG's iteration cap and relative tolerance.
      lissa_scale, lissa_depth: LiSSA's scale and recursion depth.
      lissa_batch: LiSSA's HVP minibatch (0: full-batch HVPs).
      lissa_samples: averaged recursions (> 1 only with lissa_batch).
      hvp_batch: rows a chunk of the HVP and the scoring jvp (0: one
        full-batch program).
      mesh: a :class:`fia_tpu_torch.parallel.mesh.Mesh` with a ``data``
        axis: the train rows are sharded along it (contiguous, equal
        shards; ``n % ndata`` trailing rows are dropped, as the
        reference does, so the influence is over the kept rows), each
        slot takes its shard's partial HVP and scores on its device, and
        the partial HVPs are summed in slot order on the first slot's
        device (no collective, no atomics). ``hvp_batch`` then rounds up
        to a multiple of ``ndata``, each slot's chunk being
        ``hvp_batch / ndata`` of its rows. Over a mesh spanning
        processes, each process computes its own slots' partials and
        dots, all-gathered to every process and summed (concatenated) in
        the same slot order, so the result is the one-process mesh's.
      residual_guard: a solve whose relative residual exceeds this (or is
        non-finite) escalates ``lissa → cg``; ``None`` screens NaNs only.
      device: ``None`` (the CUDA device; raises without one), ``"cuda"``
        or ``"cpu"``.
    """

    def __init__(
        self,
        model,
        params,
        train: RatingDataset,
        damping: float = 1e-6,
        solver: str = "cg",
        cg_maxiter: int = 100,
        cg_tol: float = 1e-8,
        lissa_scale: float = 10.0,
        lissa_depth: int = 10_000,  # reference depth, genericNeuralNet.py:544
        lissa_batch: int = 0,
        lissa_samples: int = 1,
        hvp_batch: int = 0,
        mesh=None,
        residual_guard: float | None = None,
        device=None,
    ):
        if solver not in rpolicy.FULL_SOLVERS:
            # the factor bank holds BLOCK inverses; the full-parameter
            # Hessian cannot even be materialised, so 'precomputed' (and
            # 'direct'/'schulz') must be resolved away first
            raise ValueError(
                f"unknown solver {solver!r} for the full-parameter engine "
                f"(supported: {rpolicy.FULL_SOLVERS}); route requests "
                "through policy.resolve_solver")
        self.model = model
        self.mesh = mesh
        self.device = pmesh.mesh_device(mesh, device)
        self.damping = float(damping)
        self.solver = solver
        self.cg_maxiter = int(cg_maxiter)
        self.cg_tol = float(cg_tol)
        self.lissa_scale = float(lissa_scale)
        self.lissa_depth = int(lissa_depth)
        self.lissa_batch = int(lissa_batch)
        self.lissa_samples = int(lissa_samples)
        self.residual_guard = (None if residual_guard is None
                               else float(residual_guard))
        self.params = {k: torch.as_tensor(v, dtype=torch.float32)
                       .to(self.device) for k, v in params.items()}
        self._flat0, self._unravel = ravel_params(self.params)
        self.num_params = int(self._flat0.shape[0])
        x, y = np.asarray(train.x), np.asarray(train.y)
        ndata = 1 if mesh is None else int(mesh.shape["data"])
        keep = len(x) - len(x) % ndata  # equal shards: drop the remainder
        self.train_x = torch.as_tensor(x[:keep]).to(self.device)
        self.train_y = torch.as_tensor(y[:keep]).to(self.device)
        self.num_train = int(self.train_x.shape[0])
        self.hvp_batch = int(hvp_batch)
        if self.hvp_batch > 0:
            # a chunk larger than the train set would only add dead rows
            b = max(1, min(self.hvp_batch, self.num_train))
            self.hvp_batch = -(-b // ndata) * ndata
        # the row shards, each (x, y, flat0) on its data slot's device (a
        # contiguous view of the rows where the slot shares the engine's
        # device); without a mesh, one shard of every row
        self._shards = [(self.train_x, self.train_y, self._flat0)]
        if mesh is not None:
            m = self.num_train // ndata
            flat0 = {dev: self._flat0.to(dev)
                     for dev in pmesh.physical_devices(mesh)}
            me = pmesh.process_index()
            self._shards = [
                (self.train_x[k * m:(k + 1) * m].to(s.device),
                 self.train_y[k * m:(k + 1) * m].to(s.device),
                 flat0[s.device]) if int(s.process_index) == me else None
                for k, s in enumerate(pmesh.data_slots(mesh))]
        #: CG's loop count of the last solve (None after LiSSA)
        self.last_iterations: int | None = None
        self._warm: set = set()

    # -- core pieces -------------------------------------------------------
    @staticmethod
    def _chunks(x, y, b: int):
        """``(x, y, w)`` row chunks of ``b`` rows; the ragged tail
        re-reads row 0 at weight 0."""
        n = x.shape[0]
        for c0 in range(0, n, b):
            gidx = c0 + torch.arange(b, device=x.device)
            idx = torch.where(gidx < n, gidx, 0)
            yield x[idx], y[idx], (gidx < n).to(torch.float32)

    def _chunked(self) -> bool:
        return 0 < self.hvp_batch < self.num_train

    def _jvp_of_grad(self, f, v, flat0=None):
        flat0 = self._flat0 if flat0 is None else flat0
        return torch.func.jvp(torch.func.grad(f), (flat0,), (v,))[1]

    def _total(self, f):
        return self.model.loss(self._unravel(f), self.train_x, self.train_y)

    def _linearized_hvp(self):
        """:meth:`_hvp` with the full-batch jvp traced once
        (``torch.func.linearize``), for LiSSA's thousands of steps; the
        chunked HVP stays eager."""
        if self._chunked() or self.mesh is not None:
            return self._hvp
        _, jvp_fn = torch.func.linearize(torch.func.grad(self._total),
                                         self._flat0)
        return lambda v: jvp_fn(v) + self.damping * v

    def _hvp(self, v: torch.Tensor) -> torch.Tensor:
        """H v + damping v of the total training loss (mean squared error
        + L2) over all rows, for a flat (D,) direction."""
        model, unravel = self.model, self._unravel
        if self.mesh is None and not self._chunked():
            return self._jvp_of_grad(self._total, v) + self.damping * v
        err_hv = self._shard_hvp(v)
        reg_hv = self._jvp_of_grad(lambda f: model.reg_loss(unravel(f)), v)
        return err_hv / self.num_train + reg_hv + self.damping * v

    def _shard_b(self) -> int | None:
        """Rows a chunk of one shard (``hvp_batch / ndata``), or None
        when unchunked."""
        if not self._chunked():
            return None
        return self.hvp_batch // len(self._shards)

    def _shard_hvp(self, v: torch.Tensor) -> torch.Tensor:
        """Σ_j ∇²L_j v over the row shards: each shard's partial on its
        device (its rows in chunks of ``hvp_batch / ndata`` when
        chunked), every shard queued before any partial is read back, the
        partials summed in shard order on the engine's device."""
        model, unravel = self.model, self._unravel
        b = self._shard_b()
        parts = []
        for shard in self._shards:
            if shard is None:
                parts.append(None)
                continue
            x, y, flat0 = shard
            vd = v.to(flat0.device)
            with _on(flat0.device):
                if b is None:
                    part = self._jvp_of_grad(
                        lambda f: torch.sum(model.indiv_loss(unravel(f), x,
                                                             y)), vd, flat0)
                else:
                    part = torch.zeros_like(vd)
                    for cx, cy, w in self._chunks(x, y, b):
                        part = part + self._jvp_of_grad(
                            lambda f: torch.sum(
                                model.indiv_loss(unravel(f), cx, cy) * w),
                            vd, flat0)
            parts.append(part)
        parts = pdist.fill_shards(parts)
        total = parts[0].to(self.device)
        for part in parts[1:]:
            total = total + part.to(self.device)
        return total

    def _lissa_sample_hvp(self, generator: torch.Generator):
        """The j-th LiSSA step's HVP on a fresh minibatch of
        ``lissa_batch`` rows drawn from ``generator`` (the steps run in
        order, so the draws are sequential)."""
        model, unravel, n, b = self.model, self._unravel, self.num_train, \
            self.lissa_batch

        def sample_hvp(j, v):
            idx = torch.randint(0, n, (b,), generator=generator,
                                device=generator.device).to(self.device)
            x, y = self.train_x[idx], self.train_y[idx]
            hv = self._jvp_of_grad(lambda f: model.loss(unravel(f), x, y), v)
            return hv + self.damping * v

        return sample_hvp

    def test_loss_grad(self, test_x, test_y) -> torch.Tensor:
        """v = ∇_θ of the mean test loss WITHOUT regularisation (reference
        ``grad_loss_no_reg_op``, genericNeuralNet.py:154)."""
        tx = torch.as_tensor(np.asarray(test_x)).to(self.device)
        ty = torch.as_tensor(np.asarray(test_y)).to(self.device)
        return torch.func.grad(
            lambda f: self.model.loss_no_reg(self._unravel(f), tx, ty)
        )(self._flat0)

    def _solve(self, v: torch.Tensor, seed: int, solver: str):
        if solver == "cg":
            x, it = solvers.solve_cg(self._hvp, v, maxiter=self.cg_maxiter,
                                     tol=self.cg_tol)
            self.last_iterations = it
            return x
        if solver == "lissa":
            self.last_iterations = None
            sample = None
            if self.lissa_batch:
                gen = torch.Generator(device="cpu").manual_seed(int(seed))
                sample = self._lissa_sample_hvp(gen)
            return solvers.solve_lissa(
                self._linearized_hvp(), v, scale=self.lissa_scale,
                recursion_depth=self.lissa_depth, sample_hvp=sample,
                num_samples=self.lissa_samples if self.lissa_batch else 1)
        raise ValueError(f"unknown solver {solver!r}")

    def get_inverse_hvp(self, v, seed: int = 0) -> torch.Tensor:
        """Solve H x = v, guarded against silent divergence: a non-finite
        solution, or (with ``residual_guard``) a relative residual above
        the guard, escalates down the ladder (``lissa → cg``) and
        re-solves. Escalation is sticky."""
        v = torch.as_tensor(v, dtype=torch.float32).to(self.device)
        solver = self.solver
        while True:
            x = self._solve(v, seed, solver)
            xh = inject.corrupt(sites.FULL_SOLVE, x.cpu().numpy())
            bad = not np.isfinite(xh).all()
            reason = "non-finite inverse-HVP"
            if not bad and self.residual_guard is not None:
                rr = self.relative_residual(v, x)
                if not np.isfinite(rr) or rr > self.residual_guard:
                    bad = True
                    reason = (f"relative residual {rr:.3g} over guard "
                              f"{self.residual_guard:g}")
            if not bad:
                return x
            nxt = rpolicy.next_solver(solver, rpolicy.FULL_SOLVER_FALLBACK)
            if nxt is None:
                obs.diag("reliability",
                         f"{reason} from {solver!r} with no "
                         "fallback rung left; returning as-is")
                return torch.as_tensor(xh).to(self.device)
            obs.diag("reliability",
                     f"{reason} from {solver!r}; escalating "
                     f"solver to {nxt!r}")
            obs.REGISTRY.counter(
                "engine.solver_escalations",
                **{"from": solver, "to": nxt}
            ).inc()
            self.solver = solver = nxt

    def relative_residual(self, v, x) -> float:
        """‖Hx − v‖ / ‖v‖ of a solve, at one extra HVP."""
        v = torch.as_tensor(v, dtype=torch.float32).to(self.device)
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return float(solvers.relative_residual(self._hvp, v, x))

    def _score_all(self, u: torch.Tensor) -> torch.Tensor:
        """∇_θ L_total(z_j) · u / N for every train row j: the per-example
        error's jvp plus the constant ∇reg · u, by row chunks with
        ``hvp_batch``."""
        model, unravel, n = self.model, self._unravel, self.num_train
        reg_dot = torch.func.jvp(lambda f: model.reg_loss(unravel(f)),
                                 (self._flat0,), (u,))[1]
        return (self._shard_dots(u) + reg_dot) / n

    def _shard_dots(self, u: torch.Tensor) -> torch.Tensor:
        """∇L_j · u of every kept row, each shard's on its device (in
        chunks when chunked; the ragged tail's re-reads of row 0 drop),
        concatenated in shard order on the engine's device."""
        model, unravel = self.model, self._unravel
        b = self._shard_b()
        out = []
        for shard in self._shards:
            if shard is None:
                out.append(None)
                continue
            x, y, flat0 = shard
            ud = u.to(flat0.device)
            with _on(flat0.device):
                if b is None:
                    d = torch.func.jvp(
                        lambda f: model.indiv_loss(unravel(f), x, y),
                        (flat0,), (ud,))[1]
                else:
                    d = torch.cat([
                        torch.func.jvp(
                            lambda f: model.indiv_loss(unravel(f), cx, cy),
                            (flat0,), (ud,))[1]
                        for cx, cy, _ in self._chunks(x, y, b)
                    ])[: x.shape[0]]
            out.append(d)
        return torch.cat([d.to(self.device) for d in pdist.fill_shards(out)])

    # -- public API --------------------------------------------------------
    def get_influence_on_test_loss(self, test_x, test_y, seed: int = 0
                                   ) -> np.ndarray:
        """Predicted test-LOSS change per removed train row, (N,)."""
        v = self.test_loss_grad(test_x, test_y)
        ihvp = self.get_inverse_hvp(v, seed=seed)
        return self._score_all(ihvp).cpu().numpy()

    def _pred_grad(self, tx: torch.Tensor) -> torch.Tensor:
        return torch.func.grad(
            lambda f: torch.mean(self.model.predict(self._unravel(f), tx))
        )(self._flat0)

    def get_influence_on_test_prediction(self, test_x, seed: int = 0,
                                         return_residual: bool = False):
        """Predicted test-PREDICTION change per removed train row (the
        quantity FIA approximates in the block subspace).
        ``return_residual``: also the solve's relative residual (one extra
        HVP)."""
        tx = torch.as_tensor(np.asarray(test_x)).to(self.device)
        v = self._pred_grad(tx)
        ihvp = self.get_inverse_hvp(v, seed=seed)
        scores = self._score_all(ihvp).cpu().numpy()
        if return_residual:
            return scores, self.relative_residual(v, ihvp)
        return scores

    def precompile(self, n_test: int = 1) -> dict:
        """Run each query-path program once on ``n_test`` test rows (the
        test-loss and prediction gradients, one HVP of the current
        solver, the all-rows scoring jvp), so the first real query pays
        no library set-up (cuBLAS handles, allocator pools). PyTorch runs
        eagerly: there is no program to compile, and the reference's AOT
        executables have no counterpart. Returns ``{"compiled": [names],
        "cached": [names], "seconds"}`` (``compiled``: warmed now)."""
        t0 = time.perf_counter()
        tx = self.train_x[:n_test]
        ty = self.train_y[:n_test]
        jobs = {
            ("test_loss_grad", n_test): lambda: self.test_loss_grad(
                tx.cpu(), ty.cpu()),
            ("pred_grad", n_test): lambda: self._pred_grad(tx),
            ("solve", self.solver): lambda: self._hvp(self._flat0),
            ("score_all",): lambda: self._score_all(self._flat0),
        }
        compiled, cached = [], []
        for key, run in jobs.items():
            if key in self._warm:
                cached.append(key[0])
                continue
            run()
            self._warm.add(key)
            compiled.append(key[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"compiled": compiled, "cached": cached,
                "seconds": time.perf_counter() - t0}
