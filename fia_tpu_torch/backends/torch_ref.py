"""CPU reference FIA engine (torch autograd): the port's copy of
``fia_tpu/backends/torch_ref.py``.

A faithful re-implementation of the reference's FIA hot path for MF
(``matrix_factorization.py:164-251, 288-308, 324-351, 419-433``) on the
torch-CPU stack:

  - test vector v = autograd ∇_block r̂(u*, i*)
  - block HVP by double backprop of the total loss over the related rows
    (+ damping after accumulation)
  - inverse-HVP via ``scipy.optimize.fmin_ncg`` (avextol semantics)
  - scoring: ONE backward pass per related training row (the reference's
    per-row ``sess.run`` loop)

It exists to (a) measure the CPU baseline the port's numbers on the card
are compared against — the reference repo publishes none (BASELINE.md) —
and (b) serve as an independent oracle for the Spearman >= 0.99 parity
check. It is the CPU baseline by definition: it runs on the CPU in
float32, takes no device, and no path of the port calls it — it is not
the port's CPU path (that is ``InfluenceEngine(device="cpu")``).
Deliberately NOT optimised beyond the reference's own design.
"""

from __future__ import annotations

import numpy as np

import torch
from scipy.optimize import fmin_ncg


class TorchRefMFEngine:
    def __init__(self, params: dict, train_x: np.ndarray, train_y: np.ndarray,
                 weight_decay: float, damping: float = 1e-6,
                 avextol: float = 1e-3, maxiter: int = 100,
                 dtype=None):
        self.dtype = dtype or torch.float32
        t = lambda a: torch.tensor(np.asarray(a), dtype=self.dtype)
        self.P = t(params["P"])
        self.Q = t(params["Q"])
        self.bu = t(params["bu"])
        self.bi = t(params["bi"])
        self.bg = t(params["bg"])
        self.x = torch.tensor(np.asarray(train_x), dtype=torch.long)
        self.y = t(train_y)
        self.wd = float(weight_decay)
        self.damping = float(damping)
        self.avextol = float(avextol)
        self.maxiter = int(maxiter)
        self.k = self.P.shape[1]

    # -- helpers -----------------------------------------------------------
    def related(self, u: int, i: int) -> np.ndarray:
        xu = (self.x[:, 0] == u).nonzero().flatten().numpy()
        xi = (self.x[:, 1] == i).nonzero().flatten().numpy()
        return np.concatenate([xu, xi])

    def _leaves(self, u: int, i: int):
        pu = self.P[u].clone().detach().requires_grad_(True)
        qi = self.Q[i].clone().detach().requires_grad_(True)
        bu = self.bu[u].clone().detach().requires_grad_(True)
        bi = self.bi[i].clone().detach().requires_grad_(True)
        return pu, qi, bu, bi

    def _forward(self, leaves, u, i, rows):
        """Predictions on train rows with the (u, i) block substituted."""
        pu, qi, bu, bi = leaves
        uj = self.x[rows, 0]
        ij = self.x[rows, 1]
        pu_rows = torch.where((uj == u)[:, None], pu[None, :], self.P[uj])
        qi_rows = torch.where((ij == i)[:, None], qi[None, :], self.Q[ij])
        bu_rows = torch.where(uj == u, bu, self.bu[uj])
        bi_rows = torch.where(ij == i, bi, self.bi[ij])
        return (pu_rows * qi_rows).sum(1) + bu_rows + bi_rows + self.bg

    @staticmethod
    def _flat(gs):
        return np.concatenate([g.detach().numpy().reshape(-1) for g in gs])

    def _reg_grad(self, leaves):
        pu, qi, _, _ = leaves
        z = torch.zeros((), dtype=self.dtype)
        return [self.wd * pu, self.wd * qi, z, z]

    # -- core pieces -------------------------------------------------------
    def test_vector(self, u: int, i: int) -> np.ndarray:
        leaves = self._leaves(u, i)
        pu, qi, bu, bi = leaves
        r_hat = (pu * qi).sum() + bu + bi + self.bg
        gs = torch.autograd.grad(r_hat, leaves)
        return self._flat(gs)

    def _hvp(self, u, i, rows, vec: np.ndarray) -> np.ndarray:
        leaves = self._leaves(u, i)
        pred = self._forward(leaves, u, i, torch.tensor(rows, dtype=torch.long))
        mse = ((pred - self.y[rows]) ** 2).mean()
        gs = torch.autograd.grad(mse, leaves, create_graph=True)
        vparts = self._split(vec)
        dot = sum(
            (g * torch.tensor(v, dtype=self.dtype)).sum()
            for g, v in zip(gs, vparts)
        )
        h = torch.autograd.grad(dot, leaves)
        flat = self._flat(h)
        # reg Hessian (wd on the two embedding tables) + damping
        reg = np.concatenate(
            [self.wd * vec[: 2 * self.k], np.zeros(2, dtype=vec.dtype)]
        )
        return flat + reg + self.damping * vec

    def _split(self, vec):
        k = self.k
        return [vec[:k], vec[k : 2 * k], vec[2 * k : 2 * k + 1].reshape(()),
                vec[2 * k + 1 :].reshape(())]

    def inverse_hvp(self, u, i, rows, v: np.ndarray) -> np.ndarray:
        hvp = lambda x: self._hvp(u, i, rows, x.astype(np.float32))

        def f(x):
            hx = hvp(x)
            return 0.5 * np.dot(hx, x) - np.dot(v, x)

        def grad(x):
            return hvp(x) - v

        return fmin_ncg(
            f=f, x0=v.copy(), fprime=grad,
            fhess_p=lambda x, p: hvp(p),
            avextol=self.avextol, maxiter=self.maxiter, disp=0,
        )

    def _row_grad(self, u, i, row: int) -> np.ndarray:
        leaves = self._leaves(u, i)
        pred = self._forward(leaves, u, i, torch.tensor([row]))
        mse = ((pred - self.y[row]) ** 2).mean()
        gs = torch.autograd.grad(mse, leaves, allow_unused=True)
        gs = [
            g if g is not None else torch.zeros_like(l)
            for g, l in zip(gs, leaves)
        ]
        return self._flat(gs) + self._flat(self._reg_grad(leaves))

    # -- public ------------------------------------------------------------
    def query(self, u: int, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(scores over related rows, related row ids) — one per-row
        backward pass each, like the reference scoring loop."""
        rows = self.related(u, i)
        v = self.test_vector(u, i)
        ihvp = self.inverse_hvp(u, i, rows, v)
        scores = np.empty(len(rows), np.float64)
        for c, r in enumerate(rows):
            scores[c] = np.dot(ihvp, self._row_grad(u, i, int(r))) / len(rows)
        return scores, rows


class TorchRefNCFEngine:
    """CPU reference FIA engine for NCF (``NCF.py:193-280, 317-380``).

    Block = the four embedding rows [p_u^mlp, q_i^mlp, p_u^gmf, q_i^gmf]
    (4k params; MLP weights excluded, ``NCF.py:43-66``). Same architecture
    as :class:`TorchRefMFEngine`: autograd double backprop for the block
    HVP over related rows, ``fmin_ncg`` inverse-HVP, one backward pass per
    related row for scoring.
    """

    def __init__(self, params: dict, train_x: np.ndarray, train_y: np.ndarray,
                 weight_decay: float, damping: float = 1e-6,
                 avextol: float = 1e-3, maxiter: int = 100, dtype=None):
        self.dtype = dtype or torch.float32
        t = lambda a: torch.tensor(np.asarray(a), dtype=self.dtype)
        self.Pm, self.Qm = t(params["P_mlp"]), t(params["Q_mlp"])
        self.Pg, self.Qg = t(params["P_gmf"]), t(params["Q_gmf"])
        self.W1, self.b1 = t(params["W1"]), t(params["b1"])
        self.W2, self.b2 = t(params["W2"]), t(params["b2"])
        self.W3, self.b3 = t(params["W3"]), t(params["b3"])
        self.x = torch.tensor(np.asarray(train_x), dtype=torch.long)
        self.y = t(train_y)
        self.wd = float(weight_decay)
        self.damping = float(damping)
        self.avextol = float(avextol)
        self.maxiter = int(maxiter)
        self.k = self.Pm.shape[1]

    def related(self, u: int, i: int) -> np.ndarray:
        xu = (self.x[:, 0] == u).nonzero().flatten().numpy()
        xi = (self.x[:, 1] == i).nonzero().flatten().numpy()
        return np.concatenate([xu, xi])

    def _leaves(self, u: int, i: int):
        return [
            self.Pm[u].clone().detach().requires_grad_(True),
            self.Qm[i].clone().detach().requires_grad_(True),
            self.Pg[u].clone().detach().requires_grad_(True),
            self.Qg[i].clone().detach().requires_grad_(True),
        ]

    def _forward(self, leaves, u, i, rows):
        pm, qm, pg, qg = leaves
        uj = self.x[rows, 0]
        ij = self.x[rows, 1]
        pm_rows = torch.where((uj == u)[:, None], pm[None, :], self.Pm[uj])
        qm_rows = torch.where((ij == i)[:, None], qm[None, :], self.Qm[ij])
        pg_rows = torch.where((uj == u)[:, None], pg[None, :], self.Pg[uj])
        qg_rows = torch.where((ij == i)[:, None], qg[None, :], self.Qg[ij])
        return self._head(pm_rows, qm_rows, pg_rows, qg_rows)

    def _head(self, pm, qm, pg, qg):
        h1 = torch.relu(torch.cat([pm, qm], dim=-1) @ self.W1 + self.b1)
        h2 = torch.relu(h1 @ self.W2 + self.b2)
        h = torch.cat([h2, pg * qg], dim=-1)
        return (h @ self.W3 + self.b3).squeeze(-1)

    @staticmethod
    def _flat(gs):
        return np.concatenate([g.detach().numpy().reshape(-1) for g in gs])

    def test_vector(self, u: int, i: int) -> np.ndarray:
        leaves = self._leaves(u, i)
        pm, qm, pg, qg = leaves
        r_hat = self._head(pm[None, :], qm[None, :], pg[None, :], qg[None, :])[0]
        gs = torch.autograd.grad(r_hat, leaves, allow_unused=True)
        gs = [g if g is not None else torch.zeros_like(l)
              for g, l in zip(gs, leaves)]
        return self._flat(gs)

    def _split(self, vec):
        k = self.k
        return [vec[j * k : (j + 1) * k] for j in range(4)]

    def _hvp(self, u, i, rows, vec: np.ndarray) -> np.ndarray:
        leaves = self._leaves(u, i)
        pred = self._forward(leaves, u, i, torch.tensor(rows, dtype=torch.long))
        mse = ((pred - self.y[rows]) ** 2).mean()
        gs = torch.autograd.grad(mse, leaves, create_graph=True,
                                 allow_unused=True)
        dot = sum(
            (g * torch.tensor(v, dtype=self.dtype)).sum()
            for g, v in zip(gs, self._split(vec)) if g is not None
        )
        h = torch.autograd.grad(dot, leaves, allow_unused=True)
        h = [g if g is not None else torch.zeros_like(l)
             for g, l in zip(h, leaves)]
        # all four block leaves are decayed embedding rows
        return self._flat(h) + self.wd * vec + self.damping * vec

    def inverse_hvp(self, u, i, rows, v: np.ndarray) -> np.ndarray:
        hvp = lambda x: self._hvp(u, i, rows, x.astype(np.float32))

        def f(x):
            return 0.5 * np.dot(hvp(x), x) - np.dot(v, x)

        def grad(x):
            return hvp(x) - v

        return fmin_ncg(
            f=f, x0=v.copy(), fprime=grad,
            fhess_p=lambda x, p: hvp(p),
            avextol=self.avextol, maxiter=self.maxiter, disp=0,
        )

    def _row_grad(self, u, i, row: int) -> np.ndarray:
        leaves = self._leaves(u, i)
        pred = self._forward(leaves, u, i, torch.tensor([row]))
        mse = ((pred - self.y[row]) ** 2).mean()
        gs = torch.autograd.grad(mse, leaves, allow_unused=True)
        gs = [g if g is not None else torch.zeros_like(l)
              for g, l in zip(gs, leaves)]
        reg = self.wd * np.concatenate([l.detach().numpy() for l in leaves])
        return self._flat(gs) + reg

    def query(self, u: int, i: int) -> tuple[np.ndarray, np.ndarray]:
        rows = self.related(u, i)
        v = self.test_vector(u, i)
        ihvp = self.inverse_hvp(u, i, rows, v)
        scores = np.empty(len(rows), np.float64)
        for c, r in enumerate(rows):
            scores[c] = np.dot(ihvp, self._row_grad(u, i, int(r))) / len(rows)
        return scores, rows
