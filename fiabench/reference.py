"""The plain reference of an influence query, and the weights it and the
program share.

For a query (u*, i*) over training rows z_j = (u_j, i_j, y_j), FIA
restricts the Hessian to the query's block θ (the parameters of u* and
i*). The related rows are those sharing u* (in row order) then those
sharing i* (in row order), so a row equal to (u*, i*) counts twice; n is
their count. With g_j = ∇_θ r̂(z_j) and e_j = r̂(z_j) - y_j:

  H = (2/n) Σ_j (g_j g_jᵀ + a_j b_j e_j C) + diag(r) + λI
  v = ∇_θ r̂(u*, i*),   x = H⁻¹ v
  score_j = (2 e_j g_j + r ⊙ θ) · x / n

with a_j, b_j whether row j's user and item are the query's, C = ∇²r̂ on
such a row, r the L2 term's diagonal and λ the damping. This module
works all of it out from the ratings, the weights and the pairs alone,
in float64 (or in its control's precision), and imports nothing of the
program.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from fiabench import precision as prec

#: rows a block of the reference's row pass: bounds its memory
ROW_BLOCK = 1 << 20


def family(cfg: dict):
    """The plain model module of a configuration (``models/<family>.py``)."""
    return importlib.import_module(f"fiabench.models.{cfg['family']}")


def make_params(cfg: dict, seed: int, device) -> dict:
    """The weights of a run, drawn on ``device`` from ``seed`` in float32
    (the type they are served in): one truncated-normal call a table at
    the model's own init scale, zeros where the model starts at zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    out = {}
    for name, (shape, std) in family(cfg).param_specs(cfg).items():
        t = torch.zeros(shape, dtype=torch.float32, device=device)
        if std:
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        out[name] = t
    return out


class Postings:
    """The reference's own index of the training rows: each user's rows
    and each item's rows, in row order."""

    def __init__(self, x: np.ndarray, num_users: int, num_items: int):
        self.u_ptr, self.u_rows = self._csr(x[:, 0], num_users)
        self.i_ptr, self.i_rows = self._csr(x[:, 1], num_items)

    @staticmethod
    def _csr(ids, n):
        order = np.argsort(ids, kind="stable")
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(ids, minlength=n), out=ptr[1:])
        return ptr, order

    def related(self, u: int, i: int) -> np.ndarray:
        return np.concatenate([self.u_rows[self.u_ptr[u]:self.u_ptr[u + 1]],
                               self.i_rows[self.i_ptr[i]:self.i_ptr[i + 1]]])


def influence(cfg: dict, params: dict, x: np.ndarray, y: np.ndarray,
              postings: Postings, pairs: np.ndarray, device,
              precision: str = "float64") -> list[dict]:
    """Each query of ``pairs`` (Q, 2) worked out at ``precision``:
    ``{"rows", "scores", "ihvp", "cond", "kink"}``, the related row ids,
    the scores in that order, x = H⁻¹ v, H's 2-norm condition number,
    and whether any of its rows (or the pair itself) lies at a relu
    kink. ``params`` are the run's
    float32 weights; float64 holds them exactly."""
    fam = family(cfg)
    dt = prec.dtype(precision)
    P = {k: v.to(device=device, dtype=dt) for k, v in params.items()}
    lam = float(cfg["damping"])
    C = fam.cross_const(P, cfg)
    r = fam.reg_diag(P, cfg)
    rel = [postings.related(int(u), int(i)) for u, i in pairs]
    counts = np.array([len(a) for a in rel], np.int64)
    rows = np.concatenate(rel)
    seg = np.repeat(np.arange(len(pairs)), counts)
    pu = torch.as_tensor(pairs[:, 0].astype(np.int64), device=device)
    pi = torch.as_tensor(pairs[:, 1].astype(np.int64), device=device)
    out = [None] * len(pairs)
    # queries in groups of at most ROW_BLOCK rows (a longer one alone)
    starts = np.concatenate([[0], np.cumsum(counts)])
    q0 = 0
    while q0 < len(pairs):
        q1 = int(np.searchsorted(starts, starts[q0] + ROW_BLOCK, "right")) - 1
        q1 = max(q1, q0 + 1)
        lo, hi = int(starts[q0]), int(starts[q1])
        xr = torch.as_tensor(x[rows[lo:hi]].astype(np.int64), device=device)
        yr = torch.as_tensor(y[rows[lo:hi]], device=device).to(dt)
        t = torch.as_tensor(seg[lo:hi], device=device)
        g, e, kink = fam.row_terms(P, cfg, xr, yr, pu[t], pi[t], precision)
        v, vkink = fam.test_grad(P, cfg, pu[q0:q1], pi[q0:q1], precision)
        theta = fam.block_theta(P, cfg, pu[q0:q1], pi[q0:q1])
        for q in range(q0, q1):
            a, b = int(starts[q] - lo), int(starts[q + 1] - lo)
            gq, eq = g[a:b], e[a:b]
            n = max(b - a, 1)
            both = ((xr[a:b, 0] == pu[q]) & (xr[a:b, 1] == pi[q])).to(dt)
            H = (2.0 / n) * (prec.mm(gq.T, gq, precision)
                             + torch.sum(both * eq) * C)
            H = H + torch.diag(r + lam)
            xq = torch.linalg.solve(H, v[q - q0])
            reg = prec.rowdot((r * theta[q - q0])[None], xq[None], precision)
            s = (2.0 * eq * prec.rowdot(gq, xq[None], precision) + reg) / n
            bad = vkink is not None and bool(vkink[q - q0])
            if kink is not None:
                bad = bad or bool(kink[a:b].any())
            out[q] = {"rows": rel[q], "scores": s.cpu().numpy(),
                      "ihvp": xq.cpu().numpy(),
                      "cond": float(torch.linalg.cond(H)), "kink": bad}
        q0 = q1
    return out
