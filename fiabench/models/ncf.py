"""Plain reference of NeuMF-style neural collaborative filtering (FIA,
KDD 2019, zz9tf/FIA-KDD-19 ``src/influence/NCF.py:20-145``).

An MLP tower over [p_mlp | q_mlp] (2k -> k relu -> k/2 relu), a GMF
branch p_gmf ⊙ q_gmf, both concatenated and fused by one linear layer:
r̂ = relu(relu([p_mlp | q_mlp] W1 + b1) W2 + b2) · w3m + (p_gmf ⊙ q_gmf) ·
w3g + b3, with W3 = [w3m; w3g]. Squared-error loss, L2 weight decay
``wd`` on the four embedding tables and W1..W3. The FIA block of a query
(u*, i*) is its four embedding rows [p_mlp, q_mlp, p_gmf, q_gmf], d = 4k.
The gradients are written out by hand in plain torch; the module imports
nothing of the program.
"""

from __future__ import annotations

import torch

from fiabench import precision as prec

#: a row whose float64 pre-activation lies within this share of its
#: largest (or of 1) from a relu's kink may rightly take the other side
#: of it in float32, and so another gradient: its query is not compared
KINK_REL = 1e-6


def param_specs(cfg: dict) -> dict:
    """``{name: (shape, std)}``: std 0 is a zero tensor, any other a
    normal truncated at two standard deviations (the model's init)."""
    U, I, k = cfg["num_users"], cfg["num_items"], cfg["embedding_size"]
    k2 = k // 2
    se = 1.0 / k ** 0.5
    return {"P_mlp": ((U, k), se), "Q_mlp": ((I, k), se),
            "P_gmf": ((U, k), se), "Q_gmf": ((I, k), se),
            "W1": ((2 * k, k), 1.0 / (2 * k) ** 0.5), "b1": ((k,), 0.0),
            "W2": ((k, k2), 1.0 / k ** 0.5), "b2": ((k2,), 0.0),
            "W3": ((k2 + k, 1), 1.0 / (k2 + k) ** 0.5), "b3": ((1,), 0.0)}


def block_size(cfg: dict) -> int:
    return 4 * cfg["embedding_size"]


def _own(params, cfg, xu, xi, precision):
    """r̂ of rows (xu, xi), the gradient of each with respect to its own
    four embedding rows ``(dpm, dqm, dpg, dqg)``, and which rows lie at
    a relu kink."""
    k2 = cfg["embedding_size"] // 2
    pm, qm = params["P_mlp"][xu], params["Q_mlp"][xi]
    pg, qg = params["P_gmf"][xu], params["Q_gmf"][xi]
    W1, W2, W3 = params["W1"], params["W2"], params["W3"]
    w3m, w3g = W3[:k2, 0], W3[k2:, 0]
    z1 = prec.mm(torch.cat([pm, qm], dim=1), W1, precision) + params["b1"]
    z2 = prec.mm(torch.relu(z1), W2, precision) + params["b2"]
    rhat = (prec.rowdot(torch.relu(z2), w3m[None], precision)
            + prec.rowdot(pg * qg, w3g[None], precision) + params["b3"][0])
    dz2 = (z2 > 0).to(z2.dtype) * w3m[None]
    dz1 = (z1 > 0).to(z1.dtype) * prec.mm(dz2, W2.T, precision)
    dpq = prec.mm(dz1, W1.T, precision)
    k = pm.shape[1]
    z = torch.cat([z1, z2], dim=1).abs()
    lim = KINK_REL * torch.clamp(z.max(dim=1).values, min=1.0)
    kink = z.min(dim=1).values <= lim
    return rhat, (dpq[:, :k], dpq[:, k:], qg * w3g, pg * w3g), kink


def row_terms(params, cfg, x, y, u, i, precision):
    """``(g, e, kink)`` of rows ``x`` (R, 2) with ratings ``y`` against
    each row's query ids ``u``, ``i`` (R,): g the gradient of r̂(row)
    with respect to the query's block (a row's own embedding rows count
    where they are the query's), e = r̂ - y, kink the rows at a relu
    kink."""
    xu, xi = x[:, 0], x[:, 1]
    rhat, (dpm, dqm, dpg, dqg), kink = _own(params, cfg, xu, xi, precision)
    a = (xu == u).to(rhat.dtype)[:, None]
    b = (xi == i).to(rhat.dtype)[:, None]
    g = torch.cat([a * dpm, b * dqm, a * dpg, b * dqg], dim=1)
    return g, rhat - y, kink


def test_grad(params, cfg, u, i, precision):
    """``(v, kink)``: ∇_block r̂(u, i) for each query, (T, d), and the
    queries whose own pair lies at a relu kink."""
    _, parts, kink = _own(params, cfg, u, i, precision)
    return torch.cat(parts, dim=1), kink


def block_theta(params, cfg, u, i):
    """The query's block parameters, flattened in block order."""
    return torch.cat([params["P_mlp"][u], params["Q_mlp"][i],
                      params["P_gmf"][u], params["Q_gmf"][i]], dim=1)


def reg_diag(params, cfg):
    """∇² of the L2 term on the block: wd on every block entry."""
    W3 = params["W3"]
    return torch.full((block_size(cfg),), cfg["weight_decay"],
                      dtype=W3.dtype, device=W3.device)


def cross_const(params, cfg):
    """∇²r̂ on a row equal to the query pair: the GMF product's cross
    block diag(w3g) between p_gmf and q_gmf (r̂ is piecewise linear in the
    MLP rows, so they add nothing almost everywhere)."""
    k = cfg["embedding_size"]
    W3 = params["W3"]
    C = torch.zeros((block_size(cfg),) * 2, dtype=W3.dtype, device=W3.device)
    r = torch.arange(k, device=W3.device)
    C[2 * k + r, 3 * k + r] = W3[k // 2:, 0]
    C[3 * k + r, 2 * k + r] = W3[k // 2:, 0]
    return C


def row_flops(cfg: dict) -> int:
    """Operations a related row needs for r̂, e and its masked block
    gradient: the tower's products forward and back (2 · (2·2k·k +
    2·k·k2)), its bias adds (k + k2), the output layer (2(k2 + k)) and
    residual (2), the GMF gradients (2k) and 4k masking products."""
    k = cfg["embedding_size"]
    k2 = k // 2
    return (2 * (4 * k * k + 2 * k * k2) + (k + k2) + 2 * (k2 + k) + 2
            + 2 * k + 4 * k)
