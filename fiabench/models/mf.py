"""Plain reference of biased matrix factorization (FIA, KDD 2019,
zz9tf/FIA-KDD-19 ``src/influence/matrix_factorization.py:21-132``).

r̂(u, i) = p_u · q_i + b_u + b_i + b_g, squared-error loss, L2 weight
decay ``wd`` on the two embedding tables. The FIA block of a query
(u*, i*) is [p_u* (k), q_i* (k), b_u*, b_i*], d = 2k + 2. Written from
the model's equations in plain torch; it imports nothing of the program.
"""

from __future__ import annotations

import torch

from fiabench import precision as prec


def param_specs(cfg: dict) -> dict:
    """``{name: (shape, std)}``: std 0 is a zero tensor, any other a
    normal truncated at two standard deviations (the model's init)."""
    U, I, k = cfg["num_users"], cfg["num_items"], cfg["embedding_size"]
    s = 1.0 / k ** 0.5
    return {"P": ((U, k), s), "Q": ((I, k), s), "bu": ((U,), 0.0),
            "bi": ((I,), 0.0), "bg": ((), 0.0)}


def block_size(cfg: dict) -> int:
    return 2 * cfg["embedding_size"] + 2


def row_terms(params, cfg, x, y, u, i, precision):
    """``(g, e, kink)`` of rows ``x`` (R, 2) with ratings ``y`` against
    each row's query ids ``u``, ``i`` (R,): g the gradient of r̂(row)
    with respect to the query's block, e = r̂ - y, and no kink (the model
    is smooth)."""
    P, Q = params["P"], params["Q"]
    xu, xi = x[:, 0], x[:, 1]
    pu, qi = P[xu], Q[xi]
    rhat = (prec.rowdot(pu, qi, precision) + params["bu"][xu]
            + params["bi"][xi] + params["bg"])
    a = (xu == u).to(P.dtype)[:, None]
    b = (xi == i).to(P.dtype)[:, None]
    g = torch.cat([a * qi, b * pu, a, b], dim=1)
    return g, rhat - y, None


def test_grad(params, cfg, u, i, precision):
    """``(v, kink)``: ∇_block r̂(u, i) for each query, (T, d)."""
    ones = torch.ones((u.shape[0], 1), dtype=params["P"].dtype,
                      device=u.device)
    return torch.cat([params["Q"][i], params["P"][u], ones, ones], 1), None


def block_theta(params, cfg, u, i):
    """The query's block parameters, flattened in block order."""
    return torch.cat([params["P"][u], params["Q"][i], params["bu"][u][:, None],
                      params["bi"][i][:, None]], dim=1)


def reg_diag(params, cfg):
    """∇² of the L2 term on the block: wd on p and q, none on biases."""
    k, wd = cfg["embedding_size"], cfg["weight_decay"]
    dt, dev = params["P"].dtype, params["P"].device
    return torch.cat([torch.full((2 * k,), wd, dtype=dt, device=dev),
                      torch.zeros(2, dtype=dt, device=dev)])


def cross_const(params, cfg):
    """∇²r̂ on a row equal to the query pair: ∇²(p·q) = [[0 I];[I 0]]."""
    k = cfg["embedding_size"]
    d = block_size(cfg)
    C = torch.zeros((d, d), dtype=params["P"].dtype,
                    device=params["P"].device)
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    C[:k, k:2 * k] = eye
    C[k:2 * k, :k] = eye
    return C


def row_flops(cfg: dict) -> int:
    """Operations a related row needs for r̂, e and its masked block
    gradient: the k-term dot (2k), three bias adds and the residual (4),
    and 2k + 2 masking products."""
    k = cfg["embedding_size"]
    return 4 * k + 6
