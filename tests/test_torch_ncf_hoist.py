"""The algebra the NCF score kernel (``csrc/ncf_scores.cu``) rests on,
checked in float64 on the CPU.

The kernel forms every product that depends on the query alone once per
query, ``Z[t] = [cU | rU | gU | cI | rI | gI]`` with

    cU = Pm[u_t] W1[:k]      rU = x[:k] W1[:k]       gU = w3g ⊙ x[2k:3k]
    cI = Qm[i_t] W1[k:]      rI = x[k:2k] W1[k:]     gI = w3g ⊙ x[3k:4k]

and then scores each row from its own half of the forward pass and two
k-long dots, using ``dhin[:k] · x[:k] = dz1 · rU`` (and so for the item
half). ``hoisted_scores`` below writes that per-query and per-row formula
in float64 torch, row kinds and all, and must equal the plain version
``kncf.fused_scores_reference`` to 1e-12 relative: rows of the query's
user (a), of its item (b), its own pair (a = b = 1), rows matching
neither id, masked rows (wv = 0), with ``t`` sorted and unsorted.
"""

import numpy as np
import pytest
import torch

from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import ncf as kncf

torch.set_num_threads(2)

U, I, T, S = 24, 18, 6, 240
KINDS = ("a", "b", "both", "neither")
# float64 against float64 in another summation order
REL = 1e-12


def hoisted_scores(rel_x, t, e, wv, tx, Pm, Qm, Pg, Qg, W1, b1, W2, b2, W3,
                   B):
    """(S,) scores by the kernel's algebra: the query products once per
    query, then each row's half forward pass and its dots."""
    k, k2 = Pm.shape[1], W2.shape[1]
    d = 4 * k
    x = B[:, :d]
    w3h, w3g = W3[:k2, 0], W3[k2:, 0]
    ut, it = tx[:, 0].long(), tx[:, 1].long()
    # the per-query products, (T, k) each
    cU, cI = Pm[ut] @ W1[:k], Qm[it] @ W1[k:]
    rU, rI = x[:, :k] @ W1[:k], x[:, k:2 * k] @ W1[k:]
    gU, gI = w3g * x[:, 2 * k:3 * k], w3g * x[:, 3 * k:]
    # per row: the a path (a = 1, or a = b = 1) or the b-only path
    t = t.long()
    xu, xi = rel_x[:, 0].long(), rel_x[:, 1].long()
    a, b = xu == ut[t], xi == it[t]
    bonly = (b & ~a)[:, None]
    both = (a & b).to(B.dtype)[:, None]
    z1 = b1 + torch.where(bonly, cI[t] + Pm[xu] @ W1[:k],
                          cU[t] + Qm[xi] @ W1[k:])
    z2 = torch.relu(z1) @ W2 + b2
    dz2 = torch.where(z2 > 0, w3h, torch.zeros_like(z2))
    dz1 = torch.where(z1 > 0, dz2 @ W2.T, torch.zeros_like(z1))
    r = torch.where(bonly, rI[t], rU[t]) + both * rI[t]
    gm = torch.where(bonly, Pg[xu], Qg[xi])
    g = torch.where(bonly, gI[t], gU[t])
    gdot = ((dz1 * r).sum(1) + (gm * g).sum(1)
            + both[:, 0] * (Pg[xu] * gI[t]).sum(1))
    gdot = torch.where(a | b, gdot, torch.zeros_like(gdot))
    out = wv * (2.0 * e * gdot + B[t, d]) / B[t, d + 1]
    return torch.where(wv == 0, torch.zeros_like(out), out)


def _operands(k: int, order: str, seed: int = 0):
    """Float64 NCF operands with every row kind, seeded with numpy; the
    kind of each row is returned beside them."""
    rng = np.random.default_rng(1000 * k + seed)
    k2 = k // 2
    tx = np.stack([rng.choice(U, T, replace=False),
                   rng.choice(I, T, replace=False)], axis=1).astype(np.int32)
    t = np.sort(rng.integers(0, T, S)).astype(np.int32)
    kind = rng.integers(0, len(KINDS), S)
    kind[:len(KINDS)] = np.arange(len(KINDS))  # each kind at least once
    user = rng.integers(0, U, S)
    item = rng.integers(0, I, S)
    for s in range(S):  # draw again until the row is of its kind
        while True:
            a, b = user[s] == tx[t[s], 0], item[s] == tx[t[s], 1]
            want = KINDS[kind[s]]
            if want == "a":
                user[s] = tx[t[s], 0]
                if not b:
                    break
            elif want == "b":
                item[s] = tx[t[s], 1]
                if not a:
                    break
            elif want == "both":
                user[s], item[s] = tx[t[s]]
                break
            elif not (a or b):
                break
            user[s], item[s] = rng.integers(0, U), rng.integers(0, I)
    rel_x = np.stack([user, item], axis=1).astype(np.int32)
    e = rng.standard_normal(S)
    wv = (rng.random(S) < 0.8).astype(np.float64)
    wv[:len(KINDS)] = 1.0
    if order == "unsorted":
        perm = rng.permutation(S)
        t, rel_x, e, wv, kind = t[perm], rel_x[perm], e[perm], wv[perm], \
            kind[perm]
    se = 1.0 / np.sqrt(k)
    tables = [rng.standard_normal((n, k)) * se for n in (U, I, U, I)]
    weights = [rng.standard_normal((2 * k, k)) / np.sqrt(2 * k),
               0.3 * rng.standard_normal(k),
               rng.standard_normal((k, k2)) * se,
               0.3 * rng.standard_normal(k2),
               rng.standard_normal((k2 + k, 1)) / np.sqrt(k2 + k)]
    ihvp = rng.standard_normal((T, 4 * k))
    reg_dot = rng.standard_normal(T)
    n_t = np.maximum(np.bincount(t, minlength=T), 1).astype(np.float64)
    B = common.query_matrix(*(torch.as_tensor(v) for v in (ihvp, reg_dot,
                                                           n_t)))
    args = (torch.as_tensor(rel_x), torch.as_tensor(t), torch.as_tensor(e),
            torch.as_tensor(wv), torch.as_tensor(tx),
            *(torch.as_tensor(v) for v in tables + weights),
            B.double())
    return args, kind


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("k", [4, 6, 16])
def test_hoisted_algebra_equals_the_plain_version(k, order):
    args, kind = _operands(k, order)
    want = kncf.fused_scores_reference(*args)
    got = hoisted_scores(*args)
    assert want.dtype == got.dtype == torch.float64
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=REL,
                               atol=REL * scale)
    wv = args[3]
    assert (got[wv == 0] == 0).all()
    # every row kind is present and live, so each path was exercised
    live = wv.numpy() != 0
    assert set(kind[live]) == set(range(len(KINDS)))


@pytest.mark.parametrize("k", [4, 16])
def test_rows_of_each_kind_score_as_the_plain_version(k):
    """Each row kind alone (the others masked), so a wrong path cannot
    hide behind the rest."""
    args, kind = _operands(k, "unsorted", seed=1)
    for j in range(len(KINDS)):
        wv = torch.where(torch.as_tensor(kind == j), args[3],
                         torch.zeros_like(args[3]))
        one = (*args[:3], wv, *args[4:])
        want = kncf.fused_scores_reference(*one)
        got = hoisted_scores(*one)
        scale = max(float(want.abs().max()), 1e-300)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=REL,
                                   atol=REL * scale, err_msg=KINDS[j])


def test_neither_rows_score_their_reg_dot_term():
    args, kind = _operands(6, "sorted", seed=2)
    rel_x, t, e, wv = args[:4]
    B = args[-1]
    d = B.shape[1] - 2
    got = hoisted_scores(*args)
    rows = torch.as_tensor((kind == KINDS.index("neither"))) & (wv != 0)
    tl = t.long()
    want = wv * B[tl, d] / B[tl, d + 1]
    assert rows.any()
    assert torch.equal(got[rows], want[rows])
