"""NeuMF-style neural collaborative filtering (port of
``fia_tpu/models/ncf.py``).

An MLP tower over the concatenated (user, item) MLP embeddings
(2k -> k relu -> k/2 relu), a GMF branch p_u ⊙ q_i, concatenated and
fused by one linear layer to a scalar rating. Weight decay on the four
embedding tables and the three layer weights (not the biases);
embeddings and weights truncated-normal with stddev 1/sqrt(fan_in),
biases zero. The FIA block is the four embedding rows only — the MLP
weights are outside the influence subspace.
"""

from __future__ import annotations

import math

import torch

from fia_tpu_torch.influence import grads
from fia_tpu_torch.influence.kernels import ncf as kncf
from fia_tpu_torch.models.base import LatentFactorModel, truncated_normal


class NCF(LatentFactorModel):
    decayed = ("P_mlp", "Q_mlp", "P_gmf", "Q_gmf", "W1", "W2", "W3")
    block_keys = ("pu_mlp", "qi_mlp", "pu_gmf", "qi_gmf")
    # the score kernel (influence/kernels/ncf.py) gathers the four rows
    # and replays the MLP's forward and backward per row
    kernel_family = "ncf"

    def param_shapes(self):
        k = self.embedding_size
        k2 = k // 2
        U, I = self.num_users, self.num_items
        return {
            "P_mlp": (U, k), "Q_mlp": (I, k),
            "P_gmf": (U, k), "Q_gmf": (I, k),
            "W1": (2 * k, k), "b1": (k,),
            "W2": (k, k2), "b2": (k2,),
            "W3": (k2 + k, 1), "b3": (1,),
        }

    def init_params(self, generator, device=None):
        k = self.embedding_size
        k2 = k // 2
        se = 1.0 / math.sqrt(k)
        device = device or generator.device
        U, I = self.num_users, self.num_items

        def tn(shape, std):
            return truncated_normal(generator, shape, std, device)

        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        # drawn in the reference's key order
        P_mlp, Q_mlp = tn((U, k), se), tn((I, k), se)
        P_gmf, Q_gmf = tn((U, k), se), tn((I, k), se)
        W1 = tn((2 * k, k), 1.0 / math.sqrt(2 * k))
        W2 = tn((k, k2), 1.0 / math.sqrt(k))
        W3 = tn((k2 + k, 1), 1.0 / math.sqrt(k2 + k))
        return {
            "P_mlp": P_mlp, "Q_mlp": Q_mlp, "P_gmf": P_gmf, "Q_gmf": Q_gmf,
            "W1": W1, "b1": zeros((k,)), "W2": W2, "b2": zeros((k2,)),
            "W3": W3, "b3": zeros((1,)),
        }

    @staticmethod
    def _head(params, pm, qm, pg, qg):
        h1 = torch.relu(torch.cat([pm, qm], dim=-1) @ params["W1"]
                        + params["b1"])
        h2 = torch.relu(h1 @ params["W2"] + params["b2"])
        h = torch.cat([h2, pg * qg], dim=-1)
        return torch.squeeze(h @ params["W3"] + params["b3"], dim=-1)

    def predict(self, params, x):
        u, i = x[:, 0], x[:, 1]
        return self._head(params, params["P_mlp"][u], params["Q_mlp"][i],
                          params["P_gmf"][u], params["Q_gmf"][i])

    def row_predict(self, params, x):
        """``predict`` with each row's bits independent of the row count:
        the tower's products in fixed pieces of rows
        (``kernels/ncf.py:rows_product``) and the (·, 1) output layer as a
        product and row sum (on the card a matrix-vector product's kernel,
        too, follows the row count)."""
        u, i = x[:, 0], x[:, 1]
        _, z2 = kncf.preactivations(u, i, *(params[n] for n in (
            "P_mlp", "Q_mlp", "W1", "b1", "W2", "b2")))
        h = torch.cat([torch.relu(z2), params["P_gmf"][u] * params["Q_gmf"][i]],
                      dim=-1)
        return torch.sum(h * params["W3"][:, 0], dim=-1) + params["b3"][0]

    # -- FIA block: 4 embedding rows, 4k params
    def extract_block(self, params, u, i):
        return {
            "pu_mlp": params["P_mlp"][u],
            "qi_mlp": params["Q_mlp"][i],
            "pu_gmf": params["P_gmf"][u],
            "qi_gmf": params["Q_gmf"][i],
        }

    def block_predict(self, params, block, u, i, x):
        """Predict rows ``x`` with the (u, i) block substituted where the
        row's user/item is (u, i) — scatter-free (see MF)."""
        xu, xi = x[:, 0], x[:, 1]
        mu = (xu == u)[:, None]
        mi = (xi == i)[:, None]
        pm = torch.where(mu, block["pu_mlp"][None, :], params["P_mlp"][xu])
        qm = torch.where(mi, block["qi_mlp"][None, :], params["Q_mlp"][xi])
        pg = torch.where(mu, block["pu_gmf"][None, :], params["P_gmf"][xu])
        qg = torch.where(mi, block["qi_gmf"][None, :], params["Q_gmf"][xi])
        return self._head(params, pm, qm, pg, qg)

    def with_block(self, params, block, u, i):
        u, i = (torch.as_tensor(v, device=params["P_mlp"].device)
                for v in (u, i))
        out = dict(params)
        out["P_mlp"] = params["P_mlp"].index_put((u,), block["pu_mlp"])
        out["Q_mlp"] = params["Q_mlp"].index_put((i,), block["qi_mlp"])
        out["P_gmf"] = params["P_gmf"].index_put((u,), block["pu_gmf"])
        out["Q_gmf"] = params["Q_gmf"].index_put((i,), block["qi_gmf"])
        return out

    def block_reg(self, params, block, u, i):
        """Scatter-free (see MF.block_reg)."""
        corr = (
            torch.sum(torch.square(block["pu_mlp"]))
            - torch.sum(torch.square(params["P_mlp"][u]))
            + torch.sum(torch.square(block["qi_mlp"]))
            - torch.sum(torch.square(params["Q_mlp"][i]))
            + torch.sum(torch.square(block["pu_gmf"]))
            - torch.sum(torch.square(params["P_gmf"][u]))
            + torch.sum(torch.square(block["qi_gmf"]))
            - torch.sum(torch.square(params["Q_gmf"][i]))
        )
        return self.reg_loss(params) + 0.5 * self.weight_decay * corr

    def block_hessian(self, params, u, i, x, y, w):
        """Exact (undamped) block Hessian: Gauss-Newton plus the GMF
        bilinear correction. r̂ is piecewise-linear in (pu_mlp, qi_mlp)
        and linear in each of pu_gmf, qi_gmf, so ∇²r̂ vanishes a.e.
        except the GMF cross term on rows equal to the query pair:

          H = (2/n) Σ_j w_j (g_j g_jᵀ + a_j b_j e_j C) + wd·I

        with g_j = ∇_block r̂(z_j) and C = ``block_cross_const``."""
        xu, xi = x[:, 0], x[:, 1]
        wf = w.to(torch.float32)
        c = 2.0 / torch.clamp(torch.sum(wf), min=1.0)

        block = self.extract_block(params, u, i)
        g = grads.per_example_block_prediction_grads(self, params, u, i, x)
        e = self.block_predict(params, block, u, i, x) - y
        ab = (wf * (xu == u).to(torch.float32)
              * (xi == i).to(torch.float32))
        return (
            c * (g.T * wf) @ g
            + c * torch.sum(ab * e) * self.block_cross_const(params)
            + torch.diag(self.block_reg_diag(params))
        )

    def own_grads(self, params, xu, xi):
        """Per-row gradients of r̂ w.r.t. each row's OWN four embedding
        rows ``(dpm, dqm, dpg, dqg)``, in closed form: the MLP backward of
        the score kernel's plain version (``kernels/ncf.py:own_backward``)
        and dpg = qg ⊙ w3g, dqg = pg ⊙ w3g, with w3g W3's GMF rows."""
        k = self.embedding_size
        dhin = kncf.own_backward(xu, xi, *(params[n] for n in (
            "P_mlp", "Q_mlp", "W1", "b1", "W2", "b2", "W3")))
        w3g = params["W3"][params["W2"].shape[1]:, 0]
        return (dhin[:, :k], dhin[:, k:], params["Q_gmf"][xi] * w3g,
                params["P_gmf"][xu] * w3g)

    def block_row_grads(self, params, u, i, x):
        """Per-row block Jacobian: ∂r̂_j/∂block = mask_j · ∂r̂_j/∂own_j,
        ``[a dpm ; b dqm ; a dpg ; b dqg]`` with a_j = [user_j == u] and
        b_j = [item_j == i]; ``u``/``i`` may be scalars or per-row ids
        aligned with ``x``."""
        xu, xi = x[:, 0], x[:, 1]
        dpm, dqm, dpg, dqg = self.own_grads(params, xu, xi)
        a = (xu == u).to(torch.float32)[:, None]
        b = (xi == i).to(torch.float32)[:, None]
        return torch.cat([a * dpm, b * dqm, a * dpg, b * dqg], dim=1)

    def grads_from_rows(self, params, rows, x, y, u, i):
        """(g, e) from pre-gathered table rows (see the base hook):
        ``own_grads`` and ``row_predict`` over the rows as tables indexed
        by their own positions, masked by the real ids."""
        xu, xi = x[:, 0], x[:, 1]
        local = {**params, **rows}
        own = torch.arange(x.shape[0], device=x.device)
        dpm, dqm, dpg, dqg = self.own_grads(local, own, own)
        a = (xu == u).to(torch.float32)[:, None]
        b = (xi == i).to(torch.float32)[:, None]
        g = torch.cat([a * dpm, b * dqm, a * dpg, b * dqg], dim=1)
        return g, self.row_predict(local, torch.stack([own, own], dim=1)) - y

    # -- fused row-feature hooks (see the base hooks). Layout:
    # [g_pm (k) | g_qm (k) | g_pg (k) | g_qg (k) | e | u | i], F = 4k + 3,
    # the g_* each row's prediction gradient w.r.t. its OWN embedding rows
    # (``own_grads``: products in fixed pieces of rows, so a table built
    # in any steps holds the flat path's bits)
    @property
    def row_feature_dim(self) -> int:
        return 4 * self.embedding_size + 3

    def build_row_features(self, params, x, y):
        xu, xi = x[:, 0], x[:, 1]
        e = self.row_predict(params, x) - y
        return torch.cat([*self.own_grads(params, xu, xi), e[:, None],
                          xu.to(torch.float32)[:, None],
                          xi.to(torch.float32)[:, None]], dim=1)

    def grads_from_row_features(self, feat, u, i):
        """(g, e, a, b) of rows ``feat`` against query ids ``u``/``i``:
        the masking of ``block_row_grads`` on the stored parts."""
        k = self.embedding_size
        a = (feat[:, 4 * k + 1] == u).to(torch.float32)
        b = (feat[:, 4 * k + 2] == i).to(torch.float32)
        am, bm = a[:, None], b[:, None]
        g = torch.cat([am * feat[:, :k], bm * feat[:, k: 2 * k],
                       am * feat[:, 2 * k: 3 * k],
                       bm * feat[:, 3 * k: 4 * k]], dim=1)
        # e contiguous: the score kernels take it as a flat (B,) array
        return g, feat[:, 4 * k].contiguous(), a, b

    def kernel_operands(self, params):
        """The score kernel's table and weight operands, in its order."""
        return tuple(params[n] for n in ("P_mlp", "Q_mlp", "P_gmf", "Q_gmf",
                                         "W1", "b1", "W2", "b2", "W3"))

    def block_cross_const(self, params):
        """∇²r̂ on rows equal to the query pair: the GMF bilinear cross
        block diag(W3's GMF rows) between pu_gmf and qi_gmf."""
        k = self.embedding_size
        d = self.block_size
        dev = params["W3"].device
        r = torch.arange(k, device=dev)
        w3g = params["W3"][k // 2 :, 0]
        C = torch.zeros((d, d), dtype=torch.float32, device=dev)
        C[2 * k + r, 3 * k + r] = w3g
        C[3 * k + r, 2 * k + r] = w3g
        return C

    def block_reg_diag(self, params):
        """All four embedding rows are decayed."""
        return torch.full((self.block_size,), self.weight_decay,
                          dtype=torch.float32, device=params["W3"].device)

    @property
    def block_size(self) -> int:
        return 4 * self.embedding_size
