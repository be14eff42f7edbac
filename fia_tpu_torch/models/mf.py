"""Biased matrix factorization (port of ``fia_tpu/models/mf.py``).

r̂(u, i) = p_u · q_i + b_u + b_i + b_g, squared-error loss with L2
weight decay on the two embedding tables only; embeddings initialised
truncated-normal with stddev 1/sqrt(k), biases zero. Parameters are
dense (U, k)/(I, k) tensors, so the FIA block is plain row indexing.
"""

from __future__ import annotations

import math

import torch

from fia_tpu_torch.models.base import LatentFactorModel, truncated_normal


class MF(LatentFactorModel):
    decayed = ("P", "Q")
    block_keys = ("pu", "qi", "bu", "bi")
    # the score kernel (influence/kernels/mf.py) re-forms
    # g_j = [a Q[i_j]; b P[u_j]; a; b] from the two tables itself
    kernel_family = "mf"

    def param_shapes(self):
        k = self.embedding_size
        return {
            "P": (self.num_users, k),
            "Q": (self.num_items, k),
            "bu": (self.num_users,),
            "bi": (self.num_items,),
            "bg": (),
        }

    def init_params(self, generator, device=None):
        k = self.embedding_size
        std = 1.0 / math.sqrt(k)
        device = device or generator.device

        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        return {
            "P": truncated_normal(generator, (self.num_users, k), std, device),
            "Q": truncated_normal(generator, (self.num_items, k), std, device),
            "bu": zeros((self.num_users,)),
            "bi": zeros((self.num_items,)),
            "bg": zeros(()),
        }

    def predict(self, params, x):
        u, i = x[:, 0], x[:, 1]
        dot = torch.sum(params["P"][u] * params["Q"][i], dim=-1)
        return dot + params["bu"][u] + params["bi"][i] + params["bg"]

    # -- FIA block: [p_u (k), q_i (k), b_u, b_i] -> 2k + 2 params
    def extract_block(self, params, u, i):
        return {
            "pu": params["P"][u],
            "qi": params["Q"][i],
            "bu": params["bu"][u],
            "bi": params["bi"][i],
        }

    def with_block(self, params, block, u, i):
        u, i = (torch.as_tensor(v, device=params["P"].device) for v in (u, i))
        return {
            "P": params["P"].index_put((u,), block["pu"]),
            "Q": params["Q"].index_put((i,), block["qi"]),
            "bu": params["bu"].index_put((u,), block["bu"]),
            "bi": params["bi"].index_put((i,), block["bi"]),
            "bg": params["bg"],
        }

    def block_predict(self, params, block, u, i, x):
        """Predict rows ``x`` with the (u, i) block substituted where the
        row's user/item is (u, i) — scatter-free, so the gradient w.r.t.
        the block never builds a table-sized copy."""
        xu, xi = x[:, 0], x[:, 1]
        mu = (xu == u)[:, None]
        mi = (xi == i)[:, None]
        pu = torch.where(mu, block["pu"][None, :], params["P"][xu])
        qi = torch.where(mi, block["qi"][None, :], params["Q"][xi])
        bu = torch.where(xu == u, block["bu"], params["bu"][xu])
        bi = torch.where(xi == i, block["bi"], params["bi"][xi])
        return torch.sum(pu * qi, dim=-1) + bu + bi + params["bg"]

    def block_reg(self, params, block, u, i):
        """Scatter-free: the table reduction does not depend on the
        block, so under vmap only O(block) work is batched."""
        corr = (
            torch.sum(torch.square(block["pu"]))
            - torch.sum(torch.square(params["P"][u]))
            + torch.sum(torch.square(block["qi"]))
            - torch.sum(torch.square(params["Q"][i]))
        )
        return self.reg_loss(params) + 0.5 * self.weight_decay * corr

    def block_hessian(self, params, u, i, x, y, w):
        """Closed-form (undamped) block Hessian of ``block_loss`` over
        rows (x, y, w). With g_j = [a_j q_row; b_j p_row; a_j; b_j]
        (a_j = [user_j == u], b_j = [item_j == i]):

          H = (2/n) Σ_j w_j (g_j g_jᵀ + a_j b_j e_j [[0 I];[I 0]]) + wd·I

        on the embedding dims, the e_j term from ∇²(pu·qi) on rows equal
        to the query pair. Damping is the caller's."""
        k = self.embedding_size
        xu, xi = x[:, 0], x[:, 1]
        ma = (xu == u).to(torch.float32)
        mi = (xi == i).to(torch.float32)
        wf = w.to(torch.float32)
        a = wf * ma  # rows sharing the user
        b = wf * mi  # rows sharing the item
        n = torch.clamp(torch.sum(wf), min=1.0)

        block = self.extract_block(params, u, i)
        p_row = torch.where((xu == u)[:, None], block["pu"][None, :],
                            params["P"][xu])
        q_row = torch.where((xi == i)[:, None], block["qi"][None, :],
                            params["Q"][xi])
        e = self.block_predict(params, block, u, i, x) - y

        c = 2.0 / n
        ab = wf * ma * mi  # rows equal to the query pair (w once)
        eye = torch.eye(k, dtype=torch.float32, device=x.device)
        H_pp = c * (q_row.T * a) @ q_row + self.weight_decay * eye
        H_qq = c * (p_row.T * b) @ p_row + self.weight_decay * eye
        H_pq = c * ((q_row.T * ab) @ p_row + torch.sum(ab * e) * eye)
        h_pbu = c * q_row.T @ a
        h_pbi = c * q_row.T @ ab
        h_qbu = c * p_row.T @ ab
        h_qbi = c * p_row.T @ b
        s_aa = c * torch.sum(a)
        s_bb = c * torch.sum(b)
        s_ab = c * torch.sum(ab)

        top = torch.cat([torch.cat([H_pp, H_pq], dim=1),
                         torch.cat([H_pq.T, H_qq], dim=1)], dim=0)
        cols_b = torch.stack([torch.cat([h_pbu, h_qbu]),
                              torch.cat([h_pbi, h_qbi])], dim=1)
        corner = torch.stack([torch.stack([s_aa, s_ab]),
                              torch.stack([s_ab, s_bb])])
        return torch.cat([torch.cat([top, cols_b], dim=1),
                          torch.cat([cols_b.T, corner], dim=1)], dim=0)

    def block_row_grads(self, params, u, i, x):
        """Closed-form per-row block Jacobian
        g_j = [a_j Q[i_j] ; b_j P[u_j] ; a_j ; b_j], with
        a_j = [user_j == u] and b_j = [item_j == i]; ``u``/``i`` may be
        scalars or per-row ids aligned with ``x``."""
        xu, xi = x[:, 0], x[:, 1]
        a = (xu == u).to(torch.float32)
        b = (xi == i).to(torch.float32)
        return torch.cat(
            [
                a[:, None] * params["Q"][xi],
                b[:, None] * params["P"][xu],
                a[:, None],
                b[:, None],
            ],
            dim=1,
        )

    def grads_from_rows(self, params, rows, x, y, u, i):
        """(g, e) from pre-gathered table rows (see the base hook):
        ``block_row_grads`` and ``row_predict`` with each table index
        replaced by its gathered row."""
        xu, xi = x[:, 0], x[:, 1]
        a = (xu == u).to(torch.float32)
        b = (xi == i).to(torch.float32)
        g = torch.cat([a[:, None] * rows["Q"], b[:, None] * rows["P"],
                       a[:, None], b[:, None]], dim=1)
        own = torch.arange(x.shape[0], device=x.device)
        e = self.row_predict({**params, **rows},
                             torch.stack([own, own], dim=1)) - y
        return g, e

    # -- fused row-feature hooks (see the base hooks). Layout:
    # [Q[i_j] (k) | P[u_j] (k) | e_j | u_j | i_j], F = 2k + 3, the ids
    # packed as float32: exact below 2^24, which the engine gates on
    @property
    def row_feature_dim(self) -> int:
        return 2 * self.embedding_size + 3

    def build_row_features(self, params, x, y):
        xu, xi = x[:, 0], x[:, 1]
        e = self.row_predict(params, x) - y
        return torch.cat([params["Q"][xi], params["P"][xu], e[:, None],
                          xu.to(torch.float32)[:, None],
                          xi.to(torch.float32)[:, None]], dim=1)

    def grads_from_row_features(self, feat, u, i):
        """(g, e, a, b) of rows ``feat`` against query ids ``u``/``i``:
        the arithmetic of ``block_row_grads`` on the stored rows."""
        k = self.embedding_size
        a = (feat[:, 2 * k + 1] == u).to(torch.float32)
        b = (feat[:, 2 * k + 2] == i).to(torch.float32)
        g = torch.cat([a[:, None] * feat[:, :k],
                       b[:, None] * feat[:, k: 2 * k],
                       a[:, None], b[:, None]], dim=1)
        # e contiguous: the score kernels take it as a flat (B,) array
        return g, feat[:, 2 * k].contiguous(), a, b

    def kernel_operands(self, params):
        """The score kernel's table operands, in its order."""
        return params["P"], params["Q"]

    def block_cross_const(self, params):
        """∇²r̂ on rows equal to the query pair: ∇²(pu·qi) = [[0 I];[I 0]]
        in the (pu, qi) blocks."""
        k = self.embedding_size
        d = self.block_size
        dev = params["P"].device
        # written from a tensor on the device: a host scalar written into
        # a CUDA tensor waits for its copy, and this runs inside the flat
        # program, which must not wait before its results are fetched
        eye = torch.eye(k, dtype=torch.float32, device=dev)
        C = torch.zeros((d, d), dtype=torch.float32, device=dev)
        C[:k, k : 2 * k] = eye
        C[k : 2 * k, :k] = eye
        return C

    def block_reg_diag(self, params):
        """L2 diagonal: wd on the embedding dims, none on the biases."""
        k = self.embedding_size
        dev = params["P"].device
        return torch.cat(
            [torch.full((2 * k,), self.weight_decay, dtype=torch.float32,
                        device=dev),
             torch.zeros((2,), dtype=torch.float32, device=dev)]
        )

    @property
    def block_size(self) -> int:
        return 2 * self.embedding_size + 2
