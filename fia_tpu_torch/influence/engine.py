"""The FIA influence engine, flat direct-solve path (port of
``fia_tpu/influence/engine.py``: ``InfluenceResult``, the constructor's
subset this path reads, ``_flat_prelude``, ``_flat_fn``'s single-device
branch, ``_query_pad``/``_s_pad_for``, ``_dispatch_flat``/
``_finalize_flat``, ``_assemble_packed`` and ``query_batch``).

For a test interaction (u*, i*) the engine computes the block-restricted
inverse-HVP and scores every related training row's influence on the
test prediction. A (T, 2) batch runs as one flat program: every query's
related rows concatenated on one (S,) axis, gathered on the device from
resident CSR postings, with the per-query Gauss-Newton block Hessians
accumulated by segment. Five stages:

  1. the integer prelude (segment ids and train rows of the flat axis);
  2. per-row block gradients g (the model's closed-form hook);
  3. the segment-reduced damped block Hessians;
  4. a batched LU solve for the iHVPs;
  5. the fused score stage (the model family's CUDA kernel on the card).

Options of the reference that this slice does not port raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.index import InteractionIndex, bucketed_pad
from fia_tpu_torch.device import resolve_device
from fia_tpu_torch.influence import grads as G
from fia_tpu_torch.influence import kernels as K
from fia_tpu_torch.influence import solvers
from fia_tpu_torch.influence.kernels import common as Kc

#: the flat program's cumulative prefixes (``_flat_fn(stage=...)``)
STAGES = ("grads", "hessian", "solve", "scores")


class InfluenceResult:
    """Batched influence query results, stored PACKED: one flat score
    array in query order plus counts. The padded (T, P) ``scores``/
    ``related_idx``/``related_mask`` views are built on first access."""

    def __init__(self, counts, ihvp, test_grad, packed, test_points, index,
                 pad):
        self.counts = counts
        self.ihvp = ihvp
        self.test_grad = test_grad
        self._packed = packed
        self._test_points = test_points
        self._index = index
        self._pad = pad
        self._scores = self._related_idx = self._related_mask = None
        self._offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(counts, np.int64))]
        )

    def _materialize(self):
        rel_idx, rel_mask, _ = self._index.related_padded(
            self._test_points, pad_to=self._pad
        )
        scores = np.zeros((len(self._test_points), self._pad), np.float32)
        scores[rel_mask] = self._packed
        self._scores = scores
        self._related_idx = rel_idx
        self._related_mask = rel_mask

    @property
    def scores(self) -> np.ndarray:  # (T, P), 0 on padding
        if self._scores is None:
            self._materialize()
        return self._scores

    @property
    def related_idx(self) -> np.ndarray:  # (T, P) train-row ids
        if self._related_idx is None:
            self._materialize()
        return self._related_idx

    @property
    def related_mask(self) -> np.ndarray:  # (T, P) bool
        if self._related_mask is None:
            self._materialize()
        return self._related_mask

    def scores_of(self, t: int) -> np.ndarray:
        """Unpadded scores for test point t."""
        return self._packed[self._offsets[t] : self._offsets[t + 1]]

    def related_of(self, t: int) -> np.ndarray:
        u, i = (int(v) for v in self._test_points[t])
        return self._index.related(u, i)


def _segment_hessian(g, t, wv, abe, T: int, chunk: int, onehot: bool):
    """Per-segment sums ``(T, d, d) Σ_{s∈t} wv_s g_s g_sᵀ`` and
    ``(T,) Σ_{s∈t} abe_s``, chunk by chunk in row order.

    ``onehot`` (the CUDA form) contracts a (T, chunk) one-hot with the
    chunk's (chunk, d²) outer products in one float32 matrix product
    per chunk: ~2·T·S·d² flops, but deterministic for a fixed geometry,
    where ``index_add_`` on CUDA adds with atomics in no fixed order.
    Otherwise (the CPU form) the outer products are scatter-added, the
    reference's ``body_scatter``.
    """
    S, d = g.shape
    acc = g.new_zeros((T, d * d))
    s_abe = g.new_zeros((T,))
    ids = torch.arange(T, device=g.device, dtype=t.dtype)
    for c0 in range(0, S, chunk):
        gc, tc = g[c0 : c0 + chunk], t[c0 : c0 + chunk]
        wc, ac = wv[c0 : c0 + chunk], abe[c0 : c0 + chunk]
        outer = ((gc * wc[:, None])[:, :, None] * gc[:, None, :]).reshape(
            -1, d * d
        )
        if onehot:
            oh = (tc[:, None] == ids[None, :]).to(torch.float32)  # (chunk, T)
            acc.addmm_(oh.T, outer)
            s_abe += torch.sum(oh * ac[:, None], dim=0)
        else:
            tl = tc.long()
            acc.index_add_(0, tl, outer)
            s_abe.index_add_(0, tl, ac)
    return acc.reshape(T, d, d), s_abe


class InfluenceEngine:
    """Block-restricted (FIA) influence over a trained model.

    Args:
      model: a LatentFactorModel with the Gauss-Newton hooks and a
        score-kernel family (MF or NCF).
      params: parameter dict (tensors or numpy arrays), moved to the
        engine's device as float32.
      train: the training RatingDataset.
      damping: Hessian damping λ, added after accumulation.
      query_bucket: the query axis of a dispatch is padded to
        ``bucketed_pad(T, query_bucket)`` by repeating the last pair.
      kernel: score-stage variant, ``auto`` | ``cuda`` | ``torch``
        (:func:`fia_tpu_torch.influence.kernels.resolve_variant`).
      device: ``None`` (the CUDA device; raises without one), ``"cuda"``
        or ``"cpu"``.
    """

    def __init__(
        self,
        model,
        params,
        train: RatingDataset,
        damping: float = 1e-6,
        solver: str = "direct",
        mesh=None,
        cache_dir: str | None = None,
        pad_bucket: int = 128,
        shard_tables: bool = False,
        impl: str = "auto",
        flat_chunk: int = 2048,
        row_features: str = "auto",
        query_bucket: int = 64,
        kernel: str = "auto",
        device=None,
    ):
        if solver not in ("direct", "cg", "lissa", "schulz",
                          "precomputed", "sampled"):
            raise ValueError(f"unknown solver {solver!r}")
        if impl not in ("auto", "flat", "padded"):
            raise ValueError(f"unknown impl {impl!r}")
        if row_features not in ("auto", "on", "off"):
            raise ValueError(f"unknown row_features {row_features!r}")
        for unported, item in (
            (solver != "direct", f"solver={solver!r}: ROADMAP Queue A.4 and A.9"),
            (mesh is not None, "mesh: ROADMAP Queue A.13"),
            (shard_tables, "shard_tables: ROADMAP Queue A.13"),
            (row_features == "on", "row_features='on': ROADMAP Queue A.6"),
            (impl == "padded", "impl='padded': ROADMAP Queue A.6"),
            (cache_dir is not None, "cache_dir: ROADMAP Queue A.10"),
        ):
            if unported:
                raise NotImplementedError(f"not ported yet — {item}")
        if model.block_cross_const is None or model.block_reg_diag is None:
            raise ValueError(
                f"{type(model).__name__} lacks the Gauss-Newton hooks the "
                "flat path needs"
            )
        self.device = resolve_device(device)
        self.model = model
        self._kernel_variant = K.resolve_variant(kernel, model, self.device)
        self.params = {
            k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
            for k, v in params.items()
        }
        self.index = InteractionIndex(train.x, model.num_users, model.num_items)
        self.train_x = torch.as_tensor(train.x).to(self.device)  # int32
        self.train_y = torch.as_tensor(train.y).to(self.device)
        self._postings = tuple(
            torch.as_tensor(a).to(self.device) for a in self.index.postings()
        )
        self.damping = float(damping)
        self.pad_bucket = int(pad_bucket)
        # Hessian accumulation chunk: a power of two that divides the
        # power-of-two-floored S pad, capped so the (chunk, d²) outer-
        # product buffer stays <= 64M float32 elements.
        self.flat_chunk = 1 << max(0, int(flat_chunk).bit_length() - 1)
        d_blk = int(model.block_size)
        cap_elems = 64_000_000 // max(d_blk * d_blk, 1)
        cap = 1 << max(0, cap_elems.bit_length() - 1) if cap_elems else 1
        self.flat_chunk = max(1, min(self.flat_chunk, cap))
        self.query_bucket = max(0, int(query_bucket))

    def active_kernel_variant(self) -> str:
        return self._kernel_variant

    # -- flat segment-sum query path --------------------------------------
    @staticmethod
    def _flat_prelude(s_pad: int):
        """The flat program's integer prelude: maps a (T, 2) query block
        and the CSR postings to per-flat-position
        ``(u, i, counts, t, row, wv, ut, it)`` — segment ids ``t``, the
        owning train-row index ``row``, validity weights ``wv`` and the
        per-row owning-query ids ``ut``/``it``."""

        def prelude(tx, postings):
            T = tx.shape[0]
            u, i = tx[:, 0], tx[:, 1]
            uoff, urows, ioff, irows = postings
            nu = uoff[u + 1] - uoff[u]
            ni = ioff[i + 1] - ioff[i]
            counts = nu + ni
            off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
            total = off[-1]

            s = torch.arange(s_pad, dtype=off.dtype, device=tx.device)
            # segment id = number of segment starts off[1:T] at or before
            # s: the reference's scatter + cumsum, as one sorted search
            # (empty segments share an offset and are skipped alike)
            t = torch.searchsorted(off[1:T].contiguous(), s, right=True,
                                   out_int32=True)
            pos = s - off[t]
            valid = s < total
            ut, it = u[t], i[t]
            # ONE flat-row gather from the concatenated postings (item
            # lists offset past the user lists)
            cat_rows = torch.cat([urows, irows])
            nut = nu[t]
            base = torch.where(
                pos < nut,
                uoff[ut] + pos,
                urows.shape[0] + ioff[it] + pos - nut,
            )
            row = cat_rows[base.clamp(0, cat_rows.shape[0] - 1)]
            wv = valid.to(torch.float32)
            return u, i, counts, t, row, wv, ut, it

        return prelude

    def _flat_fn(self, s_pad: int, stage: str = "scores"):
        """All queries' related rows on one flat (S,) axis; per-query
        Hessians accumulated by segment reduction.

        Returns ``fn(params, train_x, train_y, postings, tx)``. ``stage``
        truncates the program to a cumulative prefix: "grads" returns
        ``(g, e)``, "hessian" the damped ``H`` (T, d, d), "solve"
        ``(ihvp, v)``, "scores" (the default, the full program)
        ``(scores, ihvp, v)``. "operands" returns the score stage's
        inputs ``(tx, t, rel_x, e, wv, B)``, for timing the score kernel
        alone at the path's shapes.
        """
        if stage not in STAGES + ("operands",):
            raise ValueError(f"unknown stage {stage!r}")
        model = self.model
        variant = self._kernel_variant
        damping = self.damping
        prelude = self._flat_prelude(s_pad)
        chunk = math.gcd(s_pad, self.flat_chunk)
        onehot = self.device.type == "cuda"

        def fn(params, train_x, train_y, postings, tx):
            T = tx.shape[0]
            u, i, counts, t, row, wv, ut, it = prelude(tx, postings)
            rel_x = train_x[row]
            rel_y = train_y[row]
            g = K.row_grads(model, params, ut, it, rel_x)
            e = model.predict(params, rel_x) - rel_y
            ab = wv * (rel_x[:, 0] == ut) * (rel_x[:, 1] == it)
            if stage == "grads":
                return g, e

            # H_t = (2/n_t)(Σ_{s∈t} w g gᵀ + (Σ a b e) C) + diag(reg + λ)
            HH, sum_abe = _segment_hessian(g, t, wv, ab * e, T, chunk, onehot)
            n_t = torch.clamp(counts.to(torch.float32), min=1.0)
            C = model.block_cross_const(params)
            rdiag = model.block_reg_diag(params)
            H = (2.0 / n_t)[:, None, None] * (
                HH + sum_abe[:, None, None] * C[None]
            ) + torch.diag(rdiag + damping)[None]
            if stage == "hessian":
                return H

            v = torch.func.vmap(
                lambda uu, ii, xj: G.block_prediction_grad(
                    model, params, uu, ii, xj[None, :]
                )
            )(u, i, tx)
            ihvp = solvers.solve_direct(H, v)
            if stage == "solve":
                return ihvp, v

            # score_s = ∇_block L(z_s) · ihvp_t / n_t, with the per-example
            # loss gradient 2 e g + wd·θ̃ (θ̃ = decayed block dims)
            theta = torch.func.vmap(
                lambda uu, ii: model.flatten_block(
                    model.extract_block(params, uu, ii)
                )
            )(u, i)
            reg_dot = torch.sum(theta * rdiag[None] * ihvp, dim=1)  # (T,)
            B = Kc.query_matrix(ihvp, reg_dot, n_t)
            if stage == "operands":
                return tx, t, rel_x, e, wv, B
            scores = K.fused_scores(model, variant, params, tx, t, rel_x,
                                    e, wv, B)
            return scores, ihvp, v

        return fn

    def _query_pad(self, T: int) -> int:
        """Query-axis pad of a flat dispatch (see ``query_bucket``)."""
        if self.query_bucket <= 0:
            return T
        return bucketed_pad(T, self.query_bucket)

    def _s_pad_for(self, total: int) -> int:
        """Flat-axis pad for ``total`` related rows: geometric bucketing
        (~12.5% granule) above a 2048 floor, so S stays a multiple of
        every power-of-two chunk up to 2048."""
        return bucketed_pad(total, 2048)

    def _flat_inputs(self, test_points: np.ndarray):
        """``(counts, tx, s_pad)`` of one flat dispatch: host-side
        related counts, the (t_pad, 2) int32 query block on the device
        (padded by duplicating the trailing pair), and the flat pad."""
        test_points = np.asarray(test_points)
        counts = self.index.counts_batch(test_points)
        tx_np = np.ascontiguousarray(np.asarray(test_points, np.int64))
        T = tx_np.shape[0]
        t_pad = self._query_pad(T)
        if t_pad > T:
            # Pad rows take flat positions AFTER the real total (their
            # segment offsets start at off[T]), so real scores are
            # untouched and _assemble_packed slices them away; pad rows
            # past s_pad are simply truncated.
            tx_np = np.concatenate(
                [tx_np, np.repeat(tx_np[-1:], t_pad - T, axis=0)]
            )
        tx = torch.as_tensor(tx_np.astype(np.int32)).to(self.device)
        return counts, tx, self._s_pad_for(int(counts.sum()))

    def _dispatch_flat(self, test_points: np.ndarray, pad_to: int | None):
        """Enqueue one flat query program; returns a handle for
        :meth:`_finalize_flat`. Work is queued on the current stream and
        the host moves on."""
        counts, tx, s_pad = self._flat_inputs(test_points)
        pad = bucketed_pad(
            counts.max() if counts.size else 1, self.pad_bucket, pad_to
        )
        out = self._flat_fn(s_pad)(
            self.params, self.train_x, self.train_y, self._postings, tx
        )
        return (test_points, counts, out, pad)

    def _finalize_flat(self, handle) -> InfluenceResult:
        test_points, counts, out, pad = handle
        return self._assemble_packed(test_points, counts, out, pad)

    def _assemble_packed(self, test_points, counts, out, pad: int
                         ) -> InfluenceResult:
        """Fetch the flat outputs to the host and wrap them as a packed
        result. Query-axis pad rows slice away here; their flat rows
        already sit past the real total in the packed scores."""
        packed, ihvp, v = (o.cpu().numpy() for o in out)
        T = int(np.asarray(counts).shape[0])
        total = int(counts.sum())
        return InfluenceResult(
            counts=counts,
            ihvp=ihvp[:T],
            test_grad=v[:T],
            packed=packed[:total],
            test_points=np.asarray(test_points),
            index=self.index,
            pad=pad,
        )

    def _query_flat(self, test_points: np.ndarray,
                    pad_to: int | None = None) -> InfluenceResult:
        return self._finalize_flat(self._dispatch_flat(test_points, pad_to))

    # -- public API --------------------------------------------------------
    def query_batch(
        self,
        test_points: np.ndarray,
        test_ratings: np.ndarray | None = None,
        pad_to: int | None = None,
    ) -> InfluenceResult:
        """Influence of related training rows on each test prediction.

        Args:
          test_points: (T, 2) int array of (user, item) pairs.
          test_ratings: unused by the prediction-influence path (the test
            vector is ∇r̂, not ∇loss); accepted for API symmetry.
          pad_to: a fixed pad length for the padded result views.
        """
        test_points = np.asarray(test_points)
        if test_points.ndim == 1:
            test_points = test_points[None, :]
        return self._query_flat(test_points, pad_to)
