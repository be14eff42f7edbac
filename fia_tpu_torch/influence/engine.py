"""The FIA influence engine (port of ``fia_tpu/influence/engine.py``:
``InfluenceResult``, the constructor's options its two query programs
read, the flat program (``_flat_prelude``, ``_flat_fn``'s single-device
branch, ``_query_pad``/``_s_pad_for``, ``_dispatch_flat``/
``_finalize_flat``, ``_assemble_packed``), its geometry API
(``flat_geometry``, ``precompile_flat``, ``compiled_geometries``,
``_flat_exec``), ``query_many`` with its
journal helpers, the padded per-query program
(``_query_one``, ``_batched_packed``, the single-device
``_query_padded``), the dispatch choice (``_flat_eligible``,
``_query_batch_impl``), the NaN solver ladder (``_nan_ladder``),
``query_batch``, ``get_influence_on_test_loss`` and ``related_indices``).

For a test interaction (u*, i*) the engine computes the block-restricted
inverse-HVP and scores every related training row's influence on the
test prediction. Two programs, both gathering related rows on the device
from resident CSR postings:

- flat (the default where eligible: direct solver, the model's
  Gauss-Newton hooks): every query's related rows concatenated on one
  (S,) axis, the per-query block Hessians accumulated by segment, five
  stages:

  1. the integer prelude (segment ids and train rows of the flat axis);
  2. per-row block gradients g (the model's closed-form hook);
  3. the segment-reduced damped block Hessians (a CUDA kernel on the
     card, ``kernels/segment.py``);
  4. a batched LU solve for the iHVPs;
  5. the fused score stage (the model family's CUDA kernel on the card);

  on the card each ``(t_pad, s_pad)`` geometry runs as one captured CUDA
  graph, and every stage's bits depend only on the query's own rows, so
  any batch split gives the same bits as one dispatch;

- padded (every other configuration: cg, lissa, schulz,
  ``impl="padded"``, ``hessian_mode="autodiff"``, ``group_queries``,
  ``pad_policy="dataset"``): the T queries' related rows at a common pad
  P, the block Hessian or HVP of each query from its own (P,) rows, the
  solve batched over T, and scores by per-example gradient and matvec
  (no score kernel).

Options of the reference that the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import numpy as np
import torch

from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.index import InteractionIndex, bucketed_pad
from fia_tpu_torch.device import resolve_device
from fia_tpu_torch.influence import grads as G
from fia_tpu_torch.influence import hvp as HV
from fia_tpu_torch.influence import kernels as K
from fia_tpu_torch.influence import solvers, spectral
from fia_tpu_torch.influence.kernels import common as Kc
from fia_tpu_torch.influence.kernels import segment as Kseg
from fia_tpu_torch.reliability import policy, taxonomy
from fia_tpu_torch.utils import compilemon

#: the flat program's cumulative prefixes (``_flat_fn(stage=...)``)
STAGES = ("grads", "hessian", "solve", "scores")
#: queries a piece of the flat program's query-axis stages (the test
#: vector and the batched LU): each runs in pieces of exactly this many,
#: the last padded by repeating its final query, because on the card
#: their library kernels are chosen by batch size and change bits with it
QUERY_PIECE = 64


class InfluenceResult:
    """Batched influence query results, in one of two forms.

    Packed (the flat and padded programs): one flat score array in query
    order plus counts; the padded (T, P) ``scores``/``related_idx``/
    ``related_mask`` views are built on first access. Dense
    (``group_queries`` over several pads): the (T, P) views themselves.
    ``iterations`` is the iterative solver's loop count (CG, Schulz),
    else ``None``.
    """

    def __init__(self, scores=None, related_idx=None, related_mask=None,
                 counts=None, ihvp=None, test_grad=None, packed=None,
                 test_points=None, index=None, pad=None, iterations=None):
        self.counts = counts
        self.ihvp = ihvp
        self.test_grad = test_grad
        self.iterations = iterations
        self._scores = scores
        self._related_idx = related_idx
        self._related_mask = related_mask
        self._packed = packed
        self._test_points = test_points
        self._index = index
        self._pad = pad
        self._offsets = None
        if packed is not None:
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
        if self._packed is not None:
            return self._packed[self._offsets[t] : self._offsets[t + 1]]
        return self.scores[t, : self.counts[t]]

    def related_of(self, t: int) -> np.ndarray:
        if self._packed is not None:
            u, i = (int(v) for v in self._test_points[t])
            return self._index.related(u, i)
        return self.related_idx[t, : self.counts[t]]


def _in_pieces(fn, *xs):
    """``fn`` over the leading axis of ``xs`` in pieces of exactly
    ``QUERY_PIECE`` (the last padded by repeating its final entry), the
    pieces' results concatenated and cut back to the axis' length."""
    n = xs[0].shape[0]
    outs = []
    for j in range(0, n, QUERY_PIECE):
        if j + QUERY_PIECE <= n:
            outs.append(fn(*(x[j : j + QUERY_PIECE] for x in xs)))
            continue
        idx = torch.arange(j, j + QUERY_PIECE, device=xs[0].device).clamp_(
            max=n - 1)
        outs.append(fn(*(x[idx] for x in xs)))
    return torch.cat(outs)[:n]


@contextlib.contextmanager
def capturing(graph):
    """``torch.cuda.graph(graph)`` with Python's cyclic collector paused.
    A collection in the middle of a capture can free a dead graph (one
    of a dropped engine's, held in a reference cycle), and destroying a
    graph while a stream captures invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class _FlatGraph:
    """One flat program geometry captured as a CUDA graph.

    The capture runs the program once eagerly on a side stream (kernel
    builds, library handles), then records it on a static (t_pad, 2)
    query block. A call copies the query block in, replays the graph and
    copies the outputs out, all on the current stream, so the host never
    waits and a later replay cannot overwrite outputs still in flight.
    Each replay adds the kernel launches the graph holds to the kernel
    modules' counts (the wrappers count nothing while capturing)."""

    def __init__(self, fn, args, t_pad: int, device):
        self.tx = torch.zeros((t_pad, 2), dtype=torch.int32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*args, self.tx)  # the query (0, 0) everywhere: any valid ids
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        captured = K.captured_counts()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with capturing(self.graph):
            self.out = fn(*args, self.tx)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = tuple(b - a for a, b in zip(captured,
                                                    K.captured_counts()))

    def __call__(self, tx):
        self.tx.copy_(tx, non_blocking=True)
        self.graph.replay()
        K.count_replay(self.launches)
        return tuple(o.clone() for o in self.out)


class InfluenceEngine:
    """Block-restricted (FIA) influence over a trained model.

    Args:
      model: a LatentFactorModel (MF or NCF).
      params: parameter dict (tensors or numpy arrays), moved to the
        engine's device as float32.
      train: the training RatingDataset.
      damping: Hessian damping λ, added after accumulation.
      solver: ``direct`` (materialise + LU), ``cg`` (matrix-free
        conjugate gradients), ``lissa`` (the Neumann-series recursion)
        or ``schulz`` (Newton–Schulz inversion of the materialised
        block).
      cg_maxiter, cg_tol: CG's (and Schulz's) iteration cap and
        tolerance.
      lissa_scale, lissa_depth: LiSSA's scale (a floor, see
        ``lissa_tune``) and recursion depth.
      pad_bucket: pad granule of the padded program and result views.
      hessian_mode: the padded direct/schulz Hessian: ``analytic`` (the
        model's closed-form ``block_hessian``), ``autodiff`` (HVPs over
        the identity), ``auto`` (analytic where the model has it).
      group_queries: padded path: one dispatch per pad bucket of the
        batch (a dense result) instead of one at the batch's largest pad.
      pad_policy: ``batch`` (pad to the batch's largest related set) or
        ``dataset`` (to the dataset's ceiling, max user + max item
        degree: one geometry for every batch; padded path).
      impl: ``flat``, ``padded`` or ``auto`` (flat where eligible).
      query_bucket: the query axis of a flat dispatch is padded to
        ``bucketed_pad(T, query_bucket)`` by repeating the last pair.
      kernel: flat score-stage variant, ``auto`` | ``cuda`` | ``torch``
        (:func:`fia_tpu_torch.influence.kernels.resolve_variant`).
      lissa_tune: ``spectral`` (both ends of each block's spectrum by
        power iteration give a scale past λ_max and a shift that makes
        an indefinite block PD) or ``static`` (the configured scale with
        ``solve_lissa``'s λ_max guard).
      flat_accum: the flat path's segment Hessian sums: ``auto`` (the
        CUDA kernel ``kernels/segment.py`` on the card, in pieces of
        ``piece_rows(d)`` rows from each segment's start; the row-order
        scatter form on the CPU), ``scan`` (the scatter form, the reference's
        ``body_scatter``) or ``onehot`` (a one-hot matrix product a
        chunk, the reference's ``body_onehot``). Only ``auto`` on the
        card is the same bits under any batch split; on the CPU
        ``auto`` and ``scan`` are.
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
        cg_maxiter: int = 100,
        cg_tol: float = 1e-10,
        lissa_scale: float = 10.0,
        lissa_depth: int = 10_000,  # reference depth, genericNeuralNet.py:544
        mesh=None,
        cache_dir: str | None = None,
        model_name: str = "model",
        pad_bucket: int = 128,
        shard_tables: bool = False,
        hessian_mode: str = "auto",
        group_queries: bool = False,
        pad_policy: str = "batch",
        impl: str = "auto",
        flat_chunk: int = 2048,
        row_features: str = "auto",
        query_bucket: int = 64,
        kernel: str = "auto",
        lissa_tune: str = "spectral",
        flat_accum: str = "auto",
        device=None,
    ):
        if solver not in policy.BLOCK_SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        for name, value, allowed in (
            ("impl", impl, ("auto", "flat", "padded")),
            ("row_features", row_features, ("auto", "on", "off")),
            ("hessian_mode", hessian_mode, ("auto", "analytic", "autodiff")),
            ("pad_policy", pad_policy, ("batch", "dataset")),
            ("lissa_tune", lissa_tune, ("spectral", "static")),
            ("flat_accum", flat_accum, ("auto", "scan", "onehot")),
        ):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}")
        if hessian_mode == "analytic" and model.block_hessian is None:
            raise ValueError(
                f"{type(model).__name__} defines no closed-form block_hessian"
            )
        for unported, item in (
            (solver in ("precomputed", "sampled"),
             f"solver={solver!r}: ROADMAP Queue A.9"),
            (mesh is not None, "mesh: ROADMAP Queue A.13"),
            (shard_tables, "shard_tables: ROADMAP Queue A.13"),
            (row_features == "on", "row_features='on': ROADMAP Queue A.6b"),
            (cache_dir is not None, "cache_dir: ROADMAP Queue A.10"),
        ):
            if unported:
                raise NotImplementedError(f"not ported yet — {item}")
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
        self.solver = solver
        self.cg_maxiter = int(cg_maxiter)
        self.cg_tol = float(cg_tol)
        self.lissa_scale = float(lissa_scale)
        self.lissa_depth = int(lissa_depth)
        self.lissa_tune = lissa_tune
        self.model_name = model_name
        self.pad_bucket = int(pad_bucket)
        self.hessian_mode = hessian_mode
        # 'auto' resolves as the reference does off a TPU: the closed
        # form wherever the model defines one
        self._analytic_hessian = (model.block_hessian is not None
                                  and hessian_mode != "autodiff")
        self.group_queries = bool(group_queries)
        self.pad_policy = pad_policy
        self.impl = impl
        self.flat_accum = flat_accum
        # Hessian accumulation chunk of the plain forms (scan, onehot;
        # the kernel needs none): a power of two that divides the
        # power-of-two-floored S pad, capped so the (chunk, d²) outer-
        # product buffer stays <= 64M float32 elements.
        self.flat_chunk = 1 << max(0, int(flat_chunk).bit_length() - 1)
        d_blk = int(model.block_size)
        cap_elems = 64_000_000 // max(d_blk * d_blk, 1)
        cap = 1 << max(0, cap_elems.bit_length() - 1) if cap_elems else 1
        self.flat_chunk = max(1, min(self.flat_chunk, cap))
        self.query_bucket = max(0, int(query_bucket))
        # flat programs by _flat_key: CUDA graphs on the card, the
        # program closures on the CPU; and the keys precompile_flat armed
        self._programs: dict = {}
        self._aot: set = set()

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
        ``(scores, ihvp, v)``. "segments" and "operands" return the
        inputs of the Hessian sums ``(g, t, wv, abe, off)`` and of the
        score stage ``(tx, t, rel_x, e, wv, B)``, for holding and timing
        each kernel alone at the path's shapes.
        """
        if stage not in STAGES + ("segments", "operands"):
            raise ValueError(f"unknown stage {stage!r}")
        model = self.model
        variant = self._kernel_variant
        damping = self.damping
        prelude = self._flat_prelude(s_pad)
        chunk = math.gcd(s_pad, self.flat_chunk)
        accum = self.flat_accum

        def fn(params, train_x, train_y, postings, tx):
            T = tx.shape[0]
            u, i, counts, t, row, wv, ut, it = prelude(tx, postings)
            rel_x = train_x[row]
            rel_y = train_y[row]
            g = K.row_grads(model, params, ut, it, rel_x)
            e = model.row_predict(params, rel_x) - rel_y
            ab = wv * (rel_x[:, 0] == ut) * (rel_x[:, 1] == it)
            if stage == "grads":
                return g, e

            # H_t = (2/n_t)(Σ_{s∈t} w g gᵀ + (Σ a b e) C) + diag(reg + λ)
            off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
            off.clamp_(max=s_pad)
            if stage == "segments":
                return g, t, wv, ab * e, off
            if accum == "auto":
                HH, sum_abe = Kseg.segment_sums(g, t, wv, ab * e, off, chunk)
            else:
                HH, sum_abe = Kseg.segment_sums_reference(
                    g, t, wv, ab * e, T, chunk, onehot=accum == "onehot")
            n_t = torch.clamp(counts.to(torch.float32), min=1.0)
            C = model.block_cross_const(params)
            rdiag = model.block_reg_diag(params)
            H = (2.0 / n_t)[:, None, None] * (
                HH + sum_abe[:, None, None] * C[None]
            ) + torch.diag(rdiag + damping)[None]
            if stage == "hessian":
                return H

            v = _in_pieces(torch.func.vmap(
                lambda uu, ii, xj: G.block_prediction_grad(
                    model, params, uu, ii, xj[None, :]
                )
            ), u, i, tx)
            ihvp = _in_pieces(solvers.solve_direct, H, v)
            if stage == "solve":
                return ihvp, v

            # score_s = ∇_block L(z_s) · ihvp_t / n_t, with the per-example
            # loss gradient 2 e g + wd·θ̃ (θ̃ = decayed block dims)
            theta = torch.func.vmap(
                lambda uu, ii: model.flatten_block(
                    model.extract_block(params, uu, ii)
                )
            )(u, i)
            # (T,); each row padded to a multiple of 8 entries: on the card
            # the row sum's vectorised loads start where a row starts, and
            # a row not 32-byte aligned (MF's d = 2k + 2) sums in another
            # order, so a query's reg_dot would follow its batch position
            prod = theta * rdiag[None] * ihvp
            reg_dot = torch.sum(
                torch.nn.functional.pad(prod, (0, -prod.shape[1] % 8)), dim=1)
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

    def flat_geometry(self, test_points: np.ndarray) -> tuple[int, int]:
        """``(t_pad, s_pad)`` of the flat dispatch these points would
        issue: what :meth:`precompile_flat` must arm so that the dispatch
        itself captures nothing."""
        test_points = np.asarray(test_points)
        if test_points.ndim == 1:
            test_points = test_points[None, :]
        counts = self.index.counts_batch(test_points)
        return (self._query_pad(int(test_points.shape[0])),
                self._s_pad_for(int(counts.sum())))

    def _flat_key(self, t_pad: int, s_pad: int):
        """A flat program's cache key: its geometry, the score-kernel
        variant, the Hessian form, and the addresses of the tensors it
        reads (a captured graph reads them by address)."""
        tensors = (*self.params.values(), self.train_x, self.train_y,
                   *self._postings)
        return ("flat", t_pad, s_pad, self._kernel_variant, self.flat_accum,
                tuple(x.data_ptr() for x in tensors))

    def precompile_flat(self, geometries) -> dict:
        """Build the flat programs of ``(t_pad, s_pad)`` geometries ahead
        of any dispatch (on the card, capture each as a CUDA graph), so a
        warmed engine never builds on the hot path. Geometries come from
        :meth:`flat_geometry` over the planned batches or an explicit
        list. No-op when the flat path is ineligible. Returns
        ``{"compiled": [[t, s], ...], "cached": [...], "seconds": float}``.
        """
        if not (self.impl in ("auto", "flat") and self._flat_eligible()):
            return {"compiled": [], "cached": [], "seconds": 0.0}
        t0 = time.perf_counter()
        compiled, cached = [], []
        for t_pad, s_pad in geometries:
            t_pad, s_pad = int(t_pad), int(s_pad)
            key = self._flat_key(t_pad, s_pad)
            if key in self._programs:
                cached.append([t_pad, s_pad])
            else:
                self._programs[key] = self._build_flat(t_pad, s_pad)
                compiled.append([t_pad, s_pad])
            self._aot.add(key)
        return {"compiled": compiled, "cached": cached,
                "seconds": time.perf_counter() - t0}

    def compiled_geometries(self) -> dict:
        """The built flat programs: ``"aot"``, the ``[t_pad, s_pad]``
        pairs :meth:`precompile_flat` armed, and ``"jit"``, the keys of
        those built on their first dispatch."""
        return {
            "aot": sorted([k[1], k[2]] for k in self._aot),
            "jit": sorted(str(k) for k in self._programs
                          if k not in self._aot),
        }

    def _build_flat(self, t_pad: int, s_pad: int):
        """One geometry's program as ``run(tx) -> (scores, ihvp, v)``: on
        the card a captured CUDA graph (raising with the cause if the
        program cannot be captured), on the CPU the program closure.
        Each build is counted by :mod:`fia_tpu_torch.utils.compilemon`."""
        fn = self._flat_fn(s_pad)
        args = (self.params, self.train_x, self.train_y, self._postings)
        compilemon.record()
        if self.device.type != "cuda":
            return lambda tx: fn(*args, tx)
        try:
            return _FlatGraph(fn, args, t_pad, self.device)
        except Exception as e:
            raise RuntimeError(
                f"the flat program at (t_pad, s_pad) = ({t_pad}, {s_pad}) "
                f"could not be captured as a CUDA graph: {e}") from e

    def _flat_exec(self, t_pad: int, s_pad: int):
        """The program for one dispatch geometry: the one
        :meth:`precompile_flat` or an earlier dispatch built, else built
        now (captured on its first dispatch, as ``jit`` compiles on its
        first call)."""
        key = self._flat_key(t_pad, s_pad)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build_flat(t_pad, s_pad)
        return prog

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
        tx = torch.as_tensor(tx_np.astype(np.int32))
        if self.device.type == "cuda":
            # a pageable upload would wait for the card to drain its
            # queue, and with it for every batch query_many keeps in
            # flight; a pinned one is queued like a kernel
            tx = tx.pin_memory().to(self.device, non_blocking=True)
        return counts, tx, self._s_pad_for(int(counts.sum()))

    def _dispatch_flat(self, test_points: np.ndarray, pad_to: int | None):
        """Enqueue one flat query program; returns a handle for
        :meth:`_finalize_flat`. Work is queued on the current stream and
        the host moves on."""
        counts, tx, s_pad = self._flat_inputs(test_points)
        pad = bucketed_pad(
            counts.max() if counts.size else 1, self.pad_bucket, pad_to
        )
        out = self._flat_exec(tx.shape[0], s_pad)(tx)
        return (test_points, counts, out, pad)

    def _finalize_flat(self, handle) -> InfluenceResult:
        test_points, counts, out, pad = handle
        return self._assemble_packed(test_points, counts, out, pad)

    def _assemble_packed(self, test_points, counts, out, pad: int,
                         iterations: int | None = None) -> InfluenceResult:
        """Fetch the packed outputs ``(packed, ihvp, v)`` to the host and
        wrap them as a packed result. Query-axis pad rows slice away
        here; their flat rows already sit past the real total in the
        packed scores."""
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
            iterations=iterations,
        )

    def _query_flat(self, test_points: np.ndarray,
                    pad_to: int | None = None) -> InfluenceResult:
        return self._finalize_flat(self._dispatch_flat(test_points, pad_to))

    def _flat_eligible(self) -> bool:
        return (
            self.solver == "direct"
            and not self.group_queries
            # the flat path builds the Hessian from the Gauss-Newton
            # hooks: an explicit 'autodiff' request is honoured
            and self.hessian_mode != "autodiff"
            # 'dataset' promises one geometry and a uniform output pad
            # across batches: a padded-path contract
            and self.pad_policy == "batch"
            and self.model.block_cross_const is not None
            and self.model.block_reg_diag is not None
        )

    # -- padded per-query path -------------------------------------------
    def _solve_blocks(self, params, u, i, rel_x, rel_y, w, v):
        """``(ihvp, iterations)`` of T queries' block systems over their
        padded related rows ((T, P, 2), (T, P), (T, P) weights), the
        solver's per-query branch of the reference's ``_query_one``."""
        model, damping = self.model, self.damping
        d = model.block_size
        if self.solver in ("direct", "schulz"):
            if self._analytic_hessian:
                Hmat = torch.func.vmap(
                    lambda uu, ii, xx, yy, ww: model.block_hessian(
                        params, uu, ii, xx, yy, ww)
                )(u, i, rel_x, rel_y, w)
                Hmat = Hmat + damping * torch.eye(
                    d, dtype=torch.float32, device=v.device)
            else:
                Hmat = torch.func.vmap(
                    lambda uu, ii, xx, yy, ww: HV.materialize_block_hessian(
                        model, params, uu, ii, xx, yy, ww, damping)
                )(u, i, rel_x, rel_y, w)
            if self.solver == "schulz":
                # the CG knobs; an unreachably tight tol is safe (the
                # best-iterate/divergence guard ends the loop)
                return solvers.solve_schulz(Hmat, v, maxiter=self.cg_maxiter,
                                            tol=self.cg_tol)
            return solvers.solve_direct(Hmat, v), None
        if self.solver == "cg":
            hvp = HV.make_batched_block_hvp(model, params, u, i, rel_x,
                                            rel_y, w, damping)
            return solvers.solve_cg(hvp, v, maxiter=self.cg_maxiter,
                                    tol=self.cg_tol)
        # lissa: thousands of HVPs, so the jvp is traced once
        hvp = HV.make_batched_block_hvp(model, params, u, i, rel_x, rel_y,
                                        w, damping, linearize=True)
        if self.lissa_tune == "spectral":
            # both ends of each block's spectrum: the scale clears λ_max
            # and an indefinite block (λ_min < 0 through the e·C cross
            # term, where the recursion diverges at ANY scale) is
            # shifted PD; the result solves (H + shift·I) x = v, and PD
            # blocks see shift = 0
            scale, shift = spectral.lissa_tuning(
                hvp, d, scale_floor=self.lissa_scale,
                batch_shape=(v.shape[0],), device=v.device)
            shift = shift[:, None]
            return solvers.solve_lissa(
                lambda x_: hvp(x_) + shift * x_, v, scale=scale,
                recursion_depth=self.lissa_depth, auto_scale=False), None
        # one sample: the block HVP is deterministic, so averaged
        # recursions would be identical
        return solvers.solve_lissa(hvp, v, scale=self.lissa_scale,
                                   recursion_depth=self.lissa_depth), None

    def _padded_fn(self, pad: int):
        """The reference's ``_query_one`` over T queries at once, packed
        on the device (``_batched_packed``). Returns ``fn(params,
        train_x, train_y, postings, tx, total) -> (packed, ihvp, v,
        iterations)``; ``total`` is the batch's related-row count, which
        the host knows, so packing needs no device-to-host wait."""
        model = self.model

        def fn(params, train_x, train_y, postings, tx, total: int):
            T = tx.shape[0]
            u, i = tx[:, 0].long(), tx[:, 1].long()
            # related rows: user postings first, then item postings,
            # duplicates kept (InteractionIndex.related's order)
            uoff, urows, ioff, irows = postings
            nu = uoff[u + 1] - uoff[u]
            ni = ioff[i + 1] - ioff[i]
            p = torch.arange(pad, device=tx.device)
            gu = urows[torch.clamp(uoff[u][:, None] + p, 0,
                                   urows.shape[0] - 1)]
            gi = irows[torch.clamp(ioff[i][:, None] + (p - nu[:, None]), 0,
                                   irows.shape[0] - 1)]
            rel_idx = torch.where(p < nu[:, None], gu, gi)
            rel_mask = p < (nu + ni)[:, None]
            rel_x = train_x[rel_idx]
            rel_y = train_y[rel_idx]
            w = rel_mask.to(torch.float32)
            count = torch.sum(w, dim=1)

            # v = ∇_block r̂(u*, i*), the test-side vector
            v = torch.func.vmap(
                lambda uu, ii, xj: G.block_prediction_grad(
                    model, params, uu, ii, xj[None, :])
            )(u, i, tx)
            ihvp, iterations = self._solve_blocks(params, u, i, rel_x, rel_y,
                                                  w, v)

            # per-example loss gradients and one matvec a query
            per_ex = torch.func.vmap(
                lambda uu, ii, xx, yy: G.per_example_block_loss_grads(
                    model, params, uu, ii, xx, yy)
            )(u, i, rel_x, rel_y)
            scores = (per_ex @ ihvp[:, :, None])[..., 0] / torch.clamp(
                count, min=1.0)[:, None]
            scores = torch.where(rel_mask, scores, 0.0)

            # pack the valid entries in query order: positions from the
            # counts, not a boolean mask (which waits on the device)
            n = nu + ni
            tq = torch.repeat_interleave(torch.arange(T, device=tx.device),
                                         n, output_size=total)
            start = torch.cumsum(n, 0) - n
            pos = torch.arange(total, device=tx.device) - start[tq]
            packed = scores.reshape(-1)[tq * pad + pos]
            return packed, ihvp, v, iterations

        return fn

    def _query_padded(self, test_points: np.ndarray, pad_to: int | None
                      ) -> InfluenceResult:
        """One padded dispatch at a single pad length."""
        counts = self.index.counts_batch(test_points)
        m = counts.max() if counts.size else 1
        if pad_to is None and self.pad_policy == "dataset":
            m = self.index.max_related_count()
        pad = bucketed_pad(m, self.pad_bucket, pad_to)
        tx = torch.as_tensor(
            np.asarray(test_points, np.int64).astype(np.int32)
        ).to(self.device)
        *out, iterations = self._padded_fn(pad)(
            self.params, self.train_x, self.train_y, self._postings, tx,
            int(counts.sum()),
        )
        return self._assemble_packed(test_points, counts, out, pad,
                                     iterations)

    def _query_grouped(self, test_points: np.ndarray) -> InfluenceResult:
        """``group_queries``: one padded dispatch per pad bucket of the
        batch, stitched into a dense result at the largest pad."""
        counts = self.index.counts_batch(test_points).astype(np.int64)
        pads = np.array([bucketed_pad(int(c), self.pad_bucket)
                         for c in counts])
        uniq = np.unique(pads)
        if len(uniq) == 1:
            return self._query_padded(test_points, None)
        T, P = len(test_points), int(uniq.max())
        d = self.model.block_size
        scores = np.zeros((T, P), np.float32)
        rel_idx = np.zeros((T, P), np.int32)
        rel_mask = np.zeros((T, P), bool)
        out_counts = np.zeros(T, np.int32)
        ihvp = np.zeros((T, d), np.float32)
        test_grad = np.zeros((T, d), np.float32)
        iterations = None
        for p in uniq:
            sel = np.flatnonzero(pads == p)
            r = self._query_padded(test_points[sel], int(p))
            w = r.scores.shape[1]
            scores[sel, :w] = r.scores
            rel_idx[sel, :w] = r.related_idx
            rel_mask[sel, :w] = r.related_mask
            out_counts[sel] = r.counts
            ihvp[sel] = r.ihvp
            test_grad[sel] = r.test_grad
            if r.iterations is not None:
                iterations = max(iterations or 0, r.iterations)
        return InfluenceResult(scores, rel_idx, rel_mask, out_counts, ihvp,
                               test_grad, iterations=iterations)

    # -- public API --------------------------------------------------------
    def _query_batch_impl(self, test_points: np.ndarray,
                          pad_to: int | None) -> InfluenceResult:
        test_points = np.asarray(test_points)
        if test_points.ndim == 1:
            test_points = test_points[None, :]
        if self.impl in ("auto", "flat") and self._flat_eligible():
            return self._query_flat(test_points, pad_to)
        if self.impl == "flat":
            raise ValueError(
                "impl='flat' requires the direct solver, a model defining "
                "the Gauss-Newton hooks, pad_policy='batch', and no "
                "explicit hessian_mode='autodiff'"
            )
        if self.group_queries and pad_to is None and len(test_points) > 1:
            return self._query_grouped(test_points)
        return self._query_padded(test_points, pad_to)

    def _nan_ladder(self, res: InfluenceResult, recompute) -> InfluenceResult:
        """Escalate the solver until the payload is finite, or the ladder
        bottoms out at the direct solve. Escalation is sticky: the
        engine keeps the more robust solver for later batches (the block
        spectrum that diverged once will diverge again)."""
        while taxonomy.classify_payload(
            res.ihvp, res.test_grad, res._packed, res._scores
        ) is not None:
            nxt = policy.next_solver(self.solver)
            if nxt is None:
                _diag(f"non-finite influence payload from the {self.solver!r} "
                      "solver with no fallback rung left; returning as-is "
                      "(check damping/conditioning)")
                return res
            _diag(f"non-finite influence payload from {self.solver!r}; "
                  f"escalating solver to {nxt!r}")
            self.solver = nxt
            res = recompute()
        return res

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
          pad_to: a fixed pad length (disables grouping).

        A non-finite payload (a diverged LiSSA or Schulz solve returns a
        "successful" NaN buffer) escalates the solver down the ladder
        (``lissa → cg → direct``, ``schulz → direct``) and recomputes.
        """
        res = self._query_batch_impl(test_points, pad_to)
        return self._nan_ladder(
            res, lambda: self._query_batch_impl(test_points, pad_to))

    def query_many(
        self,
        test_points: np.ndarray,
        batch_queries: int = 256,
        pad_to: int | None = None,
        window: int = 4,
        journal=None,
        deadline=None,
    ) -> list[InfluenceResult]:
        """Large workloads in batches of ``batch_queries``: up to
        ``window`` flat programs in flight on the card, finalized in
        order (port of ``fia_tpu/influence/engine.py:1509-1603``).

        Batch k + ``window`` is dispatched before batch k is fetched, so
        the host's work for one batch (counts, geometry, result
        assembly) overlaps the card's work on the others; the flat
        program waits on the device nowhere before its results are
        fetched. Falls back to sequential :meth:`query_batch` whenever
        the flat path is ineligible.

        ``journal``: a reliability :class:`~fia_tpu_torch.reliability.
        journal.Journal` (open it against :meth:`journal_fingerprint`);
        each finalized batch is recorded durably, and batches already
        journaled are rebuilt from it instead of recomputed.
        ``deadline``: a reliability ``Deadline``; expiry between batches
        raises ``DeadlineExpired`` with every completed batch journaled.

        Two pieces of the reference are not carried over. Its
        ``_wide_block_cap`` (``engine.py:1494-1507``) caps wide-block
        dispatches at 32 queries to dodge a fault of the TPU worker, and
        is scoped to that backend. Its worker-crash recovery
        (``engine.py:1586-1603``: classify, rebuild the device state,
        finish sequentially) belongs to ROADMAP Queue A.10; until then a
        device failure rises to the caller, with the finished batches
        journaled.
        """
        test_points = np.asarray(test_points)
        if test_points.ndim == 1:
            test_points = test_points[None, :]
        batches = [
            test_points[i : i + batch_queries]
            for i in range(0, len(test_points), batch_queries)
        ]
        results: list[InfluenceResult | None] = [None] * len(batches)
        todo: list[int] = []
        for k in range(len(batches)):
            if journal is not None and journal.done(f"batch:{k}"):
                results[k] = self._result_from_journal(
                    journal.get(f"batch:{k}")
                )
            else:
                todo.append(k)

        def bank(k: int, res: InfluenceResult) -> None:
            results[k] = res
            if journal is not None:
                journal.record(f"batch:{k}", self._journal_payload(res))

        if not (self.impl in ("auto", "flat") and self._flat_eligible()):
            for k in todo:
                if deadline is not None:
                    deadline.check("query_many (sequential)")
                bank(k, self.query_batch(batches[k], pad_to=pad_to))
            return results
        inflight: list = []
        for k in todo:
            if deadline is not None:
                deadline.check("query_many (dispatch)")
            inflight.append((k, self._dispatch_flat(batches[k], pad_to)))
            if len(inflight) >= max(1, window):
                j, h = inflight.pop(0)
                bank(j, self._finalize_flat(h))
        while inflight:
            j, h = inflight.pop(0)
            bank(j, self._finalize_flat(h))
        return results

    # -- resumable-execution plumbing --------------------------------------
    def journal_fingerprint(self, test_points: np.ndarray,
                            batch_queries: int = 256,
                            pad_to: int | None = None, **extra) -> dict:
        """Identity of a :meth:`query_many` workload for journal binding
        (the reference's fields): two runs share journal progress iff
        model, solver and config, the test points AND the batch split
        agree. ``extra`` folds in the caller's own provenance."""
        import hashlib

        tp = np.ascontiguousarray(np.asarray(test_points, np.int64))
        return {
            "kind": "query_many",
            "model": self.model_name,
            "solver": self.solver,
            "damping": repr(self.damping),
            "pad_bucket": self.pad_bucket,
            # the query-axis pad sets the batched solve's geometry
            "query_bucket": self.query_bucket,
            "batch_queries": int(batch_queries),
            "pad_to": None if pad_to is None else int(pad_to),
            "n_points": int(tp.shape[0]) if tp.ndim > 1 else 1,
            "points_sha1": hashlib.sha1(tp.tobytes()).hexdigest(),
            **extra,
        }

    def _journal_payload(self, res: InfluenceResult) -> dict:
        """JSON-packable form of one batch result (exact round-trip;
        the reference's fields less the sampled rung's, ROADMAP A.9)."""
        base = {
            "counts": np.asarray(res.counts),
            "ihvp": np.asarray(res.ihvp),
            "test_grad": np.asarray(res.test_grad),
        }
        if res._packed is not None:
            base.update(
                fmt="packed",
                packed=np.asarray(res._packed),
                test_points=np.asarray(res._test_points),
                pad=int(res._pad),
            )
        else:
            base.update(
                fmt="dense",
                scores=np.asarray(res.scores),
                related_idx=np.asarray(res.related_idx),
                related_mask=np.asarray(res.related_mask),
            )
        return base

    def _result_from_journal(self, p: dict) -> InfluenceResult:
        if p["fmt"] == "packed":
            return InfluenceResult(
                counts=p["counts"], ihvp=p["ihvp"],
                test_grad=p["test_grad"], packed=p["packed"],
                test_points=p["test_points"], index=self.index,
                pad=int(p["pad"]),
            )
        return InfluenceResult(
            p["scores"], p["related_idx"], p["related_mask"],
            p["counts"], p["ihvp"], p["test_grad"],
        )

    def get_influence_on_test_loss(self, test_indices, test_ds: RatingDataset,
                                   force_refresh: bool = True,
                                   test_description=None) -> np.ndarray:
        """The reference's signature: the scores of the related training
        rows of ``test_ds.x[test_indices[0]]`` (one index at a time)."""
        if len(test_indices) != 1:
            raise ValueError(
                f"one test index at a time, got {len(test_indices)}")
        point = np.asarray(test_ds.x[int(test_indices[0])])
        return self.query_batch(point[None, :]).scores_of(0)

    def related_indices(self, test_point) -> np.ndarray:
        u, i = int(test_point[0]), int(test_point[1])
        return self.index.related(u, i)


def _diag(msg: str) -> None:
    """One reliability diagnostic on stderr (the reference's
    ``obs.diag`` channel and format)."""
    sys.stderr.write(f"[reliability] {msg}\n")
