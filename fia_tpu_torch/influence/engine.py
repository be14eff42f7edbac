"""The FIA influence engine (port of ``fia_tpu/influence/engine.py``:
``InfluenceResult``, ``_concat_results``, the constructor's options its
query programs read, the flat program (``_flat_prelude``, ``_flat_fn``'s
single-device branch, ``_query_pad``/``_s_pad_for``, ``_dispatch_flat``/
``_finalize_flat``, ``_assemble_packed``), its geometry API
(``flat_geometry``, ``precompile_flat``, ``compiled_geometries``,
``_flat_exec``), ``query_many`` with its journal helpers, the padded
per-query program (``_query_one``, ``_batched_packed``,
``_query_padded``), the dispatch choice
(``_flat_eligible``, ``_query_batch_impl``), the NaN solver ladder
(``_nan_ladder``), the factor-bank rung (``block_hessians``, the bank
load/unload methods, ``_bank_fn``, ``_query_bank_hits``,
``_merge_stream``, ``_query_precomputed``), the certified sampled rung
(``_flat_fn``'s sampled mode, ``_query_sampled``, ``_dispatch_sampled``,
``_sampled_fallback``, ``approx_sibling``, ``_result_take``),
``query_batch``, ``get_influence_on_test_loss`` with its iHVP disk cache,
``related_indices``, and the device-failure recovery ladders:
``_upload_device_state``/``_reset_device_state``, ``_query_flat``'s
rebuild-and-retry, ``_query_on_cpu``, ``query_many``'s crash recovery and
the padded path's memory envelope, ``_query_padded_adaptive`` and
``_adaptive_run`` with :mod:`fia_tpu_torch.utils.memlimits`).

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
  any batch split gives the same bits as one dispatch. Two rungs of the
  solver ladder run the same stages: ``precomputed`` takes each banked
  query's iHVP from its factor in place of stages 3-4, and ``sampled``
  weights the Hessian's rows by a per-query sample and adds a
  certificate (``kernels/certificate.py``, ``kernels/eigmin.py``), each
  a captured graph a geometry too;

- padded (every other configuration: cg, lissa, schulz,
  ``impl="padded"``, ``hessian_mode="autodiff"``, ``group_queries``,
  ``pad_policy="dataset"``): the T queries' related rows at a common pad
  P, the block Hessian or HVP of each query from its own (P,) rows, the
  solve batched over T, and scores by per-example gradient and matvec
  (no score kernel).

A classified device failure (:mod:`fia_tpu_torch.reliability.taxonomy`)
walks a recovery ladder, as in the reference: a preemption rebuilds the
device state from the host copies taken at construction and retries at
the same size, a worker death rebuilds and retries in halves, an
out-of-memory failure halves a padded batch (learning a memory envelope
that persists across processes) or ends a flat one at the CPU rung
(``cpu_fallback``, off by default). An unclassified failure (a kernel that does not
build or launch) and CUDA's sticky errors (``DEVICE_LOST``) rise. The
flat program is split invariant, so a flat batch recovered by halving
or resumed after a crash gives the bits of the run without the fault.

The engine reports into the obs spine (:mod:`fia_tpu_torch.obs`) under
the reference's names: spans ``engine.query``, ``engine.dispatch_flat``,
``engine.dispatch_sampled``, ``engine.precompile``, ``engine.bank_load``;
counters ``engine.aot_hits``/``aot_misses``, ``engine.bank_hits``/
``bank_misses``, ``engine.sampled_queries``,
``engine.sampled_escalations{reason}``, ``engine.queries_total{solver}``,
``engine.solver_escalations{from,to}``, and the port's
``engine.device_resets`` and ``engine.cpu_fallback_batches``.

Over a device mesh (``mesh=``, :mod:`fia_tpu_torch.parallel.mesh`) the
query axis is sharded along ``data`` as in the reference (docs/design.md
§15): each contiguous query shard runs the unchanged single-device
program on its slot's device, with no collective, and the host stitches
the packed outputs, so every mesh size gives the single-device bits.
With ``shard_tables`` the embedding tables are row-sharded over the
mesh's ``model`` axis (docs/design.md §20): each query shard first
gathers the table rows its queries read from the row shards
(:meth:`_local_tables`, outside any captured graph), then runs the same
program on those shard-local tables with its ids remapped into them, the
score kernel included: the replicated program's bits. Over a mesh that
spans processes each process runs its own shards and the outputs are
all-gathered and stitched in global shard order
(:mod:`fia_tpu_torch.parallel.distributed`).
:meth:`InfluenceEngine.rebuild_mesh` re-homes the engine on a shrunk mesh
after device loss (``engine.mesh_rebuilds``, the ``mesh.rebuild`` site and
event). Options of the reference that the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import math
import os
import time

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.index import InteractionIndex, bucketed_pad
from fia_tpu_torch.influence import grads as G
from fia_tpu_torch.influence import hvp as HV
from fia_tpu_torch.influence import kernels as K
from fia_tpu_torch.influence import sampled as sampled_mod
from fia_tpu_torch.influence import solvers, spectral
from fia_tpu_torch.influence.kernels import certificate as Kcert
from fia_tpu_torch.influence.kernels import common as Kc
from fia_tpu_torch.influence.kernels import eigmin as Keig
from fia_tpu_torch.influence.kernels import segment as Kseg
from fia_tpu_torch.parallel import distributed as pdist
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.parallel import sharded as SH
from fia_tpu_torch.reliability import inject, policy, sites, taxonomy
from fia_tpu_torch.utils import compilemon, memlimits

#: the flat program's cumulative prefixes (``_flat_fn(stage=...)``)
STAGES = ("grads", "hessian", "solve", "scores")
#: the flat program's modes: the direct solve, the sampled rung's
#: weighted Hessian with its certificate, the factor bank's iHVPs
MODES = ("direct", "sampled", "bank")
#: queries a piece of the flat program's query-axis stages (the test
#: vector and the batched LU): each runs in pieces of exactly this many,
#: the last padded by repeating its final query, because on the card
#: their library kernels are chosen by batch size and change bits with it
QUERY_PIECE = 64
#: failure kinds the device ladders absorb (rebuild, retry, halve, the CPU
#: rung); every other kind, and an unclassified failure, rises
_ADAPTIVE_KINDS = frozenset({taxonomy.OOM, taxonomy.AMBIGUOUS,
                             taxonomy.WORKER, taxonomy.PREEMPTION})
#: those the padded path's envelope absorbs (halve, rebuild, retry)
_PADDED_KINDS = frozenset({taxonomy.OOM, taxonomy.WORKER,
                           taxonomy.PREEMPTION})


class InfluenceResult:
    """Batched influence query results, in one of two forms.

    Packed (the flat and padded programs): one flat score array in query
    order plus counts; the padded (T, P) ``scores``/``related_idx``/
    ``related_mask`` views are built on first access. Dense
    (``group_queries`` over several pads): the (T, P) views themselves.
    ``iterations`` is the iterative solver's loop count (CG, Schulz),
    else ``None``. Certified-approximate payloads (``solver="sampled"``):
    ``err_bound`` is a (T,) per-query bound on the largest per-row score
    error (0 for exactly solved queries), and ``approx`` marks a result
    holding at least one subsampled answer; ``None``/``False`` on every
    exact path.
    """

    def __init__(self, scores=None, related_idx=None, related_mask=None,
                 counts=None, ihvp=None, test_grad=None, packed=None,
                 test_points=None, index=None, pad=None, iterations=None,
                 err_bound=None, approx=False):
        self.counts = counts
        self.ihvp = ihvp
        self.test_grad = test_grad
        self.iterations = iterations
        self.err_bound = None if err_bound is None else np.asarray(err_bound)
        self.approx = bool(approx)
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


def _concat_results(parts: list[InfluenceResult]) -> InfluenceResult:
    """Stitch the results of chunks of one batch back into one, in query
    order: packed scores concatenate (each query's rows are contiguous),
    dense views share a width. Error bounds stitch like every per-query
    array; a part without one is exact (bound 0)."""
    counts = np.concatenate([p.counts for p in parts])
    ihvp = np.concatenate([p.ihvp for p in parts])
    test_grad = np.concatenate([p.test_grad for p in parts])
    err = None
    if any(p.err_bound is not None for p in parts):
        err = np.concatenate([
            p.err_bound if p.err_bound is not None
            else np.zeros(len(p.counts), np.float32)
            for p in parts
        ])
    approx = any(p.approx for p in parts)
    if parts[0]._packed is not None:
        return InfluenceResult(
            counts=counts, ihvp=ihvp, test_grad=test_grad,
            packed=np.concatenate([p._packed for p in parts]),
            test_points=np.concatenate([p._test_points for p in parts]),
            index=parts[0]._index, pad=max(p._pad for p in parts),
            err_bound=err, approx=approx,
        )
    return InfluenceResult(
        np.concatenate([p.scores for p in parts]),
        np.concatenate([p.related_idx for p in parts]),
        np.concatenate([p.related_mask for p in parts]),
        counts, ihvp, test_grad, err_bound=err, approx=approx,
    )


def _padded_rowsum(x: torch.Tensor) -> torch.Tensor:
    """(T,) row sums of (T, d), each row padded to a multiple of 8
    entries: on the card the row sum's vectorised loads start where a row
    starts, and a row not 32-byte aligned (MF's d = 2k + 2) sums in
    another order, so a query's sum would follow its batch position."""
    return torch.sum(torch.nn.functional.pad(x, (0, -x.shape[1] % 8)), dim=1)


def _bank_solve(F: torch.Tensor, kind: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """(T, d) iHVPs from bank factors ``F`` (T, d, d): the Cholesky solve
    L Lᵀ x = v where ``kind`` is 0 (F = L), the matvec F v where it is 1
    (F = H⁻¹). Triangular solves, not ``cholesky_solve``, whose info
    check waits on the card."""
    y = torch.linalg.solve_triangular(F, v[..., None], upper=False)
    chol = torch.linalg.solve_triangular(F.transpose(-2, -1), y,
                                         upper=True)[..., 0]
    mv = torch.einsum("tij,tj->ti", F, v)
    return torch.where((kind == 1)[:, None], mv, chol)


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


def _to_host(outs) -> list[np.ndarray]:
    """Float32 device tensors as host arrays, in one transfer a device
    (one host wait each, where a fetch each would wait once a tensor)."""
    by_dev: dict = {}
    for j, o in enumerate(outs):
        by_dev.setdefault(o.device, []).append(j)
    parts: list = [None] * len(outs)
    for idx in by_dev.values():
        flat = torch.cat([outs[j].reshape(-1) for j in idx]).cpu().numpy()
        at = 0
        for j in idx:
            n = outs[j].numel()
            parts[j] = flat[at: at + n].reshape(tuple(outs[j].shape))
            at += n
    return parts


def _home_state(j: int, doc: str) -> property:
    """Entry ``j`` of ``(params, train_x, train_y, postings)`` on the
    engine's own device, read from its ``_replicas``. A write replaces
    the engine's own entry in a dict of its own, so the delegates that
    shared the old one keep it."""

    def get(self):
        return self._replicas[self.device][j]

    def put(self, value) -> None:
        state = list(self._replicas[self.device])
        state[j] = value
        self._replicas = {**self._replicas, self.device: tuple(state)}

    return property(get, put, doc=doc)


def _fetch_shards(outs) -> list[list[np.ndarray]]:
    """Each shard's output tensors as host arrays, in shard order, in one
    transfer a device (:func:`_to_host`)."""
    n = len(outs[0])
    host = _to_host([o for shard in outs for o in shard])
    return [host[k * n:(k + 1) * n] for k in range(len(outs))]


def _with_tables(params: dict, names, tables) -> dict:
    """``params`` with its tables ``names`` replaced by ``tables`` (a
    shard's local tables, in ``table_names`` order); ``params`` itself
    when ``names`` is empty."""
    if not names:
        return params
    return {**{k: v for k, v in params.items() if k not in names},
            **dict(zip(names, tables))}


def _on(dev):
    """``dev`` as the current CUDA device (a mesh shard's programs are
    captured and replayed on its own device's current stream); nothing
    on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@contextlib.contextmanager
def capturing(graph, stream=None):
    """``torch.cuda.graph(graph)`` (on ``stream``, where given) with
    Python's cyclic collector paused.
    A collection in the middle of a capture can free a dead graph (one
    of a dropped engine's, held in a reference cycle), and destroying a
    graph while a stream captures invalidates the capture.

    A failure inside the capture (a CUDA out-of-memory error, say) rises
    unchanged once ``torch.cuda.graph``'s exit has ended the capture and
    restored the previous stream; where ending the capture fails itself,
    that error rises instead, chained to the body's, and is unclassified."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with (torch.cuda.graph(graph) if stream is None
              else torch.cuda.graph(graph, stream=stream)):
            yield
    finally:
        if enabled:
            gc.enable()


# The side stream of every capture's warm-up, and the stream it captures
# on, one each a device. cuBLAS keeps a workspace (32 MiB on an H100) for
# each (handle, stream) it has run on, for the life of the process: a
# fresh stream a capture left one workspace behind each graph, alive or
# dead, so device memory grew with every engine a streaming update
# replaced. The capture stream is the device's own: torch.cuda.graph's
# default is one stream of the process, on the device current when it was
# made, which cannot capture a mesh shard's program on another device.
_WARMUP_STREAMS: dict[int, "torch.cuda.Stream"] = {}
_CAPTURE_STREAMS: dict[int, "torch.cuda.Stream"] = {}


def _device_stream(streams: dict, device) -> "torch.cuda.Stream":
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(index)
    return stream


def _warmup_stream(device) -> "torch.cuda.Stream":
    return _device_stream(_WARMUP_STREAMS, device)


class _FlatGraph:
    """One flat program geometry captured as a CUDA graph.

    ``inputs`` gives the shape and dtype of each per-dispatch input the
    program takes after ``args``: the (t_pad, 2) query block (3 wide for
    the bank program), and for the sampled program the (s_pad,) sample
    weights and (t_pad,) sample sizes too. The capture runs the program
    once eagerly on the device's warm-up stream (kernel builds, library
    handles and their workspaces, :func:`_warmup_stream`), on
    zeroed static inputs (the query (0, 0), bank row 0, no row sampled:
    valid everywhere), then records it on the same static inputs. A call
    copies each input in, replays the graph and copies the outputs out,
    all on the current stream, so the host never waits and a later
    replay cannot overwrite outputs still in flight. Each replay adds
    the kernel launches the graph holds to the kernel modules' counts
    (the wrappers count nothing while capturing)."""

    def __init__(self, fn, args, inputs, device):
        self.inputs = tuple(torch.zeros(shape, dtype=dtype, device=device)
                            for shape, dtype in inputs)
        side = _warmup_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                fn(*args, *self.inputs)
        except Exception as e:
            raise RuntimeError(f"warm-up: {e}") from e
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        captured = K.captured_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with capturing(graph, _device_stream(_CAPTURE_STREAMS, device)):
                out = fn(*args, *self.inputs)
        except Exception as e:
            # the partial graph and its private pool go now, not when
            # the traceback that holds this frame is collected
            try:
                graph.reset()
            except Exception:
                pass
            torch.cuda.empty_cache()
            raise RuntimeError(f"capture: {e}") from e
        self.graph, self.out = graph, out
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = tuple(b - a for a, b in zip(captured,
                                                    K.captured_counts()))

    def __call__(self, *inputs):
        for static, x in zip(self.inputs, inputs, strict=True):
            static.copy_(x, non_blocking=True)
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
        conjugate gradients), ``lissa`` (the Neumann-series recursion),
        ``schulz`` (Newton–Schulz inversion of the materialised block),
        ``precomputed`` (the factor bank: banked pairs answer from their
        published factors, every other query through a config-identical
        engine at the next rung) or ``sampled`` (the certified rung: each
        query's Hessian over at most ``sampled_cap`` of its related rows,
        every answer stamped with an error bound, a query over
        ``sampled_tol`` recomputed one rung down).
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
      mesh: a :class:`fia_tpu_torch.parallel.mesh.Mesh` with a ``data``
        axis, or ``None``. Query batches are split into contiguous query
        shards, each run by the single-device program on its slot's
        device (the flat program at one ``(t_loc, s_loc)`` geometry per
        dispatch: the same bits as the single-device engine at every mesh
        size); the state is replicated once per physical device. The
        engine's own device is the mesh's first local slot's. A mesh may
        span processes (``parallel.distributed``): each runs its own
        shards, every process gets the whole result.
      shard_tables: row-shard the embedding tables over the mesh's
        ``model`` axis (which it needs): each ``data`` row of the mesh
        holds one copy, split over its ``model`` slots
        (:func:`~fia_tpu_torch.parallel.sharded.shard_model_params`).
        Every program gathers the rows it reads first and runs on
        shard-local tables: the same bits as replicated tables, the
        score kernel still launched. On a mesh whose ``model`` axis has
        size 1 (after a shrink) the tables are replicated.
      cache_dir: where the factor bank's default path hangs
        (``<cache_dir>/factor/<model_name>-bank.npz``) and where
        :meth:`get_influence_on_test_loss` caches iHVPs as npz files keyed
        like the reference.
      sampled_cap, sampled_tol: the sampled rung's per-query sample cap
        (rows) and error-bound tolerance.
      cpu_fallback: the flat ladder's last rung, off by default (the
        reference's default is on): with it on, after a classified
        device failure the ladder could not absorb on the device (an
        out-of-memory or ambiguous failure, a worker death past its
        halving), the batch is answered on the CPU from the host copies
        (:meth:`_query_on_cpu`), each such batch counted in
        ``engine.cpu_fallback_batches`` and announced on the
        ``reliability`` channel. Off, the failure rises, so no caller's
        batch leaves the card unless it asked for that.
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
        flat_accum: str = "auto",
        row_features: str = "auto",
        cpu_fallback: bool = False,
        query_bucket: int = 64,
        kernel: str = "auto",
        lissa_tune: str = "spectral",
        sampled_cap: int = sampled_mod.DEFAULT_CAP,
        sampled_tol: float = float("inf"),
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
        if row_features == "on":
            raise NotImplementedError(
                "not ported yet — row_features='on': ROADMAP Queue A.6b")
        if mesh is not None and "data" not in mesh.axis_names:
            raise ValueError("a mesh needs a 'data' axis")
        if shard_tables and (mesh is None or "model" not in mesh.axis_names):
            raise ValueError("shard_tables requires a mesh with a 'model' axis")
        self._shard_tables = bool(shard_tables)
        self.mesh = mesh
        self.device = pmesh.mesh_device(mesh, device)
        self.model = model
        # the score kernel keeps running with shard_tables (unlike the
        # reference, whose Pallas kernel reads whole tables): the sharded
        # program scores from shard-local tables (_local_tables)
        self.kernel = kernel
        self._kernel_variant = K.resolve_variant(kernel, model, self.device)
        # Host copies (float32 numpy) survive a device failure: the device
        # state is rebuilt from them (_upload_device_state), the CPU rung
        # and the factor bank's dependency digests read them
        self._params_host = {
            k: (v.detach().to("cpu", torch.float32).numpy()
                if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
            for k, v in params.items()
        }
        self._train_host = (np.asarray(train.x), np.asarray(train.y))
        self.index = InteractionIndex(train.x, model.num_users, model.num_items)
        self._upload_device_state()
        self.cpu_fallback = bool(cpu_fallback)
        self._is_cpu_fallback = False
        self.damping = float(damping)
        self.solver = solver
        self.cg_maxiter = int(cg_maxiter)
        self.cg_tol = float(cg_tol)
        self.lissa_scale = float(lissa_scale)
        self.lissa_depth = int(lissa_depth)
        self.lissa_tune = lissa_tune
        self.cache_dir = cache_dir
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
        # the certified sampled rung: Hessians over <= sampled_cap rows a
        # query, answers stamped with a bound; a query over sampled_tol
        # escalates one rung through a config-identical delegate
        self.sampled_cap = max(1, int(sampled_cap))
        self.sampled_tol = float(sampled_tol)
        self._init_state()

    def _upload_device_state(self) -> None:
        """(Re)build every device-resident tensor from the host copies:
        the params, the train tensors and the CSR postings (related sets
        are gathered on the device, so a dispatch uploads only its query
        block), one replica on each physical device the engine's shards
        run on (slots that share a device share one replica). The engine
        adopts them only once every replica is placed, so a failed upload
        leaves the previous placement whole. Called at construction, and
        again by :meth:`_reset_device_state` after a device failure and
        by :meth:`rebuild_mesh`."""
        inject.fire(sites.ENGINE_UPLOAD)
        postings = self.index.postings()
        placed = None
        if self._sharded_now():
            # the tables row-sharded over 'model' (zero pad rows: real ids
            # never reach them), every other param one copy a device
            placed = SH.shard_model_params(self.mesh, self._params_host,
                                           self.model, pad_rows=True)
        self._adopt_state({
            dev: ({k: torch.as_tensor(v).to(dev)
                   for k, v in self._params_host.items()} if placed is None
                  else {k: p if p.axis is not None else p.on(dev)
                        for k, p in placed.items()},
                  torch.as_tensor(self._train_host[0]).to(dev),
                  torch.as_tensor(self._train_host[1]).to(dev),
                  tuple(torch.as_tensor(a).to(dev) for a in postings))
            for dev in self._devices()})

    def _sharded_now(self) -> bool:
        """The tables are row-sharded on the CURRENT mesh. A
        ``shard_tables`` engine re-homed by :meth:`rebuild_mesh` onto a
        mesh without a non-trivial 'model' axis (``surviving_mesh``
        collapses to trailing size 1 when the survivors cannot fill a
        group; ``None`` is the single-device last rung) places them
        replicated: they must then fit one device, which degraded mode
        accepts over dying."""
        return (self._shard_tables and self.mesh is not None
                and "model" in self.mesh.axis_names
                and int(self.mesh.shape["model"]) > 1)

    def full_params(self) -> dict:
        """The params as whole tensors on the engine's device: ``params``
        itself with replicated tables; with row-sharded ones, the host
        copies placed whole (for callers that retrain from them)."""
        if not self._sharded_now():
            return self.params
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in self._params_host.items()}

    def _adopt_state(self, replicas: dict) -> None:
        """Point the engine at ``replicas``, the device state
        ``(params, train_x, train_y, postings)`` by physical device."""
        self._replicas = replicas

    params = _home_state(0, "The params on the engine's own device.")
    train_x = _home_state(1, "The train pairs on the engine's own device.")
    train_y = _home_state(2, "The train ratings on the engine's own device.")
    _postings = _home_state(3, "The CSR postings on the engine's own device.")

    def _devices(self) -> list:
        """The physical devices the engine's state lives on, its own
        device first: one replica each."""
        if self.mesh is None:
            return [self.device]
        return pmesh.physical_devices(self.mesh)

    def _shard_devices(self) -> list:
        """The device of each query shard, in shard order: the mesh's
        ``data`` slots', or the engine's own (one shard) without a
        mesh; ``None`` for a shard another process runs."""
        if self.mesh is None:
            return [self.device]
        me = pmesh.process_index()
        return [slot.device if int(slot.process_index) == me else None
                for slot in pmesh.data_slots(self.mesh)]

    @property
    def _multihost(self) -> bool:
        """The engine's mesh spans processes: every dispatch exchanges
        its shards' results with the other processes (``fill_shards``),
        so the service keeps such an engine on its sequential guarded
        path and arms nothing ahead of time (the reference's term)."""
        return pdist.spans_processes(self.mesh)

    def _state_on(self, dev=None) -> tuple:
        """``(params, train_x, train_y, postings)`` on ``dev`` (None: the
        engine's own device)."""
        return self._replicas[self.device if dev is None else dev]

    def _bank_on(self, dev=None) -> tuple:
        """The device bank ``(factor, kind)`` on ``dev``."""
        return self._bank_replicas[self.device if dev is None else dev]

    @property
    def _bank_device(self):
        """The device bank ``(factor, kind)`` on the engine's own device,
        or None with no bank loaded."""
        return self._bank_replicas.get(self.device)

    def _reset_device_state(self, max_wait_s: float = 120.0) -> None:
        """Recover the device state after a classified device failure
        (a worker death or a preemption, in the reference's words).

        Every captured CUDA graph (with its private memory pool) and
        every armed geometry is dropped, of this engine and of each
        delegate, and the allocator's cached blocks go back to the card;
        then the params, train tensors and postings are uploaded again
        from the host copies, the factor bank is placed again, and every
        delegate is re-pointed at the new tensors, so no engine holds a
        tensor from before the reset. The next dispatch recaptures.
        Host-side state (the index, the learned memory envelope, the
        counters) survives.

        An upload that fails with the worker-death or preemption
        signature backs off and retries under the reference's policy
        (8 attempts, 2 s base, 30 s cap) within ``max_wait_s``.
        """
        obs.REGISTRY.counter("engine.device_resets").inc()
        obs.event("engine.reset")
        self._rehome(self._delegates_deep(), max_wait_s)

    def _rehome(self, engines: list, max_wait_s: float) -> None:
        """Drop the programs of this engine and of ``engines`` (its
        delegates), upload the device state again under the retry
        policy, place the bank, and re-point every delegate at the new
        tensors."""
        for eng in (self, *engines):
            eng._programs.clear()
            eng._aot.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        pol = policy.RetryPolicy(max_attempts=8, base_delay=2.0,
                                 max_delay=30.0, jitter=0.25)
        pol.run(self._upload_device_state,
                retry_on=(taxonomy.WORKER, taxonomy.PREEMPTION),
                deadline=policy.Deadline(max_wait_s))
        self._place_bank()
        for eng in engines:
            eng._adopt_state(self._replicas)
            eng._place_bank()

    def rebuild_mesh(self, mesh, max_wait_s: float = 120.0) -> None:
        """Re-home the engine on a different (usually shrunken) mesh.

        The ``device_lost`` recovery move: unlike a worker death
        (:meth:`_reset_device_state`, same topology), the dead device is
        not coming back — the service hands over the surviving mesh
        (:func:`fia_tpu_torch.parallel.mesh.surviving_mesh`) and every
        device-resident tensor is placed again on it from the host
        copies, of this engine and of its delegates. Every built program
        is dropped (geometry keys embed the mesh fingerprint,
        :meth:`_aot_key`), so the caller re-arms the planned geometries
        with :meth:`precompile_flat` and steady state stays free of
        captures on the new topology. Results are unchanged by
        construction: ``_mesh_plan`` gives each shard the single-device
        program, so scores are the same bits at every mesh size
        (docs/design.md §15).

        ``mesh=None`` re-homes onto the engine's single device, the last
        rung before giving up."""
        inject.fire(sites.MESH_REBUILD)
        nhosts = 0 if mesh is None else len(pmesh.mesh_hosts(mesh))
        if nhosts > 1:
            inject.fire(sites.MESH_REBUILD_MULTIHOST)
        obs.REGISTRY.counter("engine.mesh_rebuilds").inc()
        obs.event("mesh.rebuild",
                  ndev=1 if mesh is None else int(mesh.devices.size),
                  nhosts=nhosts)
        engines = self._delegates_deep()
        home = self.device if mesh is None else pmesh.mesh_device(mesh)
        before = [(eng, eng.mesh, eng.device, eng._replicas,
                   eng._bank_replicas) for eng in (self, *engines)]
        for eng in (self, *engines):
            eng.mesh, eng.device = mesh, home
        try:
            self._rehome(engines, max_wait_s)
        except BaseException:
            # the previous placement stays whole (its tensors are still
            # held here): a failed re-home costs the dropped programs only
            for eng, old_mesh, old_device, replicas, banks in before:
                eng.mesh, eng.device = old_mesh, old_device
                eng._adopt_state(replicas)
                eng._bank_replicas = banks
            raise

    def _delegates(self) -> list:
        """The engines this one hands queries to (the bank's miss
        delegate, the sampled rung's fallback, the approximate sibling):
        siblings that share its device tensors."""
        return [d for d in (self._bank_delegate, self._sampled_delegate,
                            self._approx_sibling)
                if d is not None and d is not self]

    def _delegates_deep(self) -> list:
        """Every delegate, and theirs, once each."""
        out, stack = [], self._delegates()
        while stack:
            d = stack.pop()
            if all(d is not e for e in out):
                out.append(d)
                stack.extend(d._delegates())
        return out

    def _init_state(self) -> None:
        """The engine's own mutable state: compiled programs, the factor
        bank, delegates, the CPU rung, the padded path's memory envelope
        and counters (a sibling starts with fresh ones)."""
        # flat programs by _flat_key: CUDA graphs on the card, the
        # program closures on the CPU; and the keys precompile_flat armed
        self._programs: dict = {}
        self._aot: set = set()
        # the factor bank (solver='precomputed'): hot (u, i) pairs answer
        # from factorized block inverses published offline
        # (cli/factor.py -> influence/factor.py); a missing entry, a stale
        # one, a damaged artifact or an ineligible config falls through
        # to a config-identical delegate at the next rung
        self._bank = None
        self._bank_lookup: dict | None = None
        # (factor (N, d, d), kind (N,)) by physical device
        self._bank_replicas: dict = {}
        self._bank_load_attempted = False
        self._bank_dropped_stale = 0
        self._bank_hits = 0
        self._bank_misses = 0
        self._bank_delegate: InfluenceEngine | None = None
        self._sampled_delegate: InfluenceEngine | None = None
        self._approx_sibling: InfluenceEngine | None = None
        self._sampled_queries = 0
        self._sampled_escalations: dict[str, int] = {}
        self._params_fp = None
        # the last rung of the flat ladder (built on first need)
        self._cpu_engine: InfluenceEngine | None = None
        # the padded path's memory envelope, in (queries x pad) cells:
        # the largest that dispatched, the smallest that failed with an
        # out-of-memory error, and a success size that refutes a
        # persisted ceiling; seeded lazily from memlimits
        self._cells_ok = 0
        self._cells_bad = memlimits.UNSET_BAD
        self._cleared_bad = 0
        self._memkey = None

    def active_kernel_variant(self) -> str:
        return self._kernel_variant

    def _sibling(self, solver: str) -> "InfluenceEngine":
        """A config-identical engine at another rung, with no disk cache,
        sharing this engine's device params and train tensors, index and
        postings; its programs, bank and counters are its own."""
        sib = copy.copy(self)
        # a method a caller set on this instance (patched, or restored by
        # assignment) is bound to this engine: the sibling answers with
        # its own class's methods, as the reference's fresh engine does
        for name, value in list(vars(sib).items()):
            if getattr(value, "__self__", None) is self:
                del vars(sib)[name]
        sib.solver = solver
        sib.cache_dir = None
        sib.params = dict(self.params)
        sib._init_state()
        return sib

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

    def _flat_fn(self, s_pad: int, stage: str = "scores",
                 mode: str = "direct", sharded: bool = False):
        """All queries' related rows on one flat (S,) axis; per-query
        Hessians accumulated by segment reduction.

        Returns ``fn(params, train_x, train_y, postings, tx, *extra)``.
        ``stage`` truncates the program to a cumulative prefix: "grads"
        returns ``(g, e)``, "hessian" the damped ``H`` (T, d, d), "solve"
        ``(ihvp, v)``, "scores" (the default, the full program)
        ``(scores, ihvp, v)``. "segments" and "operands" return the
        inputs of the Hessian sums ``(g, t, wv, abe, off)`` and of the
        score stage ``(tx, t, rel_x, e, wv, B)``, for holding and timing
        each kernel alone at the path's shapes.

        ``mode``: ``direct``; ``sampled`` (the sampled rung, ``extra`` =
        ``(ws, m)``: the (S,) sample weights and (T,) sample sizes of
        :func:`~fia_tpu_torch.influence.sampled.sample_weights`), the
        same stages with the Hessian sums over ``wv * ws`` and
        ``ab * ws * e`` (so ``ws == 1`` leaves every operand's bits), then
        the certificate; the full program returns ``(scores, ihvp, v,
        err_bound)``, and stage "certificate" returns the certificate
        kernel's operands ``(g, t, ihvp, Cx, wv, ws, abe, e, off, m)``;
        ``bank`` (``extra`` = the device bank ``(factor, kind)``, ``tx``
        (T, 3) with each query's bank row in its third column): no
        Hessian, each iHVP from its factor (:func:`_bank_solve`), then
        the same score stage.

        ``sharded``: ``params`` holds shard-local tables and ``extra``
        starts with their sorted keys ``(su, si)``
        (:meth:`_local_tables`); after the prelude, which reads the
        postings by the real ids, every user and item id is remapped into
        the local tables (:func:`~fia_tpu_torch.parallel.sharded.remap`),
        so every later op reads the same values in the same arithmetic.
        """
        if stage not in STAGES + ("segments", "operands", "certificate"):
            raise ValueError(f"unknown stage {stage!r}")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if (stage == "certificate" and mode != "sampled"
                or mode == "bank" and stage in ("grads", "hessian",
                                                "segments")):
            raise ValueError(f"mode {mode!r} has no stage {stage!r}")
        model = self.model
        variant = self._kernel_variant
        damping = self.damping
        prelude = self._flat_prelude(s_pad)
        chunk = math.gcd(s_pad, self.flat_chunk)
        accum = self.flat_accum

        def fn(params, train_x, train_y, postings, tx, *extra):
            T = tx.shape[0]
            u, i, counts, t, row, wv, ut, it = prelude(tx, postings)
            qx = tx if tx.shape[1] == 2 else tx[:, :2].contiguous()
            rel_x = train_x[row]
            rel_y = train_y[row]
            if sharded:
                su, si, *extra = extra
                u, ut = SH.remap(su, u), SH.remap(su, ut)
                i, it = SH.remap(si, i), SH.remap(si, it)
                qx = torch.stack([u, i], dim=1)
                rel_x = torch.stack([SH.remap(su, rel_x[:, 0]),
                                     SH.remap(si, rel_x[:, 1])], dim=1)
            e = model.row_predict(params, rel_x) - rel_y
            n_t = torch.clamp(counts.to(torch.float32), min=1.0)
            rdiag = model.block_reg_diag(params)

            def test_vector():
                return _in_pieces(torch.func.vmap(
                    lambda uu, ii, xj: G.block_prediction_grad(
                        model, params, uu, ii, xj[None, :]
                    )
                ), u, i, qx)

            if mode == "bank":
                bfac, bknd = extra
                brow = tx[:, 2].long()
                v = test_vector()
                ihvp = _in_pieces(_bank_solve, bfac[brow], bknd[brow], v)
            else:
                g = K.row_grads(model, params, ut, it, rel_x)
                ab = wv * (rel_x[:, 0] == ut) * (rel_x[:, 1] == it)
                if stage == "grads":
                    return g, e

                # H_t = (2/n_t)(Σ_{s∈t} w g gᵀ + (Σ a b e) C) + diag(reg + λ)
                off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
                off.clamp_(max=s_pad)
                abe = ab * e
                if mode == "sampled":
                    # the rung's one difference from the direct program:
                    # sample weights on both Hessian terms (off-sample rows
                    # carry 0), so E[H_m] = H and ws == 1 is bitwise direct
                    ws, msz = extra
                    hw, habe = wv * ws, ab * ws * e
                else:
                    hw, habe = wv, abe
                if stage == "segments":
                    return g, t, hw, habe, off
                if accum == "auto":
                    HH, sum_abe = Kseg.segment_sums(g, t, hw, habe, off, chunk)
                else:
                    HH, sum_abe = Kseg.segment_sums_reference(
                        g, t, hw, habe, T, chunk, onehot=accum == "onehot")
                C = model.block_cross_const(params)
                H = (2.0 / n_t)[:, None, None] * (
                    HH + sum_abe[:, None, None] * C[None]
                ) + torch.diag(rdiag + damping)[None]
                if stage == "hessian":
                    return H

                v = test_vector()
                ihvp = _in_pieces(solvers.solve_direct, H, v)
            if stage == "solve":
                return ihvp, v
            if mode == "sampled":
                # C x of every query, in pieces of 64: a (T, d)(d, d)
                # product's cuBLAS kernel is chosen by T
                Cx = _in_pieces(lambda x: x @ C.T, ihvp)
                if stage == "certificate":
                    return g, t, ihvp, Cx, wv, ws, abe, e, off, msz

            # score_s = ∇_block L(z_s) · ihvp_t / n_t, with the per-example
            # loss gradient 2 e g + wd·θ̃ (θ̃ = decayed block dims)
            theta = torch.func.vmap(
                lambda uu, ii: model.flatten_block(
                    model.extract_block(params, uu, ii)
                )
            )(u, i)
            reg_dot = _padded_rowsum(theta * rdiag[None] * ihvp)
            B = Kc.query_matrix(ihvp, reg_dot, n_t)
            if stage == "operands":
                return qx, t, rel_x, e, wv, B
            scores = K.fused_scores(model, variant, params, qx, t, rel_x,
                                    e, wv, B)
            if mode != "sampled":
                return scores, ihvp, v

            # the certificate: the sample deviation of the per-row Hessian
            # action on the solved vector, pushed through the inverse by
            # λ_min(H) and through the score form (influence/sampled.py);
            # λ_min by the block_eigmin kernel (Householder, then Sturm
            # multisection), a block alone, from H's lower triangle as
            # eigvalsh reads it: split invariant, no host wait
            sigma, gmax, wmax = Kcert.segment_certificate(
                g, t, ihvp, Cx, wv, ws, abe, e, off, msz)
            lam = torch.clamp(Keig.block_eigmin(H), min=damping)
            err_ihvp = sampled_mod.ihvp_error_bound(sigma, msz, counts, lam)
            regnorm = torch.sqrt(_padded_rowsum(
                torch.square(theta * rdiag[None])))
            err = sampled_mod.score_error_bound(gmax, wmax, regnorm,
                                                err_ihvp, n_t)
            return scores, ihvp, v, err

        return fn

    def _query_pad(self, T: int) -> int:
        """Query-axis pad of a flat dispatch (see ``query_bucket``).
        Under a mesh this is the PER-SHARD pad: ``_mesh_plan`` calls it
        on the shard's query count."""
        if self.query_bucket <= 0:
            return T
        return bucketed_pad(T, self.query_bucket)

    def _s_pad_for(self, total: int) -> int:
        """Flat-axis pad for ``total`` related rows: geometric bucketing
        (~12.5% granule) above a 2048 floor, so S stays a multiple of
        every power-of-two chunk up to 2048. Under a mesh this buckets
        each shard's own row total (``_mesh_plan`` takes the max)."""
        return bucketed_pad(total, 2048)

    def _mesh_plan(self, counts: np.ndarray, T: int):
        """Query-axis shard plan of one flat dispatch.

        The batch splits into ``ndev`` contiguous shards of ``q`` real
        queries (the last possibly ragged or empty; one shard of the
        whole batch without a mesh); every shard pads its query axis to a
        common ``t_loc`` and its flat row axis to a common ``s_loc`` —
        the max over shards of the single-device bucketing — so each
        shard runs exactly the single-device program at one geometry.
        Returns ``(ndev, q, t_loc, s_loc)``."""
        ndev = len(self._shard_devices())
        q = -(-max(int(T), 1) // ndev)
        t_loc = self._query_pad(q)
        counts = np.asarray(counts, np.int64)
        s_loc = 1
        for k in range(ndev):
            tot = int(counts[k * q: (k + 1) * q].sum())
            s_loc = max(s_loc, self._s_pad_for(max(tot, 1)))
        return ndev, q, t_loc, s_loc

    @staticmethod
    def _shard_blocks(tx_np: np.ndarray, ndev: int, q: int,
                      rows: int) -> list[np.ndarray]:
        """Each shard's int32 query block: shard k takes rows
        ``[k q, (k+1) q)`` of ``tx_np`` (the (T, 2) pairs, or (T, 3) with
        the bank rows), a short or empty shard duplicating its trailing
        row (the batch's last when the shard lies past the ragged end) up
        to ``rows``: the single-device query padding, so pad rows' flat
        positions land past each shard's real total."""
        blocks = []
        for k in range(ndev):
            block = tx_np[k * q: (k + 1) * q]
            if block.shape[0] == 0:
                block = tx_np[-1:]
            if block.shape[0] < rows:
                block = np.concatenate(
                    [block, np.repeat(block[-1:], rows - block.shape[0],
                                      axis=0)])
            blocks.append(np.ascontiguousarray(block, np.int32))
        return blocks

    def _mesh_blocks(self, tx_np: np.ndarray, counts):
        """``(plan, blocks)``: :meth:`_mesh_plan` and each shard's query
        block (:meth:`_shard_blocks`), padded to ``t_loc`` rows."""
        plan = self._mesh_plan(counts, tx_np.shape[0])
        ndev, q, t_loc, _ = plan
        return plan, self._shard_blocks(tx_np, ndev, q, t_loc)

    def _upload_blocks(self, blocks) -> list:
        """Each shard's query block on its device (``None`` for a shard
        another process runs)."""
        out = []
        for dev, block in zip(self._shard_devices(), blocks):
            if dev is None:
                out.append(None)
                continue
            with _on(dev):
                out.append(self._upload(block, dev))
        return out

    def _local_tables(self, txs: list, related) -> list:
        """The shard-local tables of a sharded dispatch: for each shard's
        uploaded query block (``None``: another process's), the (n,)
        sorted user and item ids of its related rows and queries
        (:func:`~fia_tpu_torch.parallel.sharded.sorted_keys`; ``related``
        maps ``(dev, tx)`` to the (·, 2) related rows' ids, the same rows
        the program reads), then each table's rows at those ids, gathered
        from the row shards (:func:`~fia_tpu_torch.parallel.sharded.
        gather_table_rows`). Returns per shard ``(su, si, *tables)`` in
        ``table_names`` order, the inputs a sharded program takes after
        its query block; eager, outside any captured graph (the gather
        may cross devices), with no host wait."""
        keys = []
        for dev, tx in zip(self._shard_devices(), txs):
            if tx is None:
                keys.append(None)
                continue
            with _on(dev):
                rel = related(dev, tx)
                keys.append(SH.sorted_keys(
                    torch.cat([rel[:, 0], tx[:, 0].to(rel.dtype)]),
                    torch.cat([rel[:, 1], tx[:, 1].to(rel.dtype)])))
        rows = SH.gather_table_rows(
            self.mesh, self.model, self.params,
            [k and k[0] for k in keys], [k and k[1] for k in keys])
        names = SH.table_names(self.model)
        return [None if k is None else (*k, *(r[n] for n in names))
                for k, r in zip(keys, rows)]

    def _local_shards(self, blocks, related):
        """Each query shard of a dispatch, in shard order: ``None`` for a
        shard another process runs, else ``(dev, tx, params, state,
        keys)``: its query block uploaded to its slot's device, that
        device's params and ``(train_x, train_y, postings)``; on a
        sharded engine the params' tables are the shard's local tables
        and ``keys`` their sorted ids ``(su, si)`` (:meth:`_local_tables`,
        over the rows ``related`` names), else ``keys`` is ``()``. Every
        shard's tables are gathered before the first is yielded."""
        txs = self._upload_blocks(blocks)
        sharded = self._sharded_now()
        local = (self._local_tables(txs, related) if sharded
                 else [()] * len(txs))
        names = SH.table_names(self.model) if sharded else ()
        for dev, tx, loc in zip(self._shard_devices(), txs, local):
            if dev is None:
                yield None
                continue
            params, *state = self._state_on(dev)
            yield (dev, tx, _with_tables(params, names, loc[2:]), state,
                   tuple(loc[:2]))

    def _flat_related(self, s_pad: int):
        """``related(dev, tx)`` of the flat program at ``s_pad``: the
        (s_pad, 2) ids of the train rows on its flat axis (the prelude's,
        the pad positions' included)."""
        prelude = self._flat_prelude(s_pad)

        def related(dev, tx):
            _, train_x, _, postings = self._state_on(dev)
            return train_x[prelude(tx, postings)[4]]

        return related

    def _run_shards(self, blocks, t_loc: int, s_loc: int,
                    mode: str = "direct") -> list:
        """Enqueue every shard's program on its slot's device, each at
        ``(t_loc, s_loc)``; returns each shard's outputs in shard order
        (``None`` for another process's shard). No host wait: every
        shard is queued before any result is fetched, so shards on real
        devices overlap. A sharded engine first gathers each shard's
        local tables (:meth:`_local_tables`). A direct dispatch counts
        one AOT hit or miss, whatever its shard count."""
        if mode == "direct":
            obs.REGISTRY.counter(
                "engine.aot_hits" if self._aot_key(t_loc, s_loc) in self._aot
                else "engine.aot_misses").inc()
        names = SH.table_names(self.model) if self._sharded_now() else ()
        outs = []
        for sh in self._local_shards(blocks, self._flat_related(s_loc)):
            if sh is None:
                outs.append(None)
                continue
            dev, tx, params, _, keys = sh
            with _on(dev):
                outs.append(self._flat_exec(t_loc, s_loc, mode, dev)(
                    tx, *keys, *(params[n] for n in names)))
        return outs

    def _collect(self, outs) -> list[list[np.ndarray]]:
        """Each shard's outputs as host arrays in shard order: this
        process's fetched in one transfer a device
        (:func:`_fetch_shards`), and, over a mesh spanning processes, the
        others' all-gathered in global shard order."""
        mine = [k for k, o in enumerate(outs) if o is not None]
        parts = [None] * len(outs)
        if mine:
            for k, h in zip(mine, _fetch_shards([outs[k] for k in mine])):
                parts[k] = h
        return pdist.fill_shards(parts)

    @staticmethod
    def _stitch(shards: list, counts, q: int, flat: int) -> list:
        """The host-side inverse of :meth:`_shard_blocks`: ``shards``
        holds each shard's fetched outputs (:func:`_fetch_shards`), the
        first ``flat`` of them over the flat row axis and the rest over
        the query axis. Each shard's real prefix (its own row total, its
        own query count) is cut out and concatenated back into query
        order; an empty trailing shard (duplicate work) is skipped."""
        counts = np.asarray(counts, np.int64)
        T = counts.shape[0]
        cum = np.concatenate([[0], np.cumsum(counts)])
        parts: list = [[] for _ in shards[0]]
        for k, got in enumerate(shards):
            lo, hi = min(k * q, T), min((k + 1) * q, T)
            if k and hi == lo:
                continue
            for j, a in enumerate(got):
                parts[j].append(a[: int(cum[hi] - cum[lo]) if j < flat
                                  else hi - lo])
        return [p[0] if len(p) == 1 else np.concatenate(p) for p in parts]

    def flat_geometry(self, test_points: np.ndarray) -> tuple[int, int]:
        """``(t_pad, s_pad)`` of the flat dispatch these points would
        issue: what :meth:`precompile_flat` must arm so that the dispatch
        itself captures nothing. Under a mesh both are per shard."""
        test_points = np.asarray(test_points)
        if test_points.ndim == 1:
            test_points = test_points[None, :]
        counts = self.index.counts_batch(test_points)
        _, _, t_loc, s_loc = self._mesh_plan(counts, int(test_points.shape[0]))
        return (t_loc, s_loc)

    def _mesh_fp(self):
        return pmesh.mesh_fingerprint(self.mesh)

    def _aot_key(self, t_pad: int, s_pad: int):
        """The identity of an armed geometry: the geometry, the
        score-kernel variant, the Hessian form, the table placement
        (``rebuild_mesh`` can flip a ``shard_tables`` engine between
        sharded and replicated programs), and the mesh fingerprint LAST
        (``compiled_geometries`` reads the geometry as ``(k[1],
        k[2])``)."""
        return ("flat", t_pad, s_pad, self._kernel_variant, self.flat_accum,
                self._sharded_now(), self._mesh_fp())

    def _flat_key(self, t_pad: int, s_pad: int, mode: str = "direct",
                  dev=None):
        """A flat program's cache key: its mode and geometry, the
        score-kernel variant, the Hessian form, the addresses of the
        tensors it reads on ``dev`` (a captured graph reads them by
        address; a bank program its factors too), and the mesh
        fingerprint. Slots that share a device share its programs. A
        sharded program takes its tables as inputs: the row shards are
        not among the tensors it reads."""
        params, train_x, train_y, postings = self._state_on(dev)
        tensors = (*params.values(), train_x, train_y, *postings)
        if mode == "bank":
            tensors += self._bank_on(dev)
        return ("flat" if mode == "direct" else mode, t_pad, s_pad,
                self._kernel_variant, self.flat_accum, self._sharded_now(),
                tuple(x.data_ptr() for x in tensors
                      if isinstance(x, torch.Tensor)), self._mesh_fp())

    def precompile_flat(self, geometries) -> dict:
        """Build the flat programs of ``(t_pad, s_pad)`` geometries ahead
        of any dispatch (on the card, capture each as a CUDA graph; under
        a mesh, once on each physical device), so a warmed engine never
        builds on the hot path. Geometries come from
        :meth:`flat_geometry` over the planned batches or an explicit
        list. No-op when the flat path is ineligible. Returns
        ``{"compiled": [[t, s], ...], "cached": [...], "seconds": float}``.
        """
        if not (self.impl in ("auto", "flat") and self._flat_eligible()):
            return {"compiled": [], "cached": [], "seconds": 0.0}
        t0 = time.perf_counter()
        compiled, cached = [], []
        # each capture's compile.backend event (compilemon) attaches to
        # this span: the geometry's attribution
        with obs.span("engine.precompile") as sp:
            for t_pad, s_pad in geometries:
                t_pad, s_pad = int(t_pad), int(s_pad)
                built = False
                for dev in self._devices():
                    key = self._flat_key(t_pad, s_pad, dev=dev)
                    if key not in self._programs:
                        with _on(dev):
                            self._programs[key] = self._build_flat(
                                t_pad, s_pad, dev=dev)
                        built = True
                (compiled if built else cached).append([t_pad, s_pad])
                self._aot.add(self._aot_key(t_pad, s_pad))
            sp.set(compiled=len(compiled), cached=len(cached))
        return {"compiled": compiled, "cached": cached,
                "seconds": time.perf_counter() - t0}

    def compiled_geometries(self) -> dict:
        """The built flat programs: ``"aot"``, the ``[t_pad, s_pad]``
        pairs :meth:`precompile_flat` armed, and ``"jit"``, the keys of
        those built on their first dispatch."""
        armed = {(k[1], k[2]) for k in self._aot}
        return {
            "aot": sorted([k[1], k[2]] for k in self._aot),
            "jit": sorted(str(k) for k in self._programs
                          if k[0] != "flat" or (k[1], k[2]) not in armed),
        }

    def _build_flat(self, t_pad: int, s_pad: int, mode: str = "direct",
                    dev=None):
        """One geometry's program on ``dev`` (None: the engine's device):
        ``run(tx) -> (scores, ihvp, v)`` (``mode`` "direct" or "bank"),
        ``run(tx, ws, m) -> (scores, ihvp, v, err_bound)`` ("sampled");
        with row-sharded tables, ``run(tx, su, si, *tables)``, the
        shard-local tables of :meth:`_local_tables` (``s_pad + t_pad``
        rows each). On the card a captured CUDA graph (raising with the
        cause if the program cannot be captured), on the CPU the program
        closure. Each build is counted by
        :mod:`fia_tpu_torch.utils.compilemon`, with its capture time."""
        dev = self.device if dev is None else dev
        sharded = self._sharded_now()
        fn = self._flat_fn(s_pad, mode=mode, sharded=sharded)
        params, *state = self._state_on(dev)
        bank = self._bank_on(dev) if mode == "bank" else ()
        inputs = [((t_pad, 3 if mode == "bank" else 2), torch.int32)]
        names = SH.table_names(self.model) if sharded else ()
        if sharded:
            n = s_pad + t_pad
            inputs += [((n,), torch.int32)] * 2 + [
                ((n, *params[k].shape[1:]), torch.float32) for k in names]
        elif mode == "sampled":
            inputs += [((s_pad,), torch.float32), ((t_pad,), torch.int32)]

        # the program holds no reference to the engine: a dropped engine's
        # graphs go with it, not at the next collection
        def run(tx, *xs):
            if not sharded:
                return fn(params, *state, tx, *bank, *xs)
            return fn(_with_tables(params, names, xs[2:]), *state, tx,
                      *xs[:2], *bank)

        if dev.type != "cuda":
            compilemon.record()
            return run
        try:
            prog = _FlatGraph(run, (), inputs, dev)
        except Exception as e:
            raise RuntimeError(
                f"the {mode} flat program at (t_pad, s_pad) = ({t_pad}, "
                f"{s_pad}) could not be captured as a CUDA graph: {e}") from e
        compilemon.record(prog.capture_s)
        return prog

    def _flat_exec(self, t_pad: int, s_pad: int, mode: str = "direct",
                   dev=None):
        """The program for one dispatch geometry on ``dev``: the one
        :meth:`precompile_flat` or an earlier dispatch built, else built
        now (captured on its first dispatch, as ``jit`` compiles on its
        first call)."""
        key = self._flat_key(t_pad, s_pad, mode, dev)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build_flat(t_pad, s_pad, mode,
                                                          dev)
        return prog

    def _pad_queries(self, tx_np: np.ndarray) -> np.ndarray:
        """The (T, w) query block padded to ``_query_pad(T)`` rows by
        duplicating the trailing row. Pad rows take flat positions AFTER
        the real total (their segment offsets start at off[T]), so real
        scores are untouched and ``_assemble_packed`` slices them away."""
        T = tx_np.shape[0]
        t_pad = self._query_pad(T)
        if t_pad > T:
            tx_np = np.concatenate(
                [tx_np, np.repeat(tx_np[-1:], t_pad - T, axis=0)])
        return tx_np

    def _upload(self, a: np.ndarray, dev=None) -> torch.Tensor:
        """A host array on ``dev`` (None: the engine's device). On the
        card a pageable upload would wait for the card to drain its
        queue, and with it for every batch query_many keeps in flight; a
        pinned one is queued like a kernel."""
        dev = self.device if dev is None else dev
        x = torch.as_tensor(a)
        if dev.type == "cuda":
            return x.pin_memory().to(dev, non_blocking=True)
        return x

    def _query_block(self, test_points: np.ndarray, bank_rows=None):
        """``(counts, tx_np)``: host-side related counts and the (T, 2)
        int64 query block ((T, 3) with each query's bank row for the
        bank program)."""
        test_points = np.asarray(test_points)
        counts = self.index.counts_batch(test_points)
        tx_np = np.ascontiguousarray(np.asarray(test_points, np.int64))
        if bank_rows is not None:
            tx_np = np.concatenate(
                [tx_np, np.asarray(bank_rows, np.int64)[:, None]], axis=1)
        return counts, tx_np

    def _flat_inputs(self, test_points: np.ndarray, bank_rows=None):
        """``(counts, tx, s_pad)``: the operands of the flat program over
        the whole batch on the engine's device, as one shard would take
        them: host-side related counts, the query block
        (:meth:`_query_block`) padded by duplicating the trailing pair to
        ``t_pad`` rows as int32 on the device, and the flat pad (pad rows
        past s_pad are truncated)."""
        counts, tx_np = self._query_block(test_points, bank_rows)
        tx = self._upload(self._pad_queries(tx_np).astype(np.int32))
        return counts, tx, self._s_pad_for(int(counts.sum()))

    def _enqueue_flat(self, test_points, mode: str = "direct",
                      bank_rows=None):
        """Enqueue one flat dispatch in ``mode`` ("direct" or "bank"):
        ``(counts, outputs, plan)``. The batch is packed into query
        shards (:meth:`_mesh_blocks`; one without a mesh), each run by the
        single-device program on its slot's device; ``outputs`` holds
        each shard's, ``plan`` is :meth:`_mesh_plan`'s."""
        counts, tx_np = self._query_block(test_points, bank_rows)
        plan, blocks = self._mesh_blocks(tx_np, counts)
        return counts, self._run_shards(blocks, *plan[2:], mode), plan

    def _dispatch_flat(self, test_points: np.ndarray, pad_to: int | None):
        """Enqueue one flat query program; returns a handle for
        :meth:`_finalize_flat`. Work is queued on the current stream of
        each shard's device and the host moves on (the
        ``engine.dispatch_flat`` span times the enqueue)."""
        with obs.span("engine.dispatch_flat", n=int(len(test_points))) as sp:
            inject.fire(sites.ENGINE_DISPATCH_FLAT)
            counts, out, plan = self._enqueue_flat(test_points)
            pad = bucketed_pad(
                counts.max() if counts.size else 1, self.pad_bucket, pad_to
            )
            if self.mesh is not None:
                sp.set(ndev=plan[0], t_loc=plan[2])
            return (test_points, counts, out, pad, plan[1])

    def _finalize_flat(self, handle) -> InfluenceResult:
        test_points, counts, out, pad, q = handle
        return self._assemble_packed(test_points, counts, out, pad, q=q)

    def _assemble_packed(self, test_points, counts, outs, pad: int,
                         iterations: int | None = None,
                         q: int | None = None) -> InfluenceResult:
        """Fetch a dispatch's outputs ``(packed, ihvp, v)`` of each query
        shard, and the sampled program's ``err_bound`` after them, to
        the host in one transfer a device (:func:`_fetch_shards`: the
        dispatch's one read), stitch the shards back into query order
        (:meth:`_stitch`, ``q`` real queries a shard; None: one shard),
        and wrap them as a packed result. Query-axis pad rows slice away
        here; their flat rows already sit past each shard's real total in
        its packed scores."""
        T = int(np.asarray(counts).shape[0])
        total = int(counts.sum())
        packed, ihvp, v, *err = self._stitch(
            self._collect(outs), counts, max(T, 1) if q is None else q, 1)
        # the payload seam every rung shares (the fetched iHVP host buffer)
        ihvp = inject.corrupt(sites.ENGINE_SOLVE, ihvp)
        return InfluenceResult(
            counts=counts,
            ihvp=ihvp,
            test_grad=v,
            packed=packed[:total],
            test_points=np.asarray(test_points),
            index=self.index,
            pad=pad,
            iterations=iterations,
            err_bound=err[0] if err else None,
            approx=bool(err),
        )

    def _query_flat(self, test_points: np.ndarray,
                    pad_to: int | None = None,
                    _depth: int = 0) -> InfluenceResult:
        """One flat dispatch, with the reference's device ladder
        (``engine.py:1400-1438``): after a preemption, rebuild the device
        state and retry at the same size; after a worker death, rebuild
        and retry in halves (⌈T/2⌉ then ⌊T/2⌋); both to depth 3. An
        out-of-memory or ambiguous failure, or a worker death past the
        ladder, ends at the CPU rung (:meth:`_query_on_cpu`) where it is
        enabled; anything else rises. The program is split invariant, so
        a result recovered in halves has the bits of one dispatch."""
        try:
            return self._finalize_flat(
                self._dispatch_flat(test_points, pad_to))
        except Exception as e:
            T = len(test_points)
            cls = taxonomy.classify(e)
            if cls == taxonomy.PREEMPTION and _depth < 3:
                # no size evidence: rebuild (the reset's own backoff
                # waits out the reclaim) and retry at the same size
                self._reset_device_state()
                return self._query_flat(test_points, pad_to, _depth + 1)
            if cls != taxonomy.WORKER or _depth >= 3 or T <= 1:
                if cls in _ADAPTIVE_KINDS:
                    cpu = self._query_on_cpu(test_points, pad_to)
                    if cpu is not None:
                        return cpu
                raise
            # a worker death took every device buffer: rebuild, then
            # retry at half the size
            self._reset_device_state()
            h = (T + 1) // 2
            return _concat_results([
                self._query_flat(test_points[:h], pad_to, _depth + 1),
                self._query_flat(test_points[h:], pad_to, _depth + 1),
            ])

    def _query_on_cpu(self, test_points: np.ndarray, pad_to: int | None
                      ) -> InfluenceResult | None:
        """The last rung: answer the batch on the CPU, from one engine
        (built on first need, ``device="cpu"``) over the host copies,
        which survive any device failure; a forced CUDA score kernel
        becomes ``auto`` there (the plain versions). Every batch it
        answers is counted (``engine.cpu_fallback_batches``) and
        announced. ``None`` where the rung does not apply
        (``cpu_fallback=False``, or this engine is itself the CPU rung),
        so the caller surfaces the failure."""
        if not self.cpu_fallback or self._is_cpu_fallback:
            return None
        if self.mesh is not None:
            return None  # as the reference: a mesh engine has no CPU rung
        obs.REGISTRY.counter("engine.cpu_fallback_batches").inc()
        obs.diag("reliability", "device-side recovery exhausted; "
                 "degrading to the CPU backend for this query")
        if self._cpu_engine is None:
            eng = InfluenceEngine(
                self.model, self._params_host,
                RatingDataset(*self._train_host),
                damping=self.damping, solver=self.solver,
                cg_maxiter=self.cg_maxiter, cg_tol=self.cg_tol,
                lissa_scale=self.lissa_scale, lissa_depth=self.lissa_depth,
                model_name=self.model_name + "-cpufb",
                pad_bucket=self.pad_bucket, hessian_mode="auto",
                impl="auto",
                kernel="auto" if self.kernel == "cuda" else self.kernel,
                lissa_tune=self.lissa_tune, sampled_cap=self.sampled_cap,
                sampled_tol=self.sampled_tol, device="cpu",
            )
            eng._is_cpu_fallback = True
            self._cpu_engine = eng
        return self._cpu_engine.query_batch(test_points, pad_to=pad_to)

    def _flat_eligible(self) -> bool:
        return self.solver == "direct" and self._gn_hooks()

    def _gn_hooks(self) -> bool:
        """The flat program's conditions other than the solver: the flat
        path, the bank's hit program and the sampled program all build
        on them."""
        return (
            not self.group_queries
            # the flat program builds the Hessian from the Gauss-Newton
            # hooks: an explicit 'autodiff' request is honoured
            and self.hessian_mode != "autodiff"
            # 'dataset' promises one geometry and a uniform output pad
            # across batches: a padded-path contract
            and self.pad_policy == "batch"
            and self.model.block_cross_const is not None
            and self.model.block_reg_diag is not None
        )

    # -- precomputed factor-bank rung ----------------------------------------
    def block_hessians(self, pairs: np.ndarray,
                       batch_queries: int = 512) -> np.ndarray:
        """Damped block Hessians for explicit (u, i) pairs, (N, d, d) host
        numpy: the factor bank's input. The flat program's ``hessian``
        stage, one dispatch a ``batch_queries`` chunk, where the model's
        Gauss-Newton hooks allow (its bits are the flat path's Hessian's);
        else a vmapped materialisation over the padded related sets."""
        pairs = np.asarray(pairs, np.int64)
        if pairs.ndim == 1:
            pairs = pairs[None, :]
        gn_ok = (self.model.block_cross_const is not None
                 and self.model.block_reg_diag is not None
                 and self.hessian_mode != "autodiff")
        step = max(int(batch_queries), 1)
        out = [
            self._block_hessians_flat(pairs[s0:s0 + step]) if gn_ok
            else self._block_hessians_padded(pairs[s0:s0 + step])
            for s0 in range(0, len(pairs), step)
        ]
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _block_hessians_flat(self, chunk: np.ndarray) -> np.ndarray:
        """The flat program's Hessian stage over the dispatch's query
        shards (one without a mesh): every shard queued on its slot's
        device, then fetched and stitched."""
        counts, tx_np = self._query_block(chunk)
        (_, q, _, s_loc), blocks = self._mesh_blocks(tx_np, counts)
        fn = self._flat_fn(s_loc, "hessian", sharded=self._sharded_now())
        hs = []
        for sh in self._local_shards(blocks, self._flat_related(s_loc)):
            if sh is None:
                hs.append(None)
                continue
            dev, tx, params, state, keys = sh
            with _on(dev):
                hs.append((fn(params, *state, tx, *keys),))
        return self._stitch(self._collect(hs), counts, q, 0)[0]

    def _block_hessians_padded(self, chunk: np.ndarray) -> np.ndarray:
        """The vmapped materialisation over the chunk's padded related
        sets, whole, on this process's first query shard's device (the
        engine's own without a mesh). A sharded engine reads its tables
        through that shard's local tables, the ids remapped into them as
        the flat program remaps them."""
        idx, mask, _ = self.index.related_padded(chunk,
                                                 bucket=self.pad_bucket)
        model, damping = self.model, self.damping
        d = int(model.block_size)
        devs = self._shard_devices()
        k = next(k for k, dv in enumerate(devs) if dv is not None)
        dev = devs[k]
        params, train_x, train_y, _ = self._state_on(dev)
        with _on(dev):
            u = torch.as_tensor(chunk[:, 0]).to(dev)
            i = torch.as_tensor(chunk[:, 1]).to(dev)
            ridx = torch.as_tensor(idx, dtype=torch.int64).to(dev)
            rel_x, rel_y = train_x[ridx], train_y[ridx]
            w = torch.as_tensor(mask).to(dev).to(torch.float32)
            if self._sharded_now():
                txs = [None] * len(devs)
                txs[k] = torch.stack([u, i], dim=1)
                su, si, *tables = self._local_tables(
                    txs, lambda _dev, _tx: rel_x.reshape(-1, 2))[k]
                params = _with_tables(params, SH.table_names(model), tables)
                u, i = SH.remap(su, u), SH.remap(si, i)
                rel_x = torch.stack([SH.remap(su, rel_x[..., 0]),
                                     SH.remap(si, rel_x[..., 1])], dim=-1)
            if self._analytic_hessian:
                H = torch.func.vmap(
                    lambda uu, ii, xx, yy, ww: model.block_hessian(
                        params, uu, ii, xx, yy, ww)
                )(u, i, rel_x, rel_y, w)
                H = H + damping * torch.eye(d, dtype=torch.float32,
                                            device=dev)
            else:
                H = torch.func.vmap(
                    lambda uu, ii, xx, yy, ww: HV.materialize_block_hessian(
                        model, params, uu, ii, xx, yy, ww, damping)
                )(u, i, rel_x, rel_y, w)
        return H.cpu().numpy()

    def factor_bank_path(self) -> str | None:
        """Default on-disk bank location (None without a cache_dir)."""
        if self.cache_dir is None:
            return None
        from fia_tpu_torch.influence import factor as fbank

        return fbank.default_bank_path(self.cache_dir, self.model_name)

    def load_factor_bank(self, path: str | None = None) -> int:
        """Load (or reload) the factor bank onto the device.

        A verified load: artifact checksum and config/train fingerprint
        first (a corrupt bank is quarantined as ``*.corrupt``), then each
        entry's ``dep_crc`` against the live params; stale entries are
        dropped before the bank ever serves. An integrity failure or a
        classified fault degrades to "no bank" (every query falls through
        the ladder); unclassified errors surface. Returns the number of
        servable entries."""
        from fia_tpu_torch.influence import factor as fbank
        from fia_tpu_torch.reliability import artifacts

        self._bank_load_attempted = True
        self._bank = None
        self._bank_lookup = None
        self._bank_replicas = {}
        if path is None:
            path = self.factor_bank_path()
        if path is None or not os.path.exists(path):
            return 0
        try:
            inject.fire(sites.ENGINE_FACTOR_LOAD)
            bank, dropped = fbank.load_bank(path, self)
        except artifacts.ArtifactIntegrityError as e:
            obs.diag("reliability", f"factor bank rejected ({e.reason}); "
                     "queries fall through the solver ladder")
            return 0
        except Exception as e:
            if taxonomy.classify(e) is None:
                raise
            obs.diag("reliability", "factor bank load failed transiently; "
                     "serving without the bank")
            return 0
        self._bank_dropped_stale = int(dropped)
        if len(bank) == 0:
            return 0
        self._bank = bank
        self._bank_lookup = bank.lookup()
        self._place_bank()
        return len(bank)

    def _place_bank(self) -> None:
        """The loaded bank's factors and kinds on every physical device
        the engine's shards run on, so a bank hit on any query shard
        reads its factors where it runs."""
        if self._bank is None:
            self._bank_replicas = {}
            return
        factor = torch.as_tensor(self._bank.factor)
        kind = torch.as_tensor(self._bank.kind.astype(np.int32))
        self._bank_replicas = {dev: (factor.to(dev), kind.to(dev))
                               for dev in self._devices()}

    def ensure_factor_bank(self) -> int:
        """Load the bank once, lazily; returns the servable entry count."""
        if not self._bank_load_attempted:
            with obs.span("engine.bank_load") as sp:
                self.load_factor_bank()
                sp.set(entries=0 if self._bank is None else len(self._bank))
        return 0 if self._bank is None else len(self._bank)

    def unload_factor_bank(self) -> None:
        """Forget any loaded bank and reset the bank counters: the next
        :meth:`ensure_factor_bank` re-attempts the verified load, and the
        miss delegate restarts its solver ladder."""
        self._bank = None
        self._bank_lookup = None
        self._bank_replicas = {}
        self._bank_load_attempted = False
        self._bank_hits = 0
        self._bank_misses = 0
        self._bank_dropped_stale = 0
        if self._bank_delegate is not None:
            self._bank_delegate.solver = (
                policy.next_solver("precomputed") or "direct")

    def bank_contains(self, u: int, i: int) -> bool:
        return bool(self._bank_lookup) and (int(u), int(i)) in self._bank_lookup

    def bank_stats(self) -> dict:
        """The engine's bank counters."""
        return {
            "entries": 0 if self._bank is None else len(self._bank),
            "hits": int(self._bank_hits),
            "misses": int(self._bank_misses),
            "dropped_stale": int(self._bank_dropped_stale),
        }

    def _miss_delegate(self) -> "InfluenceEngine":
        """Bank misses serve from a private engine at the next rung,
        config-identical except solver and cache_dir, so a miss is
        bitwise a bank-less engine at that rung."""
        if self._bank_delegate is None:
            self._bank_delegate = self._sibling(
                policy.next_solver("precomputed") or "direct")
        return self._bank_delegate

    def _bank_serving_eligible(self) -> bool:
        """The hit program is the flat prelude plus a bank gather: it
        needs the flat path's Gauss-Newton hooks, and a loaded bank."""
        return self._bank_device is not None and self._gn_hooks()

    def _query_bank_hits(self, points: np.ndarray, rows: np.ndarray,
                         pad_to: int | None) -> InfluenceResult:
        """One bank-hit dispatch (every point has a bank row): the flat
        program with each iHVP from the query's factor, one captured graph
        a geometry on the card. On a classified device fault the points
        re-route through the miss delegate."""
        try:
            inject.fire(sites.ENGINE_DISPATCH_FLAT)
            counts, out, plan = self._enqueue_flat(points, "bank",
                                                   bank_rows=rows)
            pad = bucketed_pad(counts.max() if counts.size else 1,
                               self.pad_bucket, pad_to)
            return self._assemble_packed(points, counts, out, pad,
                                         q=plan[1])
        except Exception as e:
            if taxonomy.classify(e) is None:
                raise
            self._bank_hits -= len(points)
            self._bank_misses += len(points)
            obs.REGISTRY.counter(
                "engine.bank_hit_fallbacks").inc(len(points))
            return self._miss_delegate().query_batch(points, pad_to=pad_to)

    def _merge_stream(self, test_points, hits, misses,
                      pad_to: int | None) -> InfluenceResult:
        """Stitch two sub-results back into stream order as one packed
        result (``hits``/``misses`` are (positions, result)); per-query
        bounds of a sampled sub-result come along, exact ones are 0."""
        counts = self.index.counts_batch(test_points)
        T = len(test_points)
        d = int(self.model.block_size)
        ihvp = np.zeros((T, d), np.float32)
        tg = np.zeros((T, d), np.float32)
        off = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
        packed = np.zeros(int(off[-1]), np.float32)
        approx = any(res.approx for _, res in (hits, misses))
        err = np.zeros(T, np.float32) if approx else None
        for idxs, res in (hits, misses):
            for r, tpos in enumerate(idxs):
                packed[off[tpos]: off[tpos + 1]] = res.scores_of(r)
                ihvp[tpos] = res.ihvp[r]
                tg[tpos] = res.test_grad[r]
                if err is not None and res.err_bound is not None:
                    err[tpos] = res.err_bound[r]
        pad = bucketed_pad(counts.max() if counts.size else 1,
                           self.pad_bucket, pad_to)
        return InfluenceResult(
            counts=counts, ihvp=ihvp, test_grad=tg, packed=packed,
            test_points=np.asarray(test_points), index=self.index, pad=pad,
            err_bound=err, approx=approx,
        )

    def _query_precomputed(self, test_points: np.ndarray,
                           pad_to: int | None) -> InfluenceResult:
        """The ``precomputed`` rung: bank hits in one dispatch, every
        other query through the delegate at the next rung."""
        self.ensure_factor_bank()
        T = test_points.shape[0]
        if not self._bank_serving_eligible():
            self._bank_misses += T
            obs.REGISTRY.counter("engine.bank_misses").inc(T)
            return self._miss_delegate().query_batch(test_points,
                                                     pad_to=pad_to)
        lut = self._bank_lookup
        rows = np.fromiter((lut.get((int(u), int(i)), -1)
                            for u, i in test_points), np.int64, count=T)
        hit = rows >= 0
        nh = int(np.count_nonzero(hit))
        self._bank_hits += nh
        self._bank_misses += T - nh
        obs.REGISTRY.counter("engine.bank_hits").inc(nh)
        obs.REGISTRY.counter("engine.bank_misses").inc(T - nh)
        obs.event("bank.partition", hits=nh, misses=T - nh)
        if nh == T:
            return self._query_bank_hits(test_points, rows, pad_to)
        if nh == 0:
            return self._miss_delegate().query_batch(test_points,
                                                     pad_to=pad_to)
        hi, mi = np.flatnonzero(hit), np.flatnonzero(~hit)
        res_h = self._query_bank_hits(test_points[hi], rows[hi], pad_to)
        res_m = self._miss_delegate().query_batch(test_points[mi],
                                                  pad_to=pad_to)
        return self._merge_stream(test_points, (hi, res_h), (mi, res_m),
                                  pad_to)

    # -- certified sampled rung ------------------------------------------------
    def _count_escalations(self, reason: str, n: int) -> None:
        self._sampled_escalations[reason] = (
            self._sampled_escalations.get(reason, 0) + int(n))
        obs.REGISTRY.counter("engine.sampled_escalations",
                             reason=reason).inc(int(n))

    def sampled_stats(self) -> dict:
        """The sampled rung's counters on this engine: queries answered
        by the sampled program, and queries escalated one rung, by reason
        (``ineligible``, ``tolerance``, or a fault kind). The registry
        counts them process-wide too (``engine.sampled_queries``,
        ``engine.sampled_escalations{reason}``)."""
        return {"queries": int(self._sampled_queries),
                "escalations": dict(self._sampled_escalations)}

    def _sampled_fallback(self) -> "InfluenceEngine":
        """Escalation target of the sampled rung: a config-identical
        engine one rung down (``sampled → lissa``), kept across batches."""
        if self._sampled_delegate is None:
            self._sampled_delegate = self._sibling(
                policy.next_solver("sampled") or "direct")
        return self._sampled_delegate

    def approx_sibling(self) -> "InfluenceEngine":
        """A config-identical engine at the ``sampled`` rung with no disk
        cache (serving answers ``bank_preferred`` misses from it under
        brownout, so a certified approximate answer is never written
        under, or read from, the exact solver's cache keys). Built once;
        an engine already on the sampled rung is its own sibling."""
        if self.solver == "sampled":
            return self
        if self._approx_sibling is None:
            self._approx_sibling = self._sibling("sampled")
        return self._approx_sibling

    def _result_take(self, res: InfluenceResult, idxs: np.ndarray,
                     test_points: np.ndarray) -> InfluenceResult:
        """A packed result restricted to the query positions ``idxs``,
        in stream order."""
        off = res._offsets
        packed = (np.concatenate([res._packed[off[t]: off[t + 1]]
                                  for t in idxs])
                  if len(idxs) else np.zeros(0, np.float32))
        return InfluenceResult(
            counts=res.counts[idxs], ihvp=res.ihvp[idxs],
            test_grad=res.test_grad[idxs], packed=packed,
            test_points=np.asarray(test_points)[idxs], index=self.index,
            pad=res._pad,
            err_bound=None if res.err_bound is None else res.err_bound[idxs],
            approx=res.approx,
        )

    def _query_sampled(self, test_points: np.ndarray,
                       pad_to: int | None) -> InfluenceResult:
        """The ``sampled`` rung: one subsampled dispatch for the batch;
        a query whose bound exceeds ``sampled_tol`` is recomputed one rung
        down and merged back in its place."""
        T = test_points.shape[0]
        if not self._sampled_eligible():
            self._count_escalations("ineligible", T)
            return self._sampled_fallback().query_batch(test_points,
                                                        pad_to=pad_to)
        try:
            res = self._dispatch_sampled(test_points, pad_to)
        except Exception as e:
            cls = taxonomy.classify(e)
            if cls is None:
                raise
            # one-shot degradation on a classified device fault: rebuild
            # the device state, then the fallback engine (which owns the
            # full retry and CPU ladder) answers the whole batch
            self._count_escalations(cls, T)
            self._reset_device_state()
            return self._sampled_fallback().query_batch(test_points,
                                                        pad_to=pad_to)
        self._sampled_queries += T
        err = res.err_bound  # fetched with the scores: no extra wait
        over = np.flatnonzero(err > self.sampled_tol)
        obs.REGISTRY.counter("engine.sampled_queries").inc(T)
        obs.event("engine.sampled", queries=T, escalated=int(len(over)),
                  err_max=float(err.max()) if T else 0.0)
        if len(over) == 0:
            return res
        self._count_escalations("tolerance", len(over))
        res_e = self._sampled_fallback().query_batch(test_points[over],
                                                     pad_to=pad_to)
        keep = np.flatnonzero(err <= self.sampled_tol)
        if len(keep) == 0:
            return res_e
        sub = self._result_take(res, keep, test_points)
        return self._merge_stream(test_points, (keep, sub), (over, res_e),
                                  pad_to)

    def _sampled_eligible(self) -> bool:
        """The sampled program is the single-device flat program with
        weighted Hessian sums: it needs the flat path's conditions, and
        a mesh engine escalates one rung through the delegate (as the
        reference: the rung serves cheap bounded answers, which a
        mesh-size batch does not need)."""
        return self.mesh is None and self._gn_hooks()

    def _sampled_inputs(self, test_points: np.ndarray):
        """``(counts, tx, ws, m, s_pad)`` of one sampled dispatch: the
        flat query block, the host-drawn sample weights of every row of
        the padded query block (so the flat pad covers the pad queries'
        rows), and the sample sizes, on the device."""
        counts = self.index.counts_batch(test_points)
        tx_np = self._pad_queries(
            np.ascontiguousarray(np.asarray(test_points, np.int64)))
        pcounts = (self.index.counts_batch(tx_np)
                   if len(tx_np) > len(test_points) else counts)
        s_pad = self._s_pad_for(int(pcounts.sum()))
        # a Philox sample keyed on each (u, i) pair: the same pair serves
        # the same answer and bound in any batch
        ws, m = sampled_mod.sample_weights(tx_np, pcounts, s_pad,
                                           self.sampled_cap)
        return (counts, self._upload(tx_np.astype(np.int32)),
                self._upload(ws), self._upload(m), s_pad)

    def _enqueue_sampled(self, test_points: np.ndarray):
        """Queue one sampled dispatch: ``(counts, (scores, ihvp, v,
        err_bound))`` on the device. The program of the dispatch's
        ``(t_pad, s_pad)`` geometry (a captured CUDA graph on the card,
        as the reference jit-compiles ``_sampled_fn`` once a geometry)
        replays on the current stream; the host never waits here."""
        inject.fire(sites.ENGINE_SAMPLED_SOLVE)
        counts, tx, ws, m, s_pad = self._sampled_inputs(test_points)
        return counts, self._flat_exec(tx.shape[0], s_pad, "sampled")(
            tx, ws, m)

    def _dispatch_sampled(self, test_points: np.ndarray,
                          pad_to: int | None) -> InfluenceResult:
        with obs.span("engine.dispatch_sampled", n=int(len(test_points))):
            counts, out = self._enqueue_sampled(test_points)
            pad = bucketed_pad(counts.max() if counts.size else 1,
                               self.pad_bucket, pad_to)
            return self._assemble_packed(test_points, counts, [out], pad)

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

    @staticmethod
    def _padded_related(pad: int):
        """``related(train_x, postings, tx) -> (nu, ni, rel_idx,
        rel_mask)``: each query's related train rows at pad ``pad``, user
        postings first, then item postings, duplicates kept
        (InteractionIndex.related's order)."""

        def related(train_x, postings, tx):
            u, i = tx[:, 0].long(), tx[:, 1].long()
            uoff, urows, ioff, irows = postings
            nu = uoff[u + 1] - uoff[u]
            ni = ioff[i + 1] - ioff[i]
            p = torch.arange(pad, device=tx.device)
            gu = urows[torch.clamp(uoff[u][:, None] + p, 0,
                                   urows.shape[0] - 1)]
            gi = irows[torch.clamp(ioff[i][:, None] + (p - nu[:, None]), 0,
                                   irows.shape[0] - 1)]
            rel_idx = torch.where(p < nu[:, None], gu, gi)
            return nu, ni, rel_idx, p < (nu + ni)[:, None]

        return related

    def _padded_fn(self, pad: int, sharded: bool = False):
        """The reference's ``_query_one`` over T queries at once, packed
        on the device (``_batched_packed``). Returns ``fn(params,
        train_x, train_y, postings, tx, total, s) -> (packed, ihvp, v,
        iterations)``; ``total`` is the batch's related-row count, which
        the host knows, so packing needs no device-to-host wait, and the
        packed scores are zero-padded to ``s >= total`` entries.
        ``sharded``: ``params`` holds shard-local tables and the sorted
        keys ``(su, si)`` follow ``s`` (as :meth:`_flat_fn`'s)."""
        model = self.model
        related = self._padded_related(pad)

        def fn(params, train_x, train_y, postings, tx, total: int, s: int,
               *keys):
            T = tx.shape[0]
            u, i = tx[:, 0].long(), tx[:, 1].long()
            nu, ni, rel_idx, rel_mask = related(train_x, postings, tx)
            rel_x = train_x[rel_idx]
            rel_y = train_y[rel_idx]
            if sharded:
                su, si = keys
                u, i = SH.remap(su, u), SH.remap(si, i)
                tx = torch.stack([u, i], dim=1).to(tx.dtype)
                rel_x = torch.stack([SH.remap(su, rel_x[..., 0]),
                                     SH.remap(si, rel_x[..., 1])], dim=-1)
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
            packed = torch.nn.functional.pad(packed, (0, s - total))
            return packed, ihvp, v, iterations

        return fn

    def _query_padded(self, test_points: np.ndarray, pad_to: int | None,
                      s_pad: int | None = None) -> InfluenceResult:
        """One padded dispatch at a single pad length. ``s_pad``: the
        packed output's length (at least the batch's related-row total;
        ``None``: its geometric bucket), which the chunks of one batch
        share."""
        inject.fire(sites.ENGINE_DISPATCH_PADDED)
        counts = self.index.counts_batch(test_points)
        m = counts.max() if counts.size else 1
        if pad_to is None and self.pad_policy == "dataset":
            m = self.index.max_related_count()
        pad = bucketed_pad(m, self.pad_bucket, pad_to)
        # the flat dispatch's query shards (one without a mesh), each at
        # the batch's pad on its slot's device, fetched and stitched
        T = len(counts)
        ndev, q = self._mesh_plan(counts, T)[:2]
        blocks = self._shard_blocks(np.asarray(test_points, np.int64), ndev,
                                    q, q)
        fn = self._padded_fn(pad, self._sharded_now())
        related = self._padded_related(pad)

        def rel_ids(dev, tx):
            _, train_x, _, postings = self._state_on(dev)
            return train_x[related(train_x, postings, tx)[2]].reshape(-1, 2)

        outs, its = [], []
        for block, sh in zip(blocks, self._local_shards(blocks, rel_ids)):
            if sh is None:
                outs.append(None)
                its.append(None)
                continue
            dev, tx, params, state, keys = sh
            tot = int(self.index.counts_batch(block).sum())
            s = (int(s_pad) if s_pad is not None and tot <= s_pad
                 else bucketed_pad(tot, 1024))
            with _on(dev):
                *out, it = fn(params, *state, tx, tot, s, *keys)
            outs.append(out)
            its.append((it,))
        # iterations: the longest shard's loop count (of every process's)
        its = [int(x) for (x,) in pdist.fill_shards(its) if x is not None]
        iterations = max(its) if its else None
        return self._assemble_packed(test_points, counts, outs, pad,
                                     iterations, q=q)

    # -- the padded path's memory envelope -----------------------------------
    def _memlimits_seed(self) -> None:
        """Adopt the cross-process learned memory envelope (lazily)."""
        if self._memkey is not None:
            return
        backend = ("cuda:" + torch.cuda.get_device_name(self.device)
                   if self.device.type == "cuda" else "torch-cpu")
        ndev = 1 if self.mesh is None else int(self.mesh.devices.size)
        self._memkey = memlimits.key(backend, ndev, self.model_name,
                                     int(self.model.block_size))
        ok, bad = memlimits.load(self._memkey)
        self._cells_ok = max(self._cells_ok, ok)
        self._cells_bad = min(self._cells_bad, bad)
        if self._cells_ok >= self._cells_bad:
            # inconsistent records (a cache carried between cards of
            # different memory): trust the failure, not a poisoned ok
            self._cells_ok = self._cells_bad // 2

    def _record_ok(self, cells: int) -> None:
        self._cells_ok = max(self._cells_ok, cells)
        if cells >= self._cells_bad:
            # a success at or above a recorded failing size refutes it:
            # clear it, and remember the size so the persisted copy is
            # cleared too
            self._cells_bad = memlimits.UNSET_BAD
            self._cleared_bad = max(self._cleared_bad, cells)

    def _record_bad(self, cells: int) -> None:
        self._cells_bad = min(self._cells_bad, cells)
        self._cells_ok = min(self._cells_ok, self._cells_bad // 2)

    def _query_padded_adaptive(self, test_points: np.ndarray,
                               pad_to: int | None) -> InfluenceResult:
        """Memory-envelope bookkeeping around :meth:`_adaptive_run`: the
        envelope is seeded from, and what this batch taught it written
        back to, :mod:`fia_tpu_torch.utils.memlimits`."""
        self._memlimits_seed()
        state0 = (self._cells_ok, self._cells_bad, self._cleared_bad)
        try:
            return self._adaptive_run(test_points, pad_to)
        finally:
            if (self._cells_ok, self._cells_bad, self._cleared_bad) != state0:
                try:
                    memlimits.update(self._memkey, self._cells_ok,
                                     self._cells_bad,
                                     clear_bad_at=self._cleared_bad or None)
                    self._cleared_bad = 0
                except Exception:
                    # persistence must never replace a query's result
                    # (this runs in a finally)
                    pass

    def _adaptive_run(self, test_points: np.ndarray, pad_to: int | None
                      ) -> InfluenceResult:
        """A padded batch, split when device memory runs out.

        A (T, pad) padded program's temporaries scale with T x pad x d.
        On an out-of-memory failure the batch is re-dispatched in halved
        query chunks at the SAME pad (so chunks concatenate exactly); the
        working and failing cell counts persist on the engine, so later
        batches (other pads too) pre-chunk instead of failing again. A
        worker death rebuilds the device state and halves, teaching the
        envelope nothing; a preemption rebuilds and retries at the same
        size (at most 3 times). Every other failure rises, the ambiguous
        kind among them (the reference's TPU compile-helper failure,
        which nothing on CUDA raises).
        """
        test_points = np.asarray(test_points)
        T = test_points.shape[0]
        counts = self.index.counts_batch(test_points)
        m = counts.max() if counts.size else 1
        if pad_to is None and self.pad_policy == "dataset":
            m = self.index.max_related_count()
        pad = bucketed_pad(m, self.pad_bucket, pad_to)

        chunk = T
        if self._cells_bad < memlimits.UNSET_BAD and (
            T * pad >= self._cells_bad
            or (self._cells_ok and T * pad > self._cells_ok)
        ):
            # memory pressure was seen: never try an untested larger
            # size, stay at the known-good cell count (a power-of-two
            # chunk, so the chunks of a power-of-two batch are alike)
            good = self._cells_ok // pad
            chunk = good if good else max(1, (self._cells_bad // pad) // 2)
            chunk = max(1, min(T, chunk))
            if chunk < T:
                chunk = 1 << (chunk.bit_length() - 1)
        preempt_left = 3
        if chunk >= T:
            try:
                out = self._query_padded(test_points, pad)
            except Exception as e:
                cls = taxonomy.classify(e)
                if cls not in _PADDED_KINDS or (
                    T <= 1 and cls != taxonomy.PREEMPTION
                ):
                    raise
                if cls == taxonomy.PREEMPTION:
                    preempt_left -= 1
                    if preempt_left < 0:
                        raise
                    self._reset_device_state()
                    # into the chunked loop at the same size
                elif cls == taxonomy.WORKER:
                    self._reset_device_state()
                    chunk = max(1, T // 2)
                else:
                    self._record_bad(T * pad)
                    chunk = max(1, T // 2)
            else:
                # record successes too, so one misread transient failure
                # cannot over-chunk a size that dispatches fine for good
                self._record_ok(T * pad)
                return out

        # one packed-output length for every chunk of this batch: the
        # sliding-window maximum bounds any contiguous chunk of the
        # current size, so halving mid-loop just recomputes it
        cum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])

        def shared_s(c: int) -> int:
            win = int((cum[min(c, T):] - cum[: T - min(c, T) + 1]).max())
            return bucketed_pad(max(win, 1), 1024)

        parts: list[InfluenceResult] = []
        start = 0
        s_shared = shared_s(chunk)
        prev_chunk = chunk
        while start < T:
            if chunk != prev_chunk:
                s_shared = shared_s(chunk)
                prev_chunk = chunk
            n = min(chunk, T - start)
            try:
                parts.append(self._query_padded(
                    test_points[start: start + n], pad, s_shared))
            except Exception as e:
                cls = taxonomy.classify(e)
                if cls == taxonomy.PREEMPTION:
                    preempt_left -= 1
                    if preempt_left < 0:
                        raise
                    self._reset_device_state()
                    continue  # same size: no size evidence
                if n <= 1 or cls not in _PADDED_KINDS:
                    raise
                if cls == taxonomy.WORKER:
                    self._reset_device_state()
                else:
                    self._record_bad(n * pad)
                chunk = max(1, n // 2)
                continue
            self._record_ok(n * pad)
            start += n
        return parts[0] if len(parts) == 1 else _concat_results(parts)

    def _query_grouped(self, test_points: np.ndarray) -> InfluenceResult:
        """``group_queries``: one padded dispatch per pad bucket of the
        batch, stitched into a dense result at the largest pad."""
        counts = self.index.counts_batch(test_points).astype(np.int64)
        pads = np.array([bucketed_pad(int(c), self.pad_bucket)
                         for c in counts])
        uniq = np.unique(pads)
        if len(uniq) == 1:
            return self._query_padded_adaptive(test_points, None)
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
            r = self._query_padded_adaptive(test_points[sel], int(p))
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
        if self.solver == "precomputed":
            return self._query_precomputed(test_points, pad_to)
        if self.solver == "sampled":
            return self._query_sampled(test_points, pad_to)
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
        return self._query_padded_adaptive(test_points, pad_to)

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
                obs.diag("reliability", "non-finite influence payload from "
                         f"the {self.solver!r} solver with no fallback rung "
                         "left; returning as-is (check damping/conditioning)")
                return res
            obs.diag("reliability", "non-finite influence payload from "
                     f"{self.solver!r}; escalating solver to {nxt!r}")
            obs.event("solver.escalate", **{"from": self.solver, "to": nxt})
            obs.REGISTRY.counter("engine.solver_escalations",
                                 **{"from": self.solver, "to": nxt}).inc()
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
        Each call is an ``engine.query`` span, counted by solver in
        ``engine.queries_total`` and timed (host wall, µs) in
        ``engine.query_us``.
        """
        t0 = time.perf_counter()
        with obs.span("engine.query", solver_requested=self.solver) as sp:
            res = self._query_batch_impl(test_points, pad_to)
            res = self._nan_ladder(
                res, lambda: self._query_batch_impl(test_points, pad_to))
            # the ladder may have escalated self.solver
            sp.set(solver=self.solver, kernel=self._kernel_variant,
                   n=int(np.asarray(test_points).reshape(-1, 2).shape[0]))
        obs.REGISTRY.counter("engine.queries_total", solver=self.solver).inc()
        obs.REGISTRY.histogram("engine.query_us", solver=self.solver).observe(
            (time.perf_counter() - t0) * 1e6)
        return res

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

        A worker death or a preemption kills every batch in flight at
        once: the device state is rebuilt (:meth:`_reset_device_state`)
        and the unfinished batches run in order through
        :meth:`_query_flat`, whose own ladder absorbs a recurring fault;
        finished batches are host arrays and are kept (journaled, with a
        journal). The flat program is split invariant, so the results
        have the bits of the run without the fault. Any other failure
        rises, with the finished batches journaled.

        The reference's ``_wide_block_cap`` (``engine.py:1494-1507``),
        which caps wide-block dispatches at 32 queries to dodge a fault
        of the TPU worker, is scoped to that backend and not carried
        over.
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
        done = 0  # finalize order == dispatch order == batch order
        try:
            inflight: list = []
            for k in todo:
                if deadline is not None:
                    deadline.check("query_many (dispatch)")
                inflight.append((k, self._dispatch_flat(batches[k], pad_to)))
                if len(inflight) >= max(1, window):
                    j, h = inflight.pop(0)
                    bank(j, self._finalize_flat(h))
                    done += 1
            while inflight:
                j, h = inflight.pop(0)
                bank(j, self._finalize_flat(h))
                done += 1
        except Exception as e:
            if taxonomy.classify(e) not in (taxonomy.WORKER,
                                            taxonomy.PREEMPTION):
                raise
            inflight = []  # the dead dispatches' outputs
            self._reset_device_state()
            for k in todo[done:]:
                bank(k, self._query_flat(batches[k], pad_to))
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
        """JSON-packable form of one batch result (exact round-trip; the
        reference's fields)."""
        base = {
            "counts": np.asarray(res.counts),
            "ihvp": np.asarray(res.ihvp),
            "test_grad": np.asarray(res.test_grad),
        }
        if res.err_bound is not None:
            base["err_bound"] = np.asarray(res.err_bound)
            base["approx"] = np.asarray(res.approx)
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
        err = p["err_bound"] if "err_bound" in p else None
        approx = bool(np.asarray(p["approx"])) if "approx" in p else False
        if p["fmt"] == "packed":
            return InfluenceResult(
                counts=p["counts"], ihvp=p["ihvp"],
                test_grad=p["test_grad"], packed=p["packed"],
                test_points=p["test_points"], index=self.index,
                pad=int(p["pad"]), err_bound=err, approx=approx,
            )
        return InfluenceResult(
            p["scores"], p["related_idx"], p["related_mask"],
            p["counts"], p["ihvp"], p["test_grad"], err_bound=err,
            approx=approx,
        )

    def get_influence_on_test_loss(self, test_indices, test_ds: RatingDataset,
                                   force_refresh: bool = True,
                                   test_description=None) -> np.ndarray:
        """The reference's signature: the scores of the related training
        rows of ``test_ds.x[test_indices[0]]`` (one index at a time).

        With a ``cache_dir`` the iHVP and scores are cached as an npz
        keyed like the reference (``<model>-<solver>-normal_loss-test-
        <desc>.npz``), published through the artifact integrity layer. A
        cached file serves when ``force_refresh`` is off, it verifies,
        and its params fingerprint matches the engine's; a corrupt file
        is quarantined and recomputed, then republished."""
        if len(test_indices) != 1:
            raise ValueError(
                f"one test index at a time, got {len(test_indices)}")
        t = int(test_indices[0])
        point = np.asarray(test_ds.x[t])
        cache = None
        if self.cache_dir is not None:
            desc = test_description if test_description is not None else [t]
            cache = os.path.join(
                self.cache_dir,
                f"{self.model_name}-{self.solver}-normal_loss-test-{desc}.npz")
        stale = False
        if cache is not None and not force_refresh and os.path.exists(cache):
            from fia_tpu_torch.reliability import artifacts

            try:
                hit = artifacts.load_npz(cache, require_manifest=False)
                if "scores" in hit and "params_fp" in hit and (
                        self._fingerprint_matches(hit["params_fp"])):
                    return hit["scores"]
            except artifacts.ArtifactIntegrityError:
                pass
            stale = True
        res = self.query_batch(point[None, :])
        if cache is not None and (force_refresh or stale
                                  or not os.path.exists(cache)):
            from fia_tpu_torch.reliability import artifacts

            artifacts.publish_npz(
                cache,
                dict(inverse_hvp=res.ihvp[0], scores=res.scores_of(0),
                     params_fp=self._params_fingerprint()),
                fingerprint={"model_key": self.model_name,
                             "solver": self.solver},
                site=sites.ENGINE_CACHE_PUBLISH,
            )
        return res.scores_of(0)

    def _params_fingerprint(self) -> np.ndarray:
        """The iHVP cache's identity: each param's sum and L2 norm (in
        sorted-name order, the reference's leaf order), the train set's
        row count and position-weighted x/y checksums (float64 on the
        host, compared exactly: a leave-one-out subset must not serve the
        full set's scores), and the solve configuration."""
        if self._params_fp is None:
            def stats_of(x):
                if not isinstance(x, SH.Placed):
                    return (torch.sum(x), torch.linalg.norm(x.reshape(-1)))
                # a row-sharded table: the shards' sums added in row
                # order, the norm from the shards' squared norms (the
                # zero pad rows add nothing); no whole table is formed
                parts = [p.to(self.device) for p in x.row_shards()]
                total = sum(torch.sum(p) for p in parts)
                sq = sum(torch.square(torch.linalg.norm(p.reshape(-1)))
                         for p in parts)
                return (total, torch.sqrt(sq))

            stats = torch.stack([
                s for k in sorted(self.params)
                for s in stats_of(self.params[k])
            ])
            hx, hy = self._train_host
            n = hx.shape[0]
            pos = ((np.arange(n) % 997) + 1).astype(np.float64)
            tstats = [
                float(n),
                float(np.sum(hx[:, 0].astype(np.float64) * pos)),
                float(np.sum(hx[:, 1].astype(np.float64) * pos)),
                float(np.sum(hy.astype(np.float64) * pos)),
            ]
            cfg = [self.damping, self.cg_tol, float(self.cg_maxiter),
                   self.lissa_scale, float(self.lissa_depth)]
            self._params_fp = np.concatenate([
                stats.cpu().numpy().astype(np.float64),
                np.asarray(tstats + cfg, np.float64),
            ])
        return self._params_fp

    # train stats + solve cfg at the fingerprint's tail (the exact part)
    _FP_EXACT_TAIL = 9

    def _fingerprint_matches(self, stored) -> bool:
        """Params stats within reduction noise (allclose); train checksums
        and solve config exactly."""
        fp = self._params_fingerprint()
        stored = np.asarray(stored)
        if stored.shape != fp.shape:
            return False
        k = fp.shape[0] - self._FP_EXACT_TAIL
        return bool(np.allclose(stored[:k], fp[:k])
                    and np.array_equal(stored[k:], fp[k:]))

    def related_indices(self, test_point) -> np.ndarray:
        u, i = int(test_point[0]), int(test_point[1])
        return self.index.related(u, i)

