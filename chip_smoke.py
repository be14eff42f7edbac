"""Drive the PyTorch/CUDA port (``fia_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. require a CUDA device; print the card's name and power limit;
  2. build every CUDA kernel of the paths from the sources in the
     checkout (``mf_scores``, ``ncf_scores``, ``segment_hessian``,
     ``segment_certificate``, ``block_eigmin``; one ``nvcc`` each, all
     started together);
     print ``nvcc --version`` and
     each kernel instantiation's ``ptxas`` registers and spills;
  3. hold ``segment_hessian`` (two launches: the pieces, their
     combination) bit for bit against its plain pieced form
     (``piece=piece_rows(d)``: pieces of P rows from each segment's
     start, each in row order, the partials added in piece order; run on
     the card, and held bit for bit to the same form on the CPU on two
     cases) and against float64 (``SEG_RTOL``), on the main path's
     operands at every batch size and on synthetic segments at every block
     size RQ2 runs (d = 34, 64, 514, 1,024): empty, one row, the longest
     related set of the data, P - 1, P, P + 1 and 3P + 5 rows, wv = 0
     rows, a truncated last segment; two launches the same bits; one
     segment the same bits at another offset in another batch size.
     Then hold each score kernel against its plain PyTorch version on
     the card, at
     its main path's shapes plus edge cases (a ragged row count, a fully
     masked segment, rows matching neither query id, rows that are their
     query's own pair (a = b = 1), rows permuted so that ``t`` is
     unsorted, one query over many row tiles; MF's scalar path and k = 6;
     NCF's general path on unaligned tables, and NCF at every width of the
     sweep, k = 6, 8, 32, 64, 128 and 256, where at k = 64, 128 and 256
     the kernel and the float32 plain version are each held against the
     plain version in float64), and require that two launches on the same
     inputs give the same bits;
  4. drive each main path — ``InfluenceEngine.query_batch`` at ML-1M
     shape (6040 users x 3706 items, 975,460 rows, k = 16), random seeded
     weights, for 256 and then 1024 held-out queries, first MF, then
     NCF; require that it launched its score kernel and ``segment_hessian``
     (each geometry a captured CUDA graph, whose replays count the
     launches it holds), that its scores equal those of the same engine
     with the plain score stage, and that a small input agrees with the
     port's CPU path;
  S. split invariance: the probe (:func:`probe`) takes fixed queries
     through the flat program at several batch compositions and
     requires every stage's per-query output (g and e rows, H_t, v_t,
     iHVP, reg_dot, scores) the same bits, at k = 16 and every RQ2 width,
     MF and NCF, and the batched LU alone the same bits at every batch
     size; the any-split phase requires ``query_many`` over 1024 queries
     at ``batch_queries`` 1024, 256, 100, 64 and 23 bitwise equal to one
     dispatch; the graph phase requires a replayed graph bitwise equal to
     the eager program, ``precompile_flat`` to report compiled then
     cached, and a warm ``query_batch`` plus ``query_many`` at two
     geometries to capture nothing (``utils/compilemon``);
  5. time the stages (and the Hessian stage of the one-hot form it
     replaced, in the same run), the end-to-end query rate with graphs
     and the eager program's, and each kernel beside its bound and its
     plain version (CUDA events; the card's power limit is printed
     beside them);
  6. drive the padded per-query program, first MF, then NCF, on 256 of
     the same queries: ``impl="padded"`` with the direct solve, then
     ``solver="cg"``, ``"schulz"`` and ``"lissa"`` (spectral tuning,
     depth 10,000). Require that every result was computed on the card,
     that neither score kernel launched (the padded path scores by
     matvec), that two identical calls give the same bytes, and that
     counts and related rows equal the flat path's; hold padded-direct,
     cg and schulz to the flat direct path of phase 4 (rtol 1e-3, atol
     1e-5, per-query Spearman ≥ 0.999), and LiSSA, which need not have
     converged at that depth, to the same truncated recursion in float64
     on the materialised block Hessians of 32 queries with the same
     (scale, shift) (rtol 1e-3, atol 1e-5); its Spearman against direct
     is recorded, not gated. On phase 4's small input, run every
     configuration of the padded program (also the autodiff Hessian,
     static LiSSA, ``group_queries`` and ``pad_policy="dataset"``) on
     the card against the port's CPU path, at the same bars. Time each
     solver's ``query_batch`` (median
     of 3 after a warm-up, of 2 for LiSSA), its device busy share and
     top kernels, the CG and Schulz iteration counts and LiSSA's ms a
     recursion step, under ``models.<family>.padded`` in the ``perf``
     line;
  7. training and the paper's experiments, first MF, then NCF, under
     ``models.<family>.train``:
     a. on phase 4's small input (k = 8), ``Trainer.fit`` through all
        three phases (minibatch Adam, full-batch Adam, SGD), a
        ``retrain`` and ``loo_retrain_many`` with four lanes (one of
        them -1) on the card against the same calls on the CPU with the
        same schedules, per-step losses and params at rtol 1e-4 /
        atol 1e-6; lanes chunked 2 and 4 agree at the same bar;
     b. at ML-1M shape (k = 16, batch 3020), a bounded run of each
        training phase (``FULL_STEPS``), steps/s per phase, the device
        busy share of a 200-step window, the loss required to fall; a
        checkpoint round trip through ``save_rotated`` and
        ``restore_latest_valid`` required bitwise; ``query_batch`` at
        T = 256 on the trained weights, kernel against plain score
        stage at phase 4's bar, relu-boundary rows counted;
     c. RQ1: ``test_retraining`` on two held-out points with 7b's
        weights (16 removals x 2 repeats, all lanes in one stack),
        every lane finite, the score kernel launched for each point;
        lane-steps/s, Pearson and Spearman printed, not gated;
     d. RQ2: ``time_influence_queries`` at k = 8 ... 256 on 64 held-out
        points with seeded weights, through ``query_batch`` and through
        ``query_many(batch_queries=32)``; at each k the kernel's
        ``query_batch`` against the plain score stage's at phase 4's
        bar; each ``query_many`` batch bitwise equal to ``query_batch``
        on its queries, no dispatch waiting on the card
        (``torch.cuda.set_sync_debug_mode``), and the whole bitwise equal
        to one ``query_batch``; each width's stages timed by cumulative
        prefix, its captured geometries counted with their memory.
     The kernel launches of each path (phase 4's ``query_batch``, 7c,
     7d) go into the ``kernels`` line under ``launches_by_path``.
  8. the rest of the solver ladder at ML-1M shape, first MF, then NCF,
     under ``ladder`` in the ``perf`` line:
     a. ``segment_certificate`` (two launches a call) against its
        plain version on the card (rtol 1e-5 plus 1e-6 of the output's
        largest entry, NaN and infinity where it is), on the sampled
        program's operands at T = 256 and 1024 and on synthetic
        segments (empty; m = 0; m = 1; m = n; m = cap < n; the longest
        related set; one truncated at the flat pad; pad rows past the
        last segment; an infinite row that is not sampled, which must
        make its segment's σ̂ NaN); two launches the same bits; its ms
        by graph replay beside its bytes bound and the plain version;
     g. ``block_eigmin`` (the sampled certificate's λ_min: Householder
        tridiagonalisation, then Sturm multisection) on the sampled
        program's H at T = 256 and 1024, and (once) on synthetic
        blocks: diagonal, repeated eigenvalues, indefinite, λ_min at the
        damping floor, and d = 18, 130, and 16 blocks at each of
        ``EIG_WIDE_D`` (256, 258, 512, 514, 1,024: one thread-block
        cluster a block, of 2, 2, 3, 3 and 11 CTAs; the damping-floor
        and indefinite kinds at 512 too), and 1,024 random and
        indefinite blocks at each of ``EIG_SMALL_D`` (d = 2 … 12). Each
        block's λ_min bit for bit its plain version (run on the card)
        and, from d = ``EIG_REACH`` (12) up, within ``EIG_C`` · d · eps ·
        ‖H‖_F of float64 ``eigvalsh`` (the largest c seen, and each
        case's λ_min range beside its bar, are printed; below 12, where
        float32 ``eigvalsh`` misses that bar too, c is printed beside
        its c, with the least width from which the bar held); two
        launches the same bits; a block the same bits in a batch of 1
        and in the whole batch; a diagonal block exactly its smallest
        diagonal entry; ms by graph replay beside its bound, the plain
        version and ``torch.linalg.eigvalsh`` in pieces of 64 (the
        library call it replaced, which the port no longer calls); at
        each wide width the kernel's ms (events) required below
        ``eigvalsh``'s on the same blocks, with its rounds, cluster size,
        resident clusters and the device-memory scratch of a call on
        1,024 blocks (``max_memory_allocated`` less the output, checked
        0 there and at the main path's T = 1024);
     h. the sampled rung at RQ2's upper widths (MF k = 256, d = 514; NCF
        k = 128, d = 512) on 256 queries beside direct on the same
        queries: wall ms, busy share, ``block_eigmin``'s share of the
        device time, the graph pools; the rung's H on those queries
        held as g holds a case;
     b. ``segment_hessian`` under the sampled rung's weights n/m, on
        the sampled program's operands and on synthetic segments (m < n,
        m = 1): bit for bit the plain pieced form, and within the
        float64 bar;
     c. the sampled rung (``solver="sampled"``, cap 64; one captured
        CUDA graph a geometry): each of its kernels launched; a replayed
        graph bitwise the eager program; no host wait while a dispatch
        is queued (``torch.cuda.set_sync_debug_mode("error")``); on phase
        4's small input the card against the CPU path, each query's
        largest score error within ``CPU_RTOL`` of its largest |score|;
        |sampled − direct| <= err_bound + 1e-6 on at
        least 99% of 1024 queries; at cap 1e6 bitwise the direct path
        with every bound 0; ``query_many`` at 1024, 256, 100 and 23 a
        batch bitwise one dispatch, scores and bounds; at a tolerance
        of the median bound of 64 queries, those over it bitwise the
        lissa rung's (depth 200), each in its place; wall ms and
        scores/s (median of 5) beside direct, busy share and device ms
        by kernel, host waits a dispatch, ``sample_weights``' host ms;
        each captured geometry's graph pool beside the eager program's
        peak memory on the same batch;
     d. the factor bank: 1024 hot pairs built (time, Cholesky and
        inverse kinds, MB), published, loaded with nothing stale; on
        256 queries, half bank pairs, hits at Spearman >= 0.999 against
        direct, misses bitwise direct, a hit alone the same bits as in
        the batch; all-hit batches of 256 and 1024 beside direct (and
        the graph pools of the engines' sampled miss delegates); a
        user's row moved, ``refresh_bank`` drops exactly the entries it
        touches; the library calls' times (``cholesky_ex``, ``eigh``,
        the bank solve, ``eigvalsh`` in pieces of 64);
     e. ``FullInfluenceEngine`` (MF, ML-1M shape, CG, maxiter 100, two
        points): ms an HVP, iterations, relative residual; on phase 4's
        small input the card against the CPU at rtol 1e-4;
     f. ``FIAModel`` on phase 4's small input, trained 60 steps on the
        card: its influence bitwise the engine's.
     The ``kernels`` line gains the ``segment_certificate`` and
     ``block_eigmin`` rows, and each row's ``launches_by_path`` the
     sampled and bank paths.
  9. recovery and observability, first MF, then NCF, at ML-1M shape on
     phase 8's held-out queries (the memory envelope in a temporary
     file), under ``recovery`` in the ``perf`` line:
     a. a worker death injected at the second dispatch of
        ``query_many`` (1024 queries, 256 a batch, 4 in flight): every
        batch bitwise the run without the fault, ``engine.upload`` fired
        once, the captured graphs dropped and recaptured (counts before
        and after printed), no tensor from before the reset reachable
        from the engine or its delegates;
     b. in ``query_batch(1024)``, a worker death at the first dispatch
        retried as 512 + 512 and a preemption retried once at 1024, each
        bitwise the run without the fault;
     c. a real CUDA OOM on the flat path (all but 1 MiB of the card's
        free memory, and the allocator's cached free blocks, held by
        blockers, then a geometry not captured yet), and one raised
        inside a capture (the captured program asks for more memory than
        the card has): with ``cpu_fallback=False`` it rises classified
        OOM, the capture ended and the graph's pool released; with
        the CPU rung on (``cpu_fallback=True``) on phase 4's small input,
        the answer within phase 4's card-vs-CPU bar, one batch counted in
        ``engine.cpu_fallback_batches`` and one reliability diagnostic;
        no capture
        left open; once the blocker is freed, the same engines answer on
        the card bitwise as before;
     d. a real CUDA OOM on the padded direct program at T = 256 under
        ``set_per_process_memory_fraction`` (the resident memory plus
        three quarters of the full batch's own): it ends in halves, at
        phase 6's bars against the uncapped run (bitwise or not,
        printed), the memlimits file holds the failing size as the
        ceiling, and a fresh engine dispatches only the chunks that
        succeeded, none failing;
     e. (once) a device-side assert in a child process, then a query:
        it raises classified DEVICE_LOST within 60 s, with no retry,
        reset or CPU rung;
     f. ``query_many(1024)`` traced (``obs.configure(trace=True)``) with
        each dispatch under ``set_sync_debug_mode("error")``: bitwise the
        untraced run, ``engine.query`` and ``engine.dispatch_flat`` spans
        present, the Perfetto and Prometheus exports parse; the traced
        and untraced walls (``utils.timing.fenced_time``) are printed,
        not gated.
     Every engine outside phase 9 is built with ``cpu_fallback=False``
     (the port's default, passed explicitly), and after each earlier
     phase the obs registry must show no retry
     (``reliability.retries_total``), no device-state reset
     (``engine.device_resets``), no batch on the CPU rung
     (``engine.cpu_fallback_batches``) and no reliability diagnostic.

NCF's kernel and plain version sum each relu pre-activation in another
order, so a pre-activation within rounding of 0 can take the other side
of its mask and move that row's score far beyond the bar. Such a row
passes only if the plain version in float64 puts one of the row's
pre-activations within ``BOUNDARY_REL`` of 0; the rows so excused are
counted and printed, and any other row beyond the bar fails the run.
The same rule holds the NCF padded path against the flat one (phase 6),
whose relu masks come from another forward pass.

Likewise two rows whose exact scores differ by a few float32 ulps can
be ordered either way by two summation orders, and one such swap costs a
query of 156 rows 3.2e-6 of Spearman. A query below ``RHO_MIN`` passes
only if the plain version in float64 puts every pair the two rankings
order differently within ``TIE_REL`` of each other plus the plain
float32 version's own distance from float64 on the two rows; such pairs
are counted and printed.

The last lines of standard output are a ``perf`` line, the card's
``nvidia-smi`` name and power limit, a ``{"kernels": [...]}`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.synthetic import (
    sample_heldout_pairs,
    synthesize_ratings,
    synthetic_splits,
)
from fia_tpu_torch.api import FIAModel
from fia_tpu_torch.eval import metrics
from fia_tpu_torch.eval.rq1 import test_retraining
from fia_tpu_torch.eval.rq2 import time_influence_queries
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence import grads as G
from fia_tpu_torch.influence import hvp as HV
from fia_tpu_torch.influence import sampled as sampled_mod
from fia_tpu_torch.influence import solvers, spectral
from fia_tpu_torch.influence.engine import (STAGES, InfluenceEngine,
                                           _FlatGraph,
                                           _bank_solve, _in_pieces,
                                           capturing)
from fia_tpu_torch.influence.full import FullInfluenceEngine
from fia_tpu_torch.influence.kernels import certificate as kcert
from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import eigmin as keig
from fia_tpu_torch.influence.kernels import mf as kmf
from fia_tpu_torch.influence.kernels import ncf as kncf
from fia_tpu_torch.influence.kernels import segment as kseg
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.obs.export import perfetto, prometheus, span_fields
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.train import checkpoint
from fia_tpu_torch.train.trainer import Trainer, TrainConfig, loo_retrain_many
from fia_tpu_torch.utils import compilemon, memlimits
from fia_tpu_torch.utils.timing import fenced_time

# ML-1M shape and the reference's defaults (bench.py's full run)
USERS, ITEMS, ROWS = 6040, 3706, 975_460
K_EMB, WD, DAMPING = 16, 1e-3, 1e-6
BATCHES = (256, 1024)
# kernel against its plain version, same inputs, same card
RTOL, ATOL = 2e-5, 1e-6
RHO_MIN = 1.0 - 1e-6  # ~5 adjacent swaps of float-noise ties at 400 rows
# the card against the port's CPU path on a small input: another
# Hessian summation order and another LU implementation
CPU_RTOL, CPU_ATOL, CPU_RHO_MIN = 1e-4, 1e-5, 0.9999
# an NCF row beyond the bar is a relu-mask flip only if a float64
# pre-activation of it is within this share of the row's largest (or 1)
BOUNDARY_REL = 1e-5
# two scores closer than this share of the larger (≈ 8 float32 ulps, in
# float64) are a tie that float32 arithmetic cannot order
TIE_REL = 1e-6
# NCF operand-level widths beyond the main path's k = 16: the kernel's
# register-blocked widths (8, 32, 64) and its general path (6, 128, 256);
# and row cuts
NCF_WIDE_K = (6, 8, 32, 64, 128, 256)
NCF_WIDE_ROWS = {256: 65_536}
# widths whose 128..512-term dots drift apart in two float32 orders: there
# the kernel and the float32 plain version are each held against float64
NCF_FLOAT64_K = (64, 128, 256)
# queries whose rows make the one-query case (~4k rows, many row tiles)
ONE_QUERY_FROM = 12
# published H100 SXM peaks (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the padded program (phase 6): its batch, solvers and bars against the
# flat direct path on the same card (the reference's flat-vs-padded bar,
# tests/test_influence.py:356-377, and the rank bar of an iterative solve)
PADDED_T = 256
PADDED_SOLVERS = ("direct", "cg", "schulz", "lissa")
PADDED_RTOL, PADDED_ATOL, PADDED_RHO = 1e-3, 1e-5, 0.999
# LiSSA is held to the same truncated recursion in float64 on this many
# queries; a first call slower than LISSA_SLOW_S seconds times the rest
# at LISSA_SMALL_T queries; the per-step time is over LISSA_TIMED_STEPS
# steps; the profiled call runs LISSA_PROFILE_DEPTH steps (a 10,000-step
# trace is too large for the profiler)
LISSA_GATE_Q, LISSA_SLOW_S, LISSA_SMALL_T = 32, 30.0, 64
LISSA_TIMED_STEPS, LISSA_PROFILE_DEPTH = 200, 200
# every configuration of the padded program, on the small input of phase
# 4 on the card against the port's CPU path, at the phase's bars; damping
# 1e-2 keeps MF's blocks there at cond ≤ 2e2, so CG's float32 stopping
# point (‖r‖ ≤ 1e-5‖v‖) stays well inside rtol 1e-3 on both sides
SMALL_DAMPING = 1e-2
SMALL_CONFIGS = {
    "padded direct": {"impl": "padded"},
    "autodiff Hessian": {"impl": "padded", "hessian_mode": "autodiff"},
    "cg": {"solver": "cg"},
    "schulz": {"solver": "schulz"},
    "lissa spectral": {"solver": "lissa", "lissa_depth": 1000},
    "lissa static": {"solver": "lissa", "lissa_tune": "static",
                     "lissa_depth": 1000},
    "group_queries": {"group_queries": True, "pad_bucket": 32},
    "pad_policy dataset": {"pad_policy": "dataset"},
}
# phase 7a: training on the card against the port on the CPU, on phase
# 4's small input at k = 8: one fit through all three phases, a retrain
# and four leave-one-out lanes (one of them -1), with the same schedules
TRAIN_SMALL_FIT = dict(batch_size=200, num_steps=60, learning_rate=1e-2,
                       seed=5, iter_to_switch_to_batch=30,
                       iter_to_switch_to_sgd=45)
TRAIN_SMALL_LOO = dict(removed=(3, -1, 17, 3), seeds=(1, 2, 1, 2), steps=25)
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6
# phase 7b: training at full width (ML-1M shape, the reference's batch
# 3020, lr 1e-3): minibatch Adam for three epochs, then full-batch Adam
# and full-batch SGD; the device-busy share over a 200-step window
FULL_BATCH, TRAIN_LR = 3020, 1e-3
FULL_STEPS = {"minibatch": 969, "batch": 30, "sgd": 30}
BUSY_WINDOW = 200
# phase 7c: RQ1 on two held-out points per model from 7b's weights, all
# (16 + 1) x 2 lanes stacked in one chunk, two epochs of retraining
RQ1_POINTS, RQ1_REMOVE, RQ1_TIMES, RQ1_STEPS = 2, 16, 2, 646
# phase 7d: RQ2's width sweep on 64 held-out points, through query_batch
# and through query_many in batches of 32
RQ2_K, RQ2_Q, RQ2_BATCH = (8, 16, 32, 64, 128, 256), 64, 32
# the any-split phase: 1024 held-out queries through query_many at each
# batch size (ragged finals; t_pad 1024, 256, 128, 64, 64), every query's
# scores, iHVP and test vector the same bits as one dispatch of all
ANY_SPLIT_Q, ANY_SPLITS = 1024, (1024, 256, 100, 64, 23)
# the graph phase: query_batch at T = 256, then query_many at these batch
# sizes over the same queries, once to warm and once counted
GRAPH_T, GRAPH_SPLITS = 256, (8, 16)
# widths whose dots drift apart in two float32 orders: there 7d holds the
# kernel and the float32 plain version each against float64
RQ2_FLOAT64_K = (64, 128, 256)
# the segment-Hessian kernel: bit for bit the plain pieced form
# (piece=piece_rows(d); the same products and sums in the same order: wv is
# 0 or 1 on every case), and against float64 each entry of H_t within
# SEG_RTOL of it plus SEG_ATOL_REL of max |H_t|; an entry beyond that
# passes only within the bound of a float32 sum of the segment's n_t terms
# in order, γ_{n_t} Σ|terms| (γ_n = n u / (1 - n u), u = 2^-24), and is
# counted. Cases: the main path's operands (MF and NCF, every T of BATCHES),
# and
# synthetic rows at every block size of SEG_D (MF k = 16, NCF k = 16, MF
# k = 256, NCF k = 256) with segments empty, of one row, of the longest
# related set (the data's at d <= 64, RQ2's 64 queries' at d > 64), of
# P - 1, P, P + 1 and 3P + 5 rows (P = piece_rows(d)), rows with wv = 0,
# and a last segment truncated at the flat pad
SEG_RTOL, SEG_ATOL_REL = 1e-5, 1e-6
SEG_D = (34, 64, 514, 1024)
# phase 8, the rest of the solver ladder, at ML-1M shape. The certificate
# kernel against its plain version: another float32 order of the same
# sums (σ̂ from up to ~86k squared deviations), rtol 1e-5 plus 1e-6 of the
# output's largest entry; the sampled rung at cap 64, its fidelity gate
# (|sampled − direct| <= err_bound + 1e-6, influence/sampled.py) on at
# least 99% of 1024 queries; query_many at these batch sizes bitwise one
# dispatch; the escalation on 64 queries at LiSSA depth 200; a bank of
# 1024 hot pairs, 256 queries half hits, hits at Spearman >= 0.999 against
# direct (the reference's factor smoke bar); the full-parameter engine's
# CG at maxiter 100, and on the small input the card against the CPU at
# the training bar, rtol 1e-4 (damping 1: the tiny model's full Hessian
# PD, so both CG runs converge); FIAModel trained 60 steps
CERT_SOURCE = "segment_certificate"
CERT_REPLACES = "fia_tpu/influence/sampled.py:103"
CERT_RTOL, CERT_ATOL_REL = 1e-5, 1e-6
SAMPLED_CAP = 64
FIDELITY_SHARE = 0.99
# the sampled rung on phase 4's small input, card against the CPU on the
# same samples: scores at CPU_RTOL / CPU_ATOL, bounds at the rtol that
# tests/test_torch_sampled.py holds the port's bound to against the
# reference's (BOUND_RTOL): another Hessian order, another eigensolver
SAMPLED_BOUND_RTOL = 1e-4
SAMPLED_SPLITS = (1024, 256, 100, 23)
# 8g, the certificate's λ_min kernel: each block bit for bit its plain
# version and within EIG_C · d · eps · ‖H‖_F of float64 eigvalsh (eps =
# 2^-23; the earlier Jacobi kernel within 0.046 on the card) at every width
# from EIG_REACH up, where tests/test_torch_eigmin.py holds the plain
# version to it on the CPU; below, at EIG_SMALL_D (MF and NCF at k = 1 have
# d = 4), neither it nor float32 eigvalsh reaches that bar, and c is
# printed beside eigvalsh's on EIG_SMALL_T blocks of each kind. Synthetic
# blocks of EIG_T each, EIG_WIDE_T at each of the wide widths EIG_WIDE_D
# (RQ2's MF k = 128 and 256, NCF k = 64, 128 and 256), the device-memory
# scratch of a call on BATCHES[-1] blocks at each; 8h: the sampled rung at
# WIDE_RUNG's widths on WIDE_RUNG_T queries, its H held as 8g's
EIGMIN_SOURCE = "block_eigmin"
EIGMIN_REPLACES = "fia_tpu/influence/engine.py:2504"
EIG_C = 0.25
EIG_T, EIG_WIDE_T, EIG_WIDE_D = 64, 16, (256, 258, 512, 514, 1024)
EIG_REACH, EIG_SMALL_T, EIG_SMALL_D = 12, 1024, (2, 3, 4, 5, 6, 8, 10, 12)
WIDE_RUNG, WIDE_RUNG_T = (("mf", 256), ("ncf", 128)), 256
ESCALATE_T, ESCALATE_DEPTH = 64, 200
BANK_ENTRIES, BANK_T, BANK_RHO = 1024, 256, 0.999
FULL_MAXITER, FULL_RTOL, FULL_SMALL_DAMPING = 100, 1e-4, 1.0
EPS32 = float(np.finfo(np.float32).eps)
FACADE_STEPS = 60
# the card (phase 7 names it once)
CARD = "cuda"
SOURCES = {"mf": "mf_scores", "ncf": "ncf_scores"}
SEGMENT_SOURCE = "segment_hessian"
# the reference's XLA segment reduction the Hessian kernel replaces
# (accum: body_scatter / body_onehot, assembled into H_t at 972-977)
SEGMENT_REPLACES = "fia_tpu/influence/engine.py:920"
KERNEL_MODULES = {"mf": kmf, "ncf": kncf}
REPLACES = {"mf": "fia_tpu/influence/kernels/mf.py:25",
            "ncf": "fia_tpu/influence/kernels/ncf.py:30"}


def engine(*args, **kw) -> InfluenceEngine:
    """An engine with the CPU rung off (``cpu_fallback=False``, the
    port's default, passed so that no later default can turn it on): outside
    phase 9 a phase passes on the card or fails, never on a recovery
    ladder (:func:`no_recovery` checks the rest of them)."""
    return InfluenceEngine(*args, cpu_fallback=False, **kw)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the toolkit's release)."""
    out = subprocess.run([common.find_nvcc(), "--version"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()
    return out[-1].strip() if out else "unknown"


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output, names demangled where ``c++filt`` is."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if m.group(1) in report else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
    filt = shutil.which("c++filt")
    if filt and report:
        names = subprocess.run([filt], input="\n".join(report), text=True,
                               capture_output=True, timeout=60,
                               check=True).stdout.splitlines()
        if len(names) == len(report):
            report = dict(zip(names, report.values()))
    return report


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Rank correlation with average ranks for ties."""

    def ranks(x):
        _, inv, cnt = np.unique(x, return_inverse=True, return_counts=True)
        # average rank of each distinct value, in sorted order
        start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        return (start + (cnt - 1) / 2.0)[inv]

    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back runs, by CUDA events
    on the current stream, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Device ms of one ``fn`` call: ``iters`` calls captured in one
    CUDA graph and replayed between two events, so the host's launch
    overhead is not counted; the median of ``replays`` replays, so one
    stall of the card during a replay does not set the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):  # warm up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_breakdown(fn, wall_ms: float, top: int = 8,
                     match: str | None = None) -> dict:
    """Device time of one ``fn`` call by kernel (``torch.profiler``), and
    the busy share of ``wall_ms``, the call's unprofiled host time; with
    ``match``, also the device ms of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    out = {
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                        for e in kern[:top]],
    }
    if match is not None:
        out["matched_ms"] = sum(e.self_device_time_total for e in kern
                                if match in e.key) / 1e3
    return out


def boundary_rows(rel_x, tables64) -> torch.Tensor:
    """(R,) bool: the NCF rows ``rel_x`` whose float64 pre-activations
    (z1, z2) come within BOUNDARY_REL · max(1, max |z| of the row) of 0,
    where a relu mask may rightly differ between two summation orders."""
    P_mlp, Q_mlp, _, _, W1, b1, W2, b2, _ = tables64
    z1, z2 = kncf.preactivations(rel_x[:, 0].long(), rel_x[:, 1].long(),
                                 P_mlp, Q_mlp, W1, b1, W2, b2)
    z = torch.cat([z1, z2], dim=1).abs()
    lim = BOUNDARY_REL * torch.clamp(z.max(dim=1).values, min=1.0)
    return z.min(dim=1).values <= lim


def hold(got, want, wv, what: str, rel_x=None, tables64=None
         ) -> tuple[float, int]:
    """Scores ``got`` against ``want`` at RTOL/ATOL, exact 0 where
    wv = 0. With ``tables64`` (NCF) a row beyond the bar passes only if
    it sits on a relu boundary (:func:`boundary_rows`). Returns the max
    abs error over the other rows and the count of rows so excused."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite scores")
    check(bool((got[wv == 0] == 0).all()), f"{what}: a wv = 0 row scored non-zero")
    diff = (got.double() - want.double()).abs()
    bad = diff > ATOL + RTOL * want.double().abs()
    n_bad = int(bad.sum())
    if n_bad:
        worst = float(diff.max())
        check(tables64 is not None,
              f"{what}: {n_bad} rows beyond rtol {RTOL} atol {ATOL} (max abs "
              f"err {worst:.3e})")
        on_edge = boundary_rows(rel_x[bad], tables64)
        check(bool(on_edge.all()),
              f"{what}: {int((~on_edge).sum())} rows beyond rtol {RTOL} atol "
              f"{ATOL} and not on a relu boundary (max abs err {worst:.3e})")
    err = float(diff[~bad].max()) if int((~bad).sum()) else 0.0
    return err, n_bad


def float32_ties(a, b, exact) -> tuple[int, list]:
    """The pairs of rows that rankings ``a`` and ``b`` (``b`` the plain
    float32 version) order differently: their count, and those that
    ``exact`` (float64) does not put within TIE_REL of each other plus
    the plain float32 version's own error on the two rows, as ``(i, j,
    a_i, a_j, b_i, b_j, exact_i, exact_j)`` (at most three)."""
    sa = np.sign(a[:, None] - a[None, :])
    sb = np.sign(b[:, None] - b[None, :])
    i, j = np.nonzero(np.triu(sa != sb, 1))
    gap = np.abs(exact[i] - exact[j])
    own = np.abs(b - exact)
    tie = gap <= (TIE_REL * np.maximum(np.abs(exact[i]), np.abs(exact[j]))
                  + own[i] + own[j])
    wide = [(int(x), int(y), float(a[x]), float(a[y]), float(b[x]),
             float(b[y]), float(exact[x]), float(exact[y]))
            for x, y in zip(i[~tie][:3], j[~tie][:3])]
    return len(i), wide


def compare_results(res, ref, what: str, rtol: float, atol: float,
                    rho_min: float, excuse=None, exact=None) -> dict:
    """Counts and related rows exact, scores allclose, per-query
    Spearman; returns the worst errors seen. ``excuse(rows)`` (NCF), on
    the packed row numbers of a query's rows beyond the bar, says which
    lie on a relu boundary: those pass, are counted, and are left out
    of the query's Spearman. ``exact`` (the packed scores in float64)
    lets a query below ``rho_min`` pass when every pair the two rankings
    order differently is a float32 tie (:func:`float32_ties`); it is a
    callable, called only once a query falls below ``rho_min``."""
    check(np.array_equal(res.counts, ref.counts), f"{what}: counts differ")
    offsets = np.concatenate([[0], np.cumsum(res.counts)])
    max_abs, min_rho, excused = 0.0, 1.0, 0
    tie_pairs = 0
    for t in range(len(res.counts)):
        a, b = res.scores_of(t), ref.scores_of(t)
        check(a.shape == b.shape == (int(res.counts[t]),),
              f"{what}: query {t} has {a.shape} scores, want {res.counts[t]}")
        check(bool(np.isfinite(a).all()), f"{what}: non-finite scores")
        keep = np.ones(len(a), bool)
        if len(a):
            bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
            if bad.any():
                worst = float(np.max(np.abs(a - b)))
                ok = (excuse(offsets[t] + np.flatnonzero(bad))
                      if excuse is not None else np.zeros(int(bad.sum()), bool))
                check(bool(ok.all()),
                      f"{what}: query {t} scores differ beyond rtol {rtol} "
                      f"atol {atol} (max abs {worst:.3e})")
                excused += int(bad.sum())
                keep = ~bad
            if keep.any():
                max_abs = max(max_abs, float(np.max(np.abs(a - b)[keep])))
        a, b = a[keep], b[keep]
        if len(a) > 1 and np.ptp(a) > 0 and np.ptp(b) > 0:
            rho = spearman(a, b)
            min_rho = min(min_rho, rho)
            if rho < rho_min:
                check(exact is not None,
                      f"{what}: query {t} Spearman {rho} < {rho_min}")
                n, wide = float32_ties(
                    a, b, exact()[offsets[t]: offsets[t + 1]][keep])
                check(not wide, f"{what}: query {t} Spearman {rho} < "
                      f"{rho_min} and its rankings differ beyond float32 "
                      f"ties: (i, j, a_i, a_j, b_i, b_j, float64 i, j) "
                      f"{wide}")
                tie_pairs += n
    check(bool(np.isfinite(res.ihvp).all()), f"{what}: non-finite ihvp")
    return {"max_abs_err": max_abs, "min_spearman": min_rho,
            "boundary_rows": excused, "float32_tie_pairs": tie_pairs}


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def bound(nb: int, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mf_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for one MF score call on these
    operands: each input read once, the output written once, against
    ~4k + 10 fp32 operations a row."""
    tx, t, rel_x, e, wv, B, P, Q = ops
    S, k = rel_x.shape[0], P.shape[1]
    return bound(nbytes(*ops) + S * 4, S * (4 * k + 10))


def ncf_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for one NCF score call on these
    operands: each input read once, the output written once, against
    the fp32 operations this run's rows need once every product that
    depends on the query alone is formed once per query. A row with
    wv ≠ 0, a = [user = u_t] and b = [item = i_t] needs, in FMAs, the
    half of [pm|qm] W1 that is not the query's own row (k², none when
    a = b = 1), z2 and dz2 W2ᵀ (2·k·k2), and 2k(a + b) for the dots
    dz1 · (W1ᵀx)-half and (qg or pg) · (w3g ⊙ x)-quarter, plus 5
    operations of the score epilogue. Each query needs 4k² FMAs (its own
    rows times W1, W1's halves times x) and 2k products w3g ⊙ x."""
    tx, t, rel_x, e, wv, B, *tables = ops
    T, k, k2 = tx.shape[0], tables[0].shape[1], tables[6].shape[1]
    q = tx[t.long()]
    live = wv != 0
    a = live & (rel_x[:, 0] == q[:, 0])
    b = live & (rel_x[:, 1] == q[:, 1])
    need = a | b
    fma = (int((need & ~(a & b)).sum()) * k * k
           + int(need.sum()) * 2 * k * k2
           + int(a.sum() + b.sum()) * 2 * k
           + T * 4 * k * k)
    flops = 2 * fma + 5 * int(live.sum()) + T * 2 * k
    return bound(nbytes(*ops) + rel_x.shape[0] * 4, flops)


BOUNDS = {"mf": mf_bound_ms, "ncf": ncf_bound_ms}


def kernel_args(ops):
    """Operands ``(tx, t, rel_x, e, wv, B, *tables)`` in the kernel
    wrappers' order ``(rel_x, t, e, wv, tx, *tables, B)``."""
    tx, t, rel_x, e, wv, B, *tables = ops
    return (rel_x, t, e, wv, tx, *tables, B)


def edge_cases(ops, gen: torch.Generator):
    """(name, operands) at the main path's shapes plus the edge cases
    both kernels take: a ragged S, a fully masked segment, foreign rows,
    rows that are their query's own pair, unsorted ``t``, and one query
    whose rows span many row tiles."""
    tx, t, rel_x, e, wv, B, *tables = ops
    S = rel_x.shape[0]
    cases = [("main path", ops)]
    r = S - 37  # not a multiple of the 64-row block
    cases.append(("ragged S", (tx, t[:r], rel_x[:r], e[:r], wv[:r], B,
                               *tables)))
    wv0 = wv.clone()
    wv0[t == 0] = 0.0  # segment 0 fully masked
    cases.append(("masked segment", (tx, t, rel_x, e, wv0, B, *tables)))
    foreign = rel_x.clone()
    pick = torch.randint(0, S, (S,), generator=gen).to(rel_x.device)
    foreign[::3] = rel_x[pick[::3]]  # mostly rows of other queries
    cases.append(("foreign rows", (tx, t, foreign, e, wv, B, *tables)))
    own = rel_x.clone()
    own[::7] = tx[t[::7].long()]  # a = b = 1
    cases.append(("own pair rows", (tx, t, own, e, wv, B, *tables)))
    perm = torch.randperm(S, generator=gen).to(rel_x.device)
    cases.append(("unsorted t", (tx, t[perm], rel_x[perm], e[perm], wv[perm],
                                 B, *tables)))
    one = t < ONE_QUERY_FROM  # query 0's rows, then other queries' as foreign
    cases.append(("T=1", (tx[:1], torch.zeros_like(t[one]), rel_x[one], e[one],
                          wv[one], B[:1], *tables)))
    return cases


def ncf_cases(ops, gen: torch.Generator):
    """NCF: the edge cases and the general path (one warp a row) at the
    main path's width, which tables off 16-byte alignment take."""
    tx, t, rel_x, e, wv, B, *tables = ops
    cases = edge_cases(ops, gen)
    shifted = []
    for x in tables[:4]:  # the embedding tables, 4 bytes off alignment
        y = torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x)
        y.copy_(x)
        shifted.append(y)
    cases.append(("general path", (tx, t, rel_x, e, wv, B, *shifted,
                                   *tables[4:])))
    return cases


def launch_twice(mod, args) -> torch.Tensor:
    """The kernel's scores; fails unless a second launch on the same
    inputs gives the same bits."""
    got = mod.fused_scores(*args)
    again = mod.fused_scores(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{mod.__name__}: two launches on the same "
          "inputs differ")
    return got


def mf_cases(ops, gen: torch.Generator):
    """MF: the edge cases, the scalar (non-float4) path and k = 6."""
    tx, t, rel_x, e, wv, B, P, Q = ops
    cases = edge_cases(ops, gen)
    # 4-byte offset tables take the scalar (non-float4) path
    P1 = torch.empty(P.numel() + 1, device=P.device)[1:].view_as(P)
    Q1 = torch.empty(Q.numel() + 1, device=Q.device)[1:].view_as(Q)
    P1.copy_(P)
    Q1.copy_(Q)
    cases.append(("scalar path", (tx, t, rel_x, e, wv, B, P1, Q1)))
    # k = 6: a width that is not a multiple of 4
    k6 = 6
    P6 = torch.randn(P.shape[0], k6, generator=gen).to(P.device)
    Q6 = torch.randn(Q.shape[0], k6, generator=gen).to(Q.device)
    B6 = torch.randn(B.shape[0], 2 * k6 + 4, generator=gen).to(B.device)
    B6[:, -1] = B[:, -1]  # keep the real n_t column
    cases.append(("k=6", (tx, t, rel_x, e, wv, B6, P6, Q6)))
    return cases


def ncf_wide_ops(ops, k: int, gen: torch.Generator):
    """NCF operands at width k: the main path's rows, queries and n_t
    column (rows cut to NCF_WIDE_ROWS), seeded random tables and weights
    at the init's scales with small random biases, and a random
    iHVP/reg_dot part of B."""
    tx, t, rel_x, e, wv, B, *_ = ops
    S = min(rel_x.shape[0], NCF_WIDE_ROWS.get(k, rel_x.shape[0]))
    k2 = k // 2
    dev = rel_x.device

    def rnd(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen)).to(dev)

    se = 1.0 / math.sqrt(k)
    tables = (rnd(USERS, k, std=se), rnd(ITEMS, k, std=se),
              rnd(USERS, k, std=se), rnd(ITEMS, k, std=se),
              rnd(2 * k, k, std=1.0 / math.sqrt(2 * k)), rnd(k, std=0.1),
              rnd(k, k2, std=se), rnd(k2, std=0.1),
              rnd(k2 + k, 1, std=1.0 / math.sqrt(k2 + k)))
    Bk = rnd(B.shape[0], 4 * k + 2)
    Bk[:, -1] = B[:, -1]  # keep the real n_t column
    return (tx, t[:S], rel_x[:S], e[:S], wv[:S], Bk, *tables)


def to64(ops):
    return tuple(x.double() if x.is_floating_point() else x for x in ops)


def setup_engines(model, train):
    params = model.init_params(torch.Generator().manual_seed(0), device="cuda")
    eng = engine(model, params, train, damping=DAMPING)
    check(eng.active_kernel_variant() == "cuda",
          f"{type(model).__name__} engine did not pick cuda")
    plain = engine(model, params, train, damping=DAMPING,
                            kernel="torch", device="cuda")
    return eng, plain


def operands(eng, pts, T):
    """The score stage's operands ``(tx, t, rel_x, e, wv, B, *tables)``
    of a T-query batch, from the flat program's "operands" prefix."""
    _, tx, s_pad = eng._flat_inputs(pts[:T])
    out = eng._flat_fn(s_pad, "operands")(
        eng.params, eng.train_x, eng.train_y, eng._postings, tx)
    return (*out, *eng.model.kernel_operands(eng.params))


def check_kernel(family: str, eng, pts) -> dict:
    """Phase 3: the kernel against its plain version on the card."""
    mod = KERNEL_MODULES[family]
    name = SOURCES[family]
    gen = torch.Generator().manual_seed(1)
    ops = operands(eng, pts, BATCHES[0])
    err, excused = 0.0, 0
    # NCF's float64 tables, for its relu-boundary rule
    tables64 = to64(ops[6:]) if family == "ncf" else None
    cases = mf_cases if family == "mf" else ncf_cases
    for case, c_ops in cases(ops, gen):
        args = kernel_args(c_ops)
        got = launch_twice(mod, args)
        want = mod.fused_scores_reference(*args)
        torch.cuda.synchronize()
        e, n = hold(got, want, c_ops[4], f"{name} {case}", c_ops[2], tables64)
        err, excused = max(err, e), excused + n
        log(f"{name} vs plain [{case}] S={len(got)} max abs err {e:.3e}, "
            f"relu-boundary rows {n}")
    if family == "mf":
        return {"max_abs_err": err, "boundary_rows": excused}
    for k in NCF_WIDE_K:
        w_ops = ncf_wide_ops(ops, k, gen)
        args = kernel_args(w_ops)
        got = launch_twice(mod, args)
        plain32 = mod.fused_scores_reference(*args)
        args64 = kernel_args(to64(w_ops))
        want64 = mod.fused_scores_reference(*args64)
        torch.cuda.synchronize()
        t64 = to64(w_ops[6:])
        S = len(got)
        if k not in NCF_FLOAT64_K:  # kernel against the float32 plain version
            e, n = hold(got, plain32, w_ops[4], f"{name} k={k}", w_ops[2], t64)
            log(f"{name} vs plain [k={k}] S={S} max abs err {e:.3e}, "
                f"relu-boundary rows {n}")
        else:
            e, n = hold(got, want64, w_ops[4], f"{name} k={k} vs float64",
                        w_ops[2], t64)
            e32, n32 = hold(plain32, want64, w_ops[4],
                            f"{name} plain k={k} vs float64", w_ops[2], t64)
            log(f"{name} vs float64 plain [k={k}] S={S} max abs err {e:.3e}, "
                f"relu-boundary rows {n}; float32 plain vs float64 "
                f"{e32:.3e}, relu-boundary rows {n32}")
        err, excused = max(err, e), excused + n
    return {"max_abs_err": err, "boundary_rows": excused}


def segment_operands(eng, pts, T):
    """The Hessian kernel's operands ``(g, t, wv, abe, off)`` of a
    T-query batch, from the flat program's "segments" prefix."""
    _, tx, s_pad = eng._flat_inputs(pts[:T])
    return eng._flat_fn(s_pad, "segments")(
        eng.params, eng.train_x, eng.train_y, eng._postings, tx)


def segment_plain(ops, dtype=torch.float32, onehot: bool = False,
                  piece: int | None = None):
    """A plain form of the kernel on ``ops``, in ``dtype``: the scatter
    form in row order, the one-hot product it replaced, or (``piece``)
    the kernel's pieced order."""
    g, t, wv, abe, off = ops
    d = g.shape[1]
    chunk = max(1, min(2048, 4_000_000 // (d * d)))
    return kseg.segment_sums_reference(g.to(dtype), t, wv.to(dtype),
                                       abe.to(dtype), off.numel() - 1, chunk,
                                       onehot=onehot, piece=piece, off=off)


def segment_float64(ops, absolute: bool = False):
    """``(HH, sabe)`` in float64 by definition, a segment at a time on
    the card: (wv g)ᵀ g over its rows, or with ``absolute`` |wv g|ᵀ |g|
    and Σ |abe| (the terms' magnitudes, for the float32 sum's bound)."""
    g, t, wv, abe, off = ops
    S, d = g.shape
    g64, w64, a64 = g.double(), wv.double(), abe.double()
    if absolute:
        g64, w64, a64 = g64.abs(), w64.abs(), a64.abs()
    r0, r1 = (x.tolist() for x in kseg.segment_rows(off, S))
    HH = g64.new_zeros((len(r0), d, d))
    sabe = g64.new_zeros((len(r0),))
    for j, (a, b) in enumerate(zip(r0, r1)):
        if b > a:
            HH[j] = (g64[a:b] * w64[a:b, None]).T @ g64[a:b]
            sabe[j] = a64[a:b].sum()
    return HH, sabe


def segment_launch_twice(ops):
    g, t, wv, abe, off = ops
    got = kseg.segment_sums(g, t, wv, abe, off, 0)
    again = kseg.segment_sums(g, t, wv, abe, off, 0)
    torch.cuda.synchronize()
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "segment_hessian: two launches on the same inputs differ")
    return got


def segment_pieced_plain(ops):
    """The pieced plain form at ``piece_rows(d)`` on the operands' device
    (elementwise float32 products and sums in the kernel's order)."""
    return segment_plain(ops, piece=kseg.piece_rows(ops[0].shape[1]))


def segment_hold(got, ops, what: str) -> dict:
    """``(HH, sabe)`` of the kernel on ``ops`` against the plain pieced
    form (bit for bit) and float64 (at SEG_RTOL / SEG_ATOL_REL, or within
    the float32 recursive-sum bound γ_{n_t} Σ|terms|, counted). Returns
    the largest error as a share of max |H_t| and the count of entries
    the bound excused."""
    g, t, wv, abe, off = ops
    for x, c in zip(got, segment_pieced_plain(ops)):
        check(torch.equal(x, c), f"{what}: not bit for bit the plain "
              "pieced form")
    want = segment_float64(ops)
    absolute = segment_float64(ops, absolute=True)
    n = (off[1:] - off[:-1]).double() * 2.0 ** -24
    gamma = n / (1.0 - n)
    worst, worst_abs, excused = 0.0, 0.0, 0
    for x, w, a in zip(got, want, absolute):
        shape = (-1, *([1] * (w.dim() - 1)))
        scale = w.abs().reshape(w.shape[0], -1).amax(dim=1).reshape(shape)
        diff = (x.double() - w).abs()
        bad = diff > SEG_RTOL * w.abs() + SEG_ATOL_REL * scale
        beyond = bad & (diff > gamma.reshape(shape) * a)
        check(not bool(beyond.any()), f"{what}: {int(beyond.sum())} entries "
              f"beyond rtol {SEG_RTOL} / atol {SEG_ATOL_REL} x max|H_t| of "
              "float64 and beyond the float32 sum's bound (max abs err "
              f"{float(diff.max()):.3e})")
        check(bool(torch.isfinite(x).all()), f"{what}: non-finite sums")
        worst = max(worst, float((diff / scale.clamp(min=1e-30)).max()))
        worst_abs = max(worst_abs, float(diff.max()))
        excused += int(bad.sum())
    return {"max_err_of_max_abs_H": worst, "max_abs_err": worst_abs,
            "excused_by_float32_bound": excused}


def synthetic_segments(counts, S: int, d: int, gen: torch.Generator):
    """Operands ``(g, t, wv, abe, off)`` for segments of ``counts`` rows on
    an S-row flat axis (offsets clamped to S; rows past the total belong
    to the last segment with wv = 0, as the prelude lays them out), random
    rows, and every 7th row's wv = 0."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    T = counts.numel()
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).clamp(
        max=S)
    s = torch.arange(S)
    t = torch.searchsorted(off[1:T].contiguous(), s, right=True).to(
        torch.int32)
    wv = (s < off[-1]).to(torch.float32)
    wv[::7] = 0.0
    g = torch.randn(S, d, generator=gen)
    abe = torch.randn(S, generator=gen) * wv
    return tuple(x.to(CARD) for x in (g, t, wv, abe, off))


def check_segment(engines, pts, longest: int, longest_rq2: int) -> dict:
    """Phase 3 for the Hessian kernel (:func:`segment_hold`) on the main
    path's operands and on synthetic segments at every block size of
    SEG_D; two launches the same bits; the pieced form the same bits on
    the CPU and on the card; and a segment's sums the same bits alone and
    at another offset in another batch size."""
    gen = torch.Generator().manual_seed(2)
    cases = [(f"{f} main path T={T}", segment_operands(eng, pts, T))
             for f, (eng, _) in engines.items() for T in BATCHES]
    for d in SEG_D:
        n = longest if d <= 64 else longest_rq2
        P = kseg.piece_rows(d)
        cases.append((f"d={d} mixed", synthetic_segments(
            [0, 1, n, 5, 0, 77], n + 83 + 300, d, gen)))
        cases.append((f"d={d} truncated", synthetic_segments(
            [40, 1, 300], 191, d, gen)))
        pieces = [P - 1, 0, P, P + 1, 3 * P + 5, 2]
        cases.append((f"d={d} pieces P={P}", synthetic_segments(
            pieces, sum(pieces) + 77, d, gen)))
    worst, worst_abs, excused = 0.0, 0.0, 0
    for name, ops in cases:
        got = segment_launch_twice(ops)
        r = segment_hold(got, ops, f"segment_hessian {name}")
        worst_abs = max(worst_abs, r["max_abs_err"])
        log(f"segment_hessian [{name}] S={ops[0].shape[0]} "
            f"d={ops[0].shape[1]} T={ops[4].numel() - 1}: bit for bit the "
            f"pieced plain form; vs float64 {r}")
        worst = max(worst, r["max_err_of_max_abs_H"])
        excused += r["excused_by_float32_bound"]
    # the pieced form is one function on either device
    for name, ops in cases:
        if name in (f"ncf main path T={BATCHES[-1]}", f"d={SEG_D[2]} mixed"):
            cpu = segment_pieced_plain(tuple(x.cpu() for x in ops))
            card = segment_pieced_plain(ops)
            check(all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)),
                  f"segment_hessian [{name}]: the pieced plain form differs "
                  "between the CPU and the card")
            log(f"segment_hessian [{name}]: the pieced plain form the same "
                "bits on the CPU and on the card")
    offsets = ((SEG_D[0], longest), (SEG_D[1], 3 * kseg.piece_rows(64) + 5),
               (SEG_D[2], 3 * kseg.piece_rows(SEG_D[2]) + 5),
               (SEG_D[-1], longest_rq2))
    for d, n in offsets:
        g1, t1, wv1, abe1, off1 = synthetic_segments([n], n, d, gen)
        counts = torch.randint(0, 400, (40,), generator=gen)
        counts[23] = n
        g2, t2, wv2, abe2, off2 = synthetic_segments(counts, int(counts.sum()),
                                                     d, gen)
        a, b = int(off2[23]), int(off2[24])
        g2[a:b], wv2[a:b], abe2[a:b] = g1, wv1, abe1
        one = kseg.segment_sums(g1, t1, wv1, abe1, off1, 0)
        many = kseg.segment_sums(g2, t2, wv2, abe2, off2, 0)
        check(torch.equal(one[0][0], many[0][23])
              and torch.equal(one[1][0], many[1][23]),
              f"segment_hessian d={d}: a segment's sums change with its "
              "offset or the batch size")
        log(f"segment_hessian d={d}: a {n}-row segment alone and as segment "
            f"23 of 40 at row {a} (row {a % kseg.piece_rows(d)} of a piece "
            "grid from 0): the same bits")
        del g1, g2, one, many
    torch.cuda.empty_cache()
    return {"max_err_of_max_abs_H": worst, "max_abs_err": worst_abs,
            "excused_by_float32_bound": excused, "longest_segment": longest,
            "longest_segment_rq2": longest_rq2, "cases": len(cases),
            "piece_rows": {str(d): kseg.piece_rows(d) for d in SEG_D}}


def segment_geometry(ops) -> dict:
    """The kernel's work on ``ops``: its pieces (blocks with rows, each
    over every tile pair) and the scratch its later pieces may fill."""
    g, off = ops[0], ops[4]
    S, d = g.shape
    P = kseg.piece_rows(d)
    slots = kseg.scratch_slots(S, P)
    return {"piece_rows": P,
            "pieces": int(kseg.piece_counts(off, S, P).sum()),
            "grid_x": off.numel() - 1 + slots,
            "scratch_mb": slots * (d * d + 1) * 4 / 1e6}


def segment_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for the Hessian sums of ``ops``: the
    rows inside a segment read once (g, wv, abe), the offsets, HH and sabe
    written once; one multiply-add a row for each distinct entry of the
    symmetric block."""
    g, t, wv, abe, off = ops
    d = g.shape[1]
    T = off.numel() - 1
    rows = int(off[-1] - off[0])
    nb = rows * (d * 4 + 8) + (T + 1) * 8 + T * d * d * 4 + T * 4
    return bound(nb, rows * d * (d + 1))


def relu_excuse(family: str, ops):
    """NCF: ``excuse(rows)`` for :func:`compare_results`, over the packed
    row numbers of a batch whose flat operands are ``ops``: which rows
    lie on a relu boundary in float64. MF: ``None``."""
    if family != "ncf":
        return None
    rel_x, tables64 = ops[2], to64(ops[6:])

    def excuse(rows):
        idx = torch.as_tensor(rows, device=rel_x.device)
        return boundary_rows(rel_x[idx], tables64).cpu().numpy()

    return excuse


def drive(family: str, eng, plain, pts) -> dict:
    """Phase 4: the main path, launches counted from 0, against the
    plain score stage on the card and a small input against the CPU."""
    mod = KERNEL_MODULES[family]
    for m in (*KERNEL_MODULES.values(), kseg):
        m.launches = 0
    results = {T: eng.query_batch(pts[:T]) for T in BATCHES}
    launches, seg_launches = mod.launches, kseg.launches
    check(launches > 0, f"the {family} main path never launched "
          f"{SOURCES[family]}")
    check(seg_launches > 0, f"the {family} main path never launched "
          f"{SEGMENT_SOURCE}")
    d = eng.model.block_size
    parity = {}
    for T, res in results.items():
        check(res.ihvp.shape == (T, d) and res.test_grad.shape == (T, d),
              f"{family} T={T}: ihvp/test_grad shapes {res.ihvp.shape}")
        ref = plain.query_batch(pts[:T])
        ops = operands(eng, pts, T)
        total = int(res.counts.sum())

        @functools.cache
        def exact(ops=ops, total=total):
            scores = mod.fused_scores_reference(*kernel_args(to64(ops)))
            return scores[:total].cpu().numpy()
        parity[T] = compare_results(res, ref, f"{family} T={T} kernel vs "
                                    "plain", RTOL, ATOL, RHO_MIN,
                                    relu_excuse(family, ops), exact)
        log(f"{family} T={T}: {int(res.counts.sum())} scores, kernel vs "
            f"plain {parity[T]}")
    # a small input against the port's CPU path
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(eng.model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x[:21]
    on_card = engine(tm, tp, tiny["train"], damping=1e-3
                              ).query_batch(tq)
    on_cpu = engine(tm, tp, tiny["train"], damping=1e-3,
                             device="cpu").query_batch(tq)
    cpu_parity = compare_results(on_card, on_cpu, f"{family} card vs CPU "
                                 "(small)", CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    log(f"{family} card vs CPU path, small input: {cpu_parity}")
    return {"launches": launches, "segment_launches": seg_launches,
            "parity": {str(T): v for T, v in parity.items()},
            "cpu_parity": cpu_parity}


def measure(family: str, eng, train, pts) -> tuple[dict, dict, dict]:
    """Phase 5: stage prefixes, query rate, the kernel beside its bound
    and its plain version, and the device breakdown, per batch size."""
    mod = KERNEL_MODULES[family]
    batches, last, seg_last = {}, None, None
    # the one-hot contraction the Hessian kernel replaced, same weights
    onehot = engine(eng.model, eng.params, train,
                             damping=DAMPING, flat_accum="onehot")
    for T in BATCHES:
        counts, tx, s_pad = eng._flat_inputs(pts[:T])
        args = (eng.params, eng.train_x, eng.train_y, eng._postings, tx)
        stage_ms = stage_times(eng, pts[:T])
        onehot_ms = stage_times(onehot, pts[:T], iters=3)
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            eng.query_batch(pts[:T])  # returns host arrays: synchronised
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls[1:]))
        program = eng._flat_fn(s_pad)
        eager = []
        for _ in range(6):
            t0 = time.perf_counter()
            [o.cpu() for o in program(*args)]
            eager.append(time.perf_counter() - t0)
        seg_ops = segment_operands(eng, pts, T)
        seg_ms = graph_ms(lambda: kseg.segment_sums(*seg_ops, 0), iters=20)
        seg_call_ms = time_ms(lambda: kseg.segment_sums(*seg_ops, 0),
                              iters=20)
        # one call's device time by launch (the pieces, the combination)
        seg_parts = device_breakdown(lambda: kseg.segment_sums(*seg_ops, 0),
                                     seg_call_ms)
        # the plain version: the row-order scatter form by graph replay;
        # the pieced form has host waits (its step count): events
        seg_plain_ms = graph_ms(lambda: segment_plain(seg_ops), iters=3)
        seg_pieced_ms = time_ms(lambda: segment_pieced_plain(seg_ops),
                                iters=2, warmup=1)
        seg_onehot_ms = graph_ms(lambda: segment_plain(seg_ops, onehot=True),
                                 iters=1)
        seg_bound, seg_by = segment_bound_ms(seg_ops)
        seg_geo = segment_geometry(seg_ops)
        ops = operands(eng, pts, T)
        k_args = kernel_args(ops)
        k_ms = graph_ms(lambda: mod.fused_scores(*k_args), iters=50)
        p_ms = graph_ms(lambda: mod.fused_scores_reference(*k_args), iters=20)
        call_ms = time_ms(lambda: mod.fused_scores(*k_args), iters=50)
        # one call's device time by kernel (NCF: its two launches)
        parts = device_breakdown(lambda: mod.fused_scores(*k_args), call_ms)
        b_ms, bound_by = BOUNDS[family](ops)
        total = int(counts.sum())
        batches[str(T)] = {
            "scores": total, "s_pad": s_pad,
            "stage_ms_cumulative": stage_ms,
            "hessian_stage_ms": stage_ms["hessian"] - stage_ms["grads"],
            "stage_ms_cumulative_onehot": onehot_ms,
            "hessian_stage_ms_onehot": onehot_ms["hessian"]
            - onehot_ms["grads"],
            "segment_kernel_ms": seg_ms, "segment_plain_ms": seg_plain_ms,
            "segment_pieced_ms": seg_pieced_ms,
            "segment_onehot_ms": seg_onehot_ms,
            "segment_call_ms": seg_call_ms,
            "segment_parts_ms": [[name, ms] for name, ms, _ in
                                 seg_parts["top_kernels"]],
            "segment_geometry": seg_geo,
            "segment_bound_ms": seg_bound, "segment_bound_by": seg_by,
            "query_batch_ms": wall * 1e3,
            "query_batch_ms_runs": [w * 1e3 for w in walls],
            "eager_program_ms": float(np.median(eager[1:])) * 1e3,
            "scores_per_s": total / wall,
            "kernel_ms": k_ms, "kernel_plain_ms": p_ms,
            "kernel_call_ms": call_ms,
            "kernel_parts_ms": [[name, ms] for name, ms, _ in
                                parts["top_kernels"]],
            "kernel_bound_ms": b_ms, "kernel_bound_by": bound_by,
            "query_batch_device": device_breakdown(
                lambda: eng.query_batch(pts[:T]), wall * 1e3),
        }
        last = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": bound_by,
                "shape": {"S": int(ops[2].shape[0]), "T": int(tx.shape[0]),
                          "k": K_EMB}}
        seg_last = {"ms": seg_ms, "plain_ms": seg_plain_ms,
                    "pieced_ms": seg_pieced_ms,
                    "onehot_ms": seg_onehot_ms, "bound_ms": seg_bound,
                    "bound_by": seg_by, **seg_geo,
                    "shape": {"S": int(seg_ops[0].shape[0]),
                              "T": int(tx.shape[0]),
                              "d": int(seg_ops[0].shape[1])}}
        log(f"{family} T={T}: {json.dumps(batches[str(T)], sort_keys=True)}")
    del onehot
    torch.cuda.empty_cache()
    return batches, last, seg_last


def drive_any_split(family: str, eng, pts) -> dict:
    """The any-split phase: ANY_SPLIT_Q held-out queries through
    ``query_many`` at each of ANY_SPLITS, every query the same bits as
    one ``query_batch`` of all (``tests/test_dispatch.py:67-92`` restated
    port against port, on the card)."""
    q = pts[:ANY_SPLIT_Q]
    whole = eng.query_batch(q)
    out = {}
    for bq in ANY_SPLITS:
        parts = eng.query_many(q, batch_queries=bq)
        same_bytes_stitched(parts, whole, f"{family} any split: "
                            f"query_many(batch_queries={bq})")
        out[str(bq)] = {"batches": len(parts), "t_pad": sorted(
            {eng._query_pad(len(r.counts)) for r in parts})}
    out["geometries_captured"] = len(eng._programs)
    log(f"{family} any split, {ANY_SPLIT_Q} queries: bitwise equal to one "
        f"dispatch at batch_queries {ANY_SPLITS}: {json.dumps(out)}")
    return out


def drive_graphs(family: str, eng, train, pts) -> dict:
    """The graph phase: a replayed graph equals the eager program of the
    same geometry bit for bit; ``precompile_flat`` on a fresh engine
    reports two geometries compiled, then cached, and arms the rest of
    the plan; and after one warm pass, ``query_batch`` at GRAPH_T plus
    ``query_many`` at GRAPH_SPLITS capture nothing (the compilemon count
    stays; ``tests/test_dispatch.py:142-162`` restated)."""
    q = pts[:GRAPH_T]
    counts, tx, s_pad = eng._flat_inputs(q)
    eager = eng._flat_fn(s_pad)(eng.params, eng.train_x, eng.train_y,
                                eng._postings, tx)
    res = eng.query_batch(q)
    total, T = int(counts.sum()), len(q)
    check(res._packed.tobytes() == eager[0][:total].cpu().numpy().tobytes()
          and res.ihvp.tobytes() == eager[1][:T].cpu().numpy().tobytes()
          and res.test_grad.tobytes() == eager[2][:T].cpu().numpy().tobytes(),
          f"{family} graphs: a replayed graph differs from the eager program")
    fresh = engine(eng.model, eng.params, train, damping=DAMPING)
    plan = {fresh.flat_geometry(q)}
    for bq in GRAPH_SPLITS:
        plan |= {fresh.flat_geometry(q[i: i + bq])
                 for i in range(0, len(q), bq)}
    two = [fresh.flat_geometry(q), fresh.flat_geometry(q[:GRAPH_SPLITS[0]])]
    first = fresh.precompile_flat(two)
    again = fresh.precompile_flat(sorted(plan))
    check(first["compiled"] == [list(g) for g in two] and not first["cached"]
          and all(list(g) in again["cached"] for g in two)
          and len(again["compiled"]) == len(plan) - 2,
          f"{family} graphs: precompile_flat reported {first} then {again}")
    fresh.query_batch(q)
    for bq in GRAPH_SPLITS:
        fresh.query_many(q, batch_queries=bq)
    before = compilemon.count()
    warm = fresh.query_batch(q)
    for bq in GRAPH_SPLITS:
        fresh.query_many(q, batch_queries=bq)
    check(compilemon.count() == before, f"{family} graphs: the warm steady "
          f"state captured {compilemon.count() - before} programs")
    same_bytes(warm, res, f"{family} graphs: a precompiled engine")
    out = {"replay_vs_eager": "bitwise equal",
           "precompile_two": {"compiled": first["compiled"],
                              "seconds": first["seconds"]},
           "precompile_plan": {"geometries": len(plan),
                               "compiled": len(again["compiled"]),
                               "cached": len(again["cached"]),
                               "seconds": again["seconds"]},
           "steady_state_captures": 0,
           "compiled_geometries_aot": len(
               fresh.compiled_geometries()["aot"]),
           **graph_inventory(fresh)}
    log(f"{family} graphs: {json.dumps(out)}")
    del fresh
    torch.cuda.empty_cache()
    return out


def padded_engine(eng, train, solver: str, **kw):
    """A padded-path engine on ``eng``'s params: ``impl="padded"`` for
    the direct solve, else the iterative ``solver``."""
    kw = dict(kw, **({"impl": "padded"} if solver == "direct"
                     else {"solver": solver}))
    return engine(eng.model, eng.params, train, damping=DAMPING, **kw)


def spy_devices(eng) -> list:
    """Record the device of every output tensor the engine fetches to
    the host (its packed scores, iHVPs and test vectors)."""
    seen = []
    assemble = eng._assemble_packed

    def spy(test_points, counts, out, pad, iterations=None):
        seen.extend(o.device.type for o in out)
        return assemble(test_points, counts, out, pad, iterations)

    eng._assemble_packed = spy
    return seen


def padded_rows(eng, pts):
    """``(u, i, rel_x, rel_y, w)`` of the padded program for queries
    ``pts`` on the card: the related rows from the host index, in the
    program's order (user rows, then item rows), padded as it pads."""
    rel_idx, rel_mask, _ = eng.index.related_padded(pts, bucket=eng.pad_bucket)
    idx = torch.as_tensor(rel_idx, device=eng.device).long()
    tx = torch.as_tensor(np.asarray(pts, np.int64), device=eng.device)
    w = torch.as_tensor(rel_mask, device=eng.device).to(torch.float32)
    return tx[:, 0], tx[:, 1], eng.train_x[idx], eng.train_y[idx], w


def lissa_recursions(eng, pts, depth: int) -> tuple[np.ndarray, np.ndarray,
                                                    dict]:
    """The LiSSA gate's references for queries ``pts``: the padded
    program's truncated recursion run on the materialised analytic block
    Hessians (+ damping + shift), with the (scale, shift) that
    ``spectral.lissa_tuning`` gives on the port's traced HVP, once in
    float64 and once in float32 on the same matrices; and the scores of
    the per-example gradients against each iHVP. Returns the packed
    float64 and float32 scores and the tuning's range."""
    model, params = eng.model, eng.params
    u, i, rel_x, rel_y, w = padded_rows(eng, pts)
    d = model.block_size
    hvp = HV.make_batched_block_hvp(model, params, u, i, rel_x, rel_y, w,
                                    eng.damping, linearize=True)
    scale, shift = spectral.lissa_tuning(hvp, d, scale_floor=eng.lissa_scale,
                                         batch_shape=(len(pts),),
                                         device=eng.device)
    H = torch.func.vmap(lambda uu, ii, xx, yy, ww: model.block_hessian(
        params, uu, ii, xx, yy, ww))(u, i, rel_x, rel_y, w)
    H = H + (eng.damping + shift[:, None, None]) * torch.eye(
        d, device=eng.device)
    v = torch.func.vmap(lambda uu, ii, xj: G.block_prediction_grad(
        model, params, uu, ii, xj[None, :]))(
            u, i, torch.stack([u, i], dim=1).to(torch.int32))
    per_ex = torch.func.vmap(
        lambda uu, ii, xx, yy: G.per_example_block_loss_grads(
            model, params, uu, ii, xx, yy))(u, i, rel_x, rel_y)
    n = torch.clamp(w.sum(1), min=1.0)
    mask = w.bool()
    out = []
    for dt in (torch.float64, torch.float32):
        Hd, vd, s = H.to(dt), v.to(dt), scale.to(dt)[:, None]
        cur = vd
        for _ in range(depth):
            cur = vd + cur - torch.einsum("tij,tj->ti", Hd, cur) / s
        scores = torch.einsum("tpd,td->tp", per_ex.to(dt), cur / s) / n.to(
            dt)[:, None]
        out.append(scores[mask].double().cpu().numpy())  # query order
    return out[0], out[1], {"scale": [float(scale.min()), float(scale.max())],
                            "shift_max": float(shift.max())}


def hold_float32_slack(got, exact, plain32, counts, rtol: float,
                       atol: float, what: str, excuse=None) -> dict:
    """Scores ``got`` against their float64 computation ``exact``: each
    within ``rtol`` / ``atol``, plus a per-query slack of twice the plain
    float32 computation's own distance from float64 on that query
    (``plain32``: the same formula on the same operands in float32).
    ``excuse(rows)`` (NCF), on the packed numbers of the rows that either
    float32 version puts beyond the bar, says which lie on a relu
    boundary: those pass, are counted, and are left out of the slack.

    Used for LiSSA's scores against the float64 recursion (phase 6), and
    for the score kernels at RQ2's widths k >= 64 (7d), whose 64..256-term
    dots (MF) and 128..512-term dots (NCF) end many ulps apart in two
    float32 orders on scores that are small by cancellation (MF at
    k = 128: kernel and plain 1.48e-6 apart on a score whose bar was
    1.0e-6, H100 80GB HBM3 at 700 W), as phase 3 found for NCF.

    Why the slack, for LiSSA (float64 argument): 10,000 float32 steps round the
    running sum to ~1e-6 of the iHVP's norm, and that error reaches every
    score of the query through one dot product as an ABSOLUTE error, so
    a score that is small by cancellation misses a relative bar whatever
    float32 recursion computes it: the plain float32 recursion, which
    shares nothing with the port but the matrices, misses it on the same
    scores by the same amounts (measured on an H100 at ML-1M shape, 32
    queries: 1 (MF) and 6 (NCF) of 8,147 scores miss the elementwise
    bar, the same ones for both, and the port is 7.3e-7 / 1.8e-7 from
    the plain float32 recursion). The slack is that measured float32
    error, and it must itself stay within ``rtol`` of the query's
    largest score, so it cannot hide a wrong HVP, scale or shift.
    """
    off = np.concatenate([[0], np.cumsum(counts)])
    beyond = beyond32 = slack_max = excused = 0
    max_abs = 0.0  # over the rows not excused
    for t in range(len(counts)):
        a, b, c = (x[off[t]:off[t + 1]] for x in (got, exact, plain32))
        if not len(a):
            continue
        bar = atol + rtol * np.abs(b)
        keep = np.ones(len(a), bool)
        if excuse is not None:
            rows = np.flatnonzero((np.abs(a - b) > bar) | (np.abs(c - b) > bar))
            if len(rows):
                edge = excuse(off[t] + rows)
                keep[rows[edge]] = False
                excused += int(edge.sum())
        slack = 2.0 * float(np.max(np.abs(c - b)[keep], initial=0.0))
        check(slack <= rtol * float(np.max(np.abs(b))) + atol,
              f"{what}: the plain float32 version itself is {slack / 2:.3e} "
              f"from float64 on query {t}, beyond rtol {rtol} of its "
              "largest score")
        err = np.abs(a - b)
        out = int(np.sum((err > bar + slack) & keep))
        check(out == 0,
              f"{what}: query {t}: {out} scores beyond rtol {rtol} atol "
              f"{atol} plus the float32 slack {slack:.3e} of float64 (max "
              f"abs err {float(err[keep].max()):.3e})")
        max_abs = max(max_abs, float(np.max(err[keep], initial=0.0)))
        beyond += int(np.sum(err > bar))
        beyond32 += int(np.sum(np.abs(c - b) > bar))
        slack_max = max(slack_max, slack / max(float(np.max(np.abs(b))),
                                                1e-30))
    return {"scores": int(got.size), "max_abs_err": max_abs,
            "max_abs_err_float32_recursion": float(np.abs(plain32 - exact)
                                                   .max()),
            "max_abs_err_vs_float32_recursion": float(np.abs(got - plain32)
                                                      .max()),
            "beyond_elementwise_bar": beyond,
            "float32_recursion_beyond_elementwise_bar": beyond32,
            "max_slack_share_of_largest_score": slack_max,
            "boundary_rows": excused}


def query_walls(eng, pts, n: int) -> tuple[list, list]:
    """Host seconds of ``n`` back-to-back ``query_batch`` calls (each
    returns host arrays, so each ends synchronised) and their results."""
    walls, results = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        results.append(eng.query_batch(pts))
        walls.append(time.perf_counter() - t0)
    return walls, results


def rank_agreement(res, ref) -> dict:
    """Per-query Spearman of ``res`` against ``ref``: min and median."""
    rhos = [spearman(res.scores_of(t), ref.scores_of(t))
            for t in range(len(res.counts))
            if res.counts[t] > 1 and np.ptp(res.scores_of(t)) > 0
            and np.ptp(ref.scores_of(t)) > 0]
    return {"min_spearman": float(min(rhos)),
            "median_spearman": float(np.median(rhos))}


def same_bytes(a, b, what: str) -> None:
    """Counts, packed scores, iHVPs and test vectors the same bits."""
    check(np.array_equal(a.counts, b.counts)
          and a._packed.tobytes() == b._packed.tobytes()
          and a.ihvp.tobytes() == b.ihvp.tobytes()
          and a.test_grad.tobytes() == b.test_grad.tobytes(),
          f"{what}: the two results differ bit for bit")


def padded_small(family: str, model) -> dict:
    """Every padded configuration (``SMALL_CONFIGS``) on the card against
    the port's CPU path, on phase 4's small input."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x[:21]
    out = {}
    for name, kw in SMALL_CONFIGS.items():
        card = engine(tm, tp, tiny["train"], damping=SMALL_DAMPING,
                               **kw)
        devices = spy_devices(card)
        on_card = card.query_batch(tq)
        on_cpu = engine(tm, tp, tiny["train"], damping=SMALL_DAMPING,
                                 device="cpu", **kw).query_batch(tq)
        what = f"{family} {name} card vs CPU (small)"
        check(card.solver == kw.get("solver", "direct"),
              f"{what}: the ladder escalated to {card.solver!r}")
        check(devices and set(devices) == {"cuda"},
              f"{what}: results computed on {set(devices)}")
        if "group_queries" in kw:
            check(on_card._packed is None
                  and np.array_equal(on_card.related_idx, on_cpu.related_idx)
                  and np.array_equal(on_card.related_mask,
                                     on_cpu.related_mask),
                  f"{what}: the dense views differ")
        out[name] = compare_results(on_card, on_cpu, what, PADDED_RTOL,
                                    PADDED_ATOL, PADDED_RHO)
        log(f"{what}: {out[name]}")
    return out


def drive_padded(family: str, eng, train, pts) -> dict:
    """Phase 6: the padded per-query program, each solver against the
    flat direct path on the same card, with its times."""
    T = PADDED_T
    q = pts[:T]
    flat = eng.query_batch(q)
    ops = operands(eng, pts, T)
    excuse = relu_excuse(family, ops)
    d = eng.model.block_size
    out = {"T": T}
    for m in KERNEL_MODULES.values():
        m.launches = 0
    for solver in PADDED_SOLVERS:
        p_eng = padded_engine(eng, train, solver)
        devices = spy_devices(p_eng)
        t0 = time.perf_counter()
        res = p_eng.query_batch(q)  # the warm-up
        first_s = time.perf_counter() - t0
        check(p_eng.solver == solver, f"{family} padded {solver}: the NaN "
              f"ladder escalated it to {p_eng.solver!r}")
        check(res.ihvp.shape == (T, d) and np.isfinite(res.ihvp).all(),
              f"{family} padded {solver}: iHVPs {res.ihvp.shape}, or "
              "non-finite")
        check(np.array_equal(res.counts, flat.counts)
              and all(np.array_equal(res.related_of(t), flat.related_of(t))
                      for t in range(T)),
              f"{family} padded {solver}: counts or related rows differ "
              "from the flat path's")
        row = {"first_call_ms": first_s * 1e3, "iterations": res.iterations}
        if solver == "lissa":
            lt = T if first_s <= LISSA_SLOW_S else min(T, LISSA_SMALL_T)
            walls, results = query_walls(p_eng, pts[:lt], 2)
            same_bytes(*results, f"{family} padded lissa")
            row["T"] = lt
            row["vs_flat_direct"] = rank_agreement(res, flat)  # recorded
            exact, plain32, tuning = lissa_recursions(
                p_eng, pts[:LISSA_GATE_Q], p_eng.lissa_depth)
            got = np.concatenate([res.scores_of(t)
                                  for t in range(LISSA_GATE_Q)])
            row["vs_float64_recursion"] = {
                "queries": LISSA_GATE_Q, **tuning,
                **hold_float32_slack(got, exact, plain32,
                                     res.counts[:LISSA_GATE_Q], PADDED_RTOL,
                                     PADDED_ATOL, "LiSSA gate")}
            # the HVP's trace, then the recursion alone on it, per step
            u, i, rel_x, rel_y, w = padded_rows(p_eng, pts[:lt])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hvp = HV.make_batched_block_hvp(p_eng.model, p_eng.params, u, i,
                                            rel_x, rel_y, w, DAMPING,
                                            linearize=True)
            torch.cuda.synchronize()
            row["hvp_trace_ms"] = (time.perf_counter() - t0) * 1e3
            v = torch.as_tensor(results[-1].test_grad, device=p_eng.device)

            def steps():
                return solvers.solve_lissa(
                    hvp, v, scale=100.0, recursion_depth=LISSA_TIMED_STEPS,
                    auto_scale=False)

            steps_ms = time_ms(steps, iters=1, warmup=1)
            row["ms_per_step"] = steps_ms / LISSA_TIMED_STEPS
            row["recursion_device"] = device_breakdown(steps, steps_ms)
            prof = padded_engine(eng, train, solver,
                                 lissa_depth=LISSA_PROFILE_DEPTH)
            pw, _ = query_walls(prof, pts[:lt], 2)
            row["device"] = {"lissa_depth": LISSA_PROFILE_DEPTH,
                             **device_breakdown(lambda: prof.query_batch(
                                 pts[:lt]), pw[-1] * 1e3)}
        else:
            walls, results = query_walls(p_eng, q, 3)
            same_bytes(res, results[-1], f"{family} padded {solver}")
            row["T"] = T
            row["vs_flat_direct"] = compare_results(
                res, flat, f"{family} padded {solver} vs flat direct",
                PADDED_RTOL, PADDED_ATOL, PADDED_RHO, excuse)
            row["device"] = device_breakdown(lambda: p_eng.query_batch(q),
                                             float(np.median(walls)) * 1e3)
        check(devices and set(devices) == {"cuda"},
              f"{family} padded {solver}: results computed on {set(devices)}")
        wall = float(np.median(walls))
        row["query_batch_ms"] = wall * 1e3
        row["query_batch_ms_runs"] = [x * 1e3 for x in walls]
        row["scores_per_s"] = int(results[-1].counts.sum()) / wall
        out[solver] = row
        log(f"{family} padded {solver}: {json.dumps(row, sort_keys=True)}")
    out["small_card_vs_cpu"] = padded_small(family, eng.model)
    launches = {SOURCES[f]: m.launches for f, m in KERNEL_MODULES.items()}
    check(not any(launches.values()), f"{family} padded path launched a "
          f"score kernel: {launches}")
    out["score_kernel_launches"] = launches
    return out


# -- phase 7: training, checkpoints, RQ1 and RQ2 ---------------------------
def close(got, want, rtol: float, atol: float, what: str) -> float:
    """Tensors (or dicts of them) ``got`` against ``want`` elementwise at
    ``rtol``/``atol``; returns the largest absolute difference."""
    if isinstance(want, dict):
        check(sorted(got) == sorted(want), f"{what}: keys differ")
        return max(close(got[k], want[k], rtol, atol, f"{what} {k}")
                   for k in sorted(want))
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} != "
          f"{tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} values beyond rtol "
          f"{rtol} atol {atol} (max abs err {float(diff.max()):.3e})")
    return float(diff.max()) if diff.numel() else 0.0


def train_small(family: str, cls) -> dict:
    """Phase 7a: the small input's fit (all three phases), retrain and
    leave-one-out lanes on the card against the same calls on the CPU,
    with the same schedules; and lane chunking on the card."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)["train"]
    x, y = tiny.x, tiny.y
    model = cls(60, 40, 8, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    w = np.ones(len(x), np.float32)
    w[11] = 0.0
    lo = TRAIN_SMALL_LOO
    out = {}
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        tr = Trainer(model, TrainConfig(**TRAIN_SMALL_FIT), device=dev)
        s = tr.fit(tr.init_state(params), x, y)
        fit_losses = tr.last_losses
        r = tr.retrain(s, x, y, weights=w, num_steps=20,
                       reset_adam=family == "mf")
        lanes = loo_retrain_many(model, params, x, y, np.asarray(lo["removed"]),
                                 lo["steps"], 200, 1e-2,
                                 seeds=np.asarray(lo["seeds"]), device=dev)
        out[side] = {"fit losses": fit_losses, "fit params": s.params,
                    "fit adam mu": s.opt_state.mu,
                    "retrain losses": tr.last_losses,
                    "retrain params": r.params, "lanes": lanes}
    errs = {name: close(out["card"][name], out["cpu"][name], TRAIN_RTOL,
                        TRAIN_ATOL, f"{family} 7a {name} card vs CPU")
            for name in out["cpu"]}
    whole = out["card"]["lanes"]
    chunk_err = 0.0
    for c in (0, 2):
        part = loo_retrain_many(model, params, x, y,
                                np.asarray(lo["removed"][c:c + 2]), lo["steps"],
                                200, 1e-2, seeds=np.asarray(lo["seeds"][c:c + 2]),
                                device=CARD)
        chunk_err = max(chunk_err, close(
            part, {k: v[c:c + 2] for k, v in whole.items()}, TRAIN_RTOL,
            TRAIN_ATOL, f"{family} 7a lane_chunk 2 vs 4 on the card"))
    errs["lane_chunk 2 vs 4 (card)"] = chunk_err
    log(f"{family} 7a training card vs CPU, max abs err: {errs}")
    return errs


def full_loss(model, params, x, y) -> float:
    with torch.no_grad():
        return float(model.loss(params, x, y))


def train_full(family: str, model, train, pts) -> tuple[dict, dict]:
    """Phase 7b: training at ML-1M shape through the three phases, timed
    a phase at a time; the device-busy share of a 200-step window; a
    checkpoint round trip; and the flat query on the trained weights,
    kernel against plain score stage. Returns the trained params and
    the phase's report."""
    dev = torch.device(CARD)
    x = torch.as_tensor(train.x).to(dev)
    y = torch.as_tensor(train.y).to(dev)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    rep = {"batch": FULL_BATCH, "learning_rate": TRAIN_LR,
           "steps": dict(FULL_STEPS), "loss_full_before": full_loss(
               model, params, x, y)}
    phase_cfgs = {
        "minibatch": {},
        "batch": {"iter_to_switch_to_batch": 0},
        "sgd": {"iter_to_switch_to_batch": 0, "iter_to_switch_to_sgd": 0},
    }
    state, losses, steps_per_s = None, [], {}
    for phase, extra in phase_cfgs.items():
        tr = Trainer(model, TrainConfig(FULL_BATCH, FULL_STEPS[phase],
                                        TRAIN_LR, seed=0, **extra))
        if state is None:
            state = tr.init_state(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.fit(state, x, y)
        torch.cuda.synchronize()
        steps_per_s[phase] = FULL_STEPS[phase] / (time.perf_counter() - t0)
        losses.append(tr.last_losses.cpu())
    losses = torch.cat(losses)
    check(bool(torch.isfinite(losses).all()), f"{family} 7b: non-finite loss")
    rep["steps_per_s"] = steps_per_s
    rep["first_step_loss"] = float(losses[0])
    rep["last_step_loss"] = float(losses[-1])
    rep["loss_full_after"] = full_loss(model, state.params, x, y)
    check(rep["loss_full_after"] < rep["loss_full_before"],
          f"{family} 7b: the training loss did not fall "
          f"({rep['loss_full_before']} -> {rep['loss_full_after']})")
    # a 200-step minibatch window: host wall, then its device time
    tr = Trainer(model, TrainConfig(FULL_BATCH, BUSY_WINDOW, TRAIN_LR, seed=0))
    tr.fit(state, x, y)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(state, x, y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rep["window"] = {"steps": BUSY_WINDOW, "wall_ms": wall_ms,
                     "ms_per_step": wall_ms / BUSY_WINDOW,
                     **device_breakdown(lambda: tr.fit(state, x, y), wall_ms)}
    # the checkpoint round trip through the rotated directory
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_rotated(d, state.params, state.opt_state, state.step)
        restored = checkpoint.restore_latest_valid(d, state.params,
                                                   state.opt_state,
                                                   verbose=False)
    check(restored is not None, f"{family} 7b: no checkpoint restored")
    p, o, step = restored
    check(step == state.step and all(
        torch.equal(p[k], state.params[k]) for k in state.params) and all(
        torch.equal(a, b) for a, b in zip(checkpoint.leaves(o),
                                          checkpoint.leaves(state.opt_state))),
          f"{family} 7b: the restored checkpoint is not bitwise equal")
    rep["checkpoint"] = "bitwise equal"
    # the flat query on the trained weights: kernel against plain
    T = BATCHES[0]
    eng = engine(model, state.params, train, damping=DAMPING)
    plain = engine(model, state.params, train, damping=DAMPING,
                            kernel="torch", device=CARD)
    res, ref = eng.query_batch(pts[:T]), plain.query_batch(pts[:T])
    ops = operands(eng, pts, T)
    total = int(res.counts.sum())
    mod = KERNEL_MODULES[family]

    @functools.cache
    def exact():
        return mod.fused_scores_reference(
            *kernel_args(to64(ops)))[:total].cpu().numpy()

    rep["trained_parity"] = compare_results(
        res, ref, f"{family} 7b trained weights kernel vs plain", RTOL, ATOL,
        RHO_MIN, relu_excuse(family, ops), exact)
    log(f"{family} 7b: {json.dumps(rep, sort_keys=True)}")
    return state.params, rep


def drive_rq1(family: str, eng, train, pts) -> dict:
    """Phase 7c: ``test_retraining`` on held-out points with the trained
    weights; every lane finite and the score kernel launched for each
    point's query. The correlation is printed, not gated."""
    test = RatingDataset(pts[:RQ1_POINTS], np.zeros(RQ1_POINTS, np.float32))
    mod = KERNEL_MODULES[family]
    for m in (*KERNEL_MODULES.values(), kseg):
        m.launches = 0
    actual, predicted, points = [], [], []
    for i in range(RQ1_POINTS):
        before = mod.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = test_retraining(eng, train, test, i, num_to_remove=RQ1_REMOVE,
                              num_steps=RQ1_STEPS, batch_size=FULL_BATCH,
                              learning_rate=TRAIN_LR,
                              retrain_times=RQ1_TIMES,
                              lane_chunk=(RQ1_REMOVE + 1) * RQ1_TIMES,
                              verbose=False)
        secs = time.perf_counter() - t0
        lanes = res.per_repeat_y.size
        check(mod.launches - before >= 1, f"{family} 7c point {i}: the score "
              "kernel never launched")
        check(bool(np.isfinite(res.per_repeat_y).all()),
              f"{family} 7c point {i}: a retrained lane is not finite")
        actual.append(res.actual_y_diffs)
        predicted.append(res.predicted_y_diffs)
        points.append({"seconds": secs, "lanes": lanes,
                       "lane_steps_per_s": lanes * RQ1_STEPS / secs,
                       "bias_retrain": res.bias_retrain,
                       "pearson": metrics.pearson(res.actual_y_diffs,
                                                  res.predicted_y_diffs)})
    a, p = np.concatenate(actual), np.concatenate(predicted)
    rep = {"points": points, "steps": RQ1_STEPS, "removed": RQ1_REMOVE,
           "retrain_times": RQ1_TIMES, "pearson": metrics.pearson(a, p),
           "spearman": metrics.spearman(a, p),
           "score_kernel_launches": mod.launches,
           "segment_launches": kseg.launches,
           "graphs": graph_inventory(eng)}
    check(kseg.launches >= RQ1_POINTS, f"{family} 7c: the Hessian kernel "
          f"launched {kseg.launches} times for {RQ1_POINTS} points")
    log(f"{family} 7c RQ1: {json.dumps(rep, sort_keys=True)}")
    return rep


def dispatch_without_waits(eng) -> None:
    """Make ``eng._dispatch_flat`` fail on any host wait for the card
    (``torch.cuda.set_sync_debug_mode("error")``), so ``query_many``
    provably queues batch k + 1 before it fetches batch k."""
    dispatch = eng._dispatch_flat

    def checked(points, pad_to):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(points, pad_to)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng._dispatch_flat = checked


def same_bytes_stitched(parts, whole, what: str) -> None:
    """``query_many``'s batches ``parts`` against one result ``whole`` of
    the same queries: counts, related rows, and each query's scores, iHVP
    and test vector the same bits."""
    t = 0
    for part in parts:
        for j in range(len(part.counts)):
            check(part.counts[j] == whole.counts[t]
                  and np.array_equal(part.related_of(j), whole.related_of(t))
                  and part.scores_of(j).tobytes()
                  == whole.scores_of(t).tobytes()
                  and part.ihvp[j].tobytes() == whole.ihvp[t].tobytes()
                  and part.test_grad[j].tobytes()
                  == whole.test_grad[t].tobytes(),
                  f"{what}: query {t} differs from one dispatch")
            t += 1
    check(t == len(whole.counts), f"{what}: {t} queries, want "
          f"{len(whole.counts)}")


def stage_times(eng, pts, iters: int = 5) -> dict:
    """Device ms of each cumulative prefix of the flat program on
    ``pts`` (eager, CUDA events)."""
    _, tx, s_pad = eng._flat_inputs(pts)
    args = (eng.params, eng.train_x, eng.train_y, eng._postings, tx)
    out = {}
    for stage in STAGES:
        fn = eng._flat_fn(s_pad, stage)
        out[stage] = time_ms(lambda: fn(*args), iters=iters)
    return out


def graph_inventory(eng) -> dict:
    """The engine's captured flat programs: how many, and the memory each
    graph's pool holds."""
    pools = [p.pool_bytes for p in eng._programs.values()]
    return {"geometries": len(pools),
            "pool_mb": [round(b / 2 ** 20, 1) for b in pools],
            "capture_ms": [round(p.capture_s * 1e3, 1)
                           for p in eng._programs.values()]}


def drive_rq2(family: str, cls, train, pts) -> dict:
    """Phase 7d: RQ2's width sweep with seeded weights (a query's cost
    does not depend on training): ``time_influence_queries`` through
    ``query_batch`` and through ``query_many``. At each width the
    kernel's ``query_batch`` is held against the plain score stage's at
    the kernel's bar (at RQ2_FLOAT64_K, each of the two against float64
    with float32's own slack, :func:`hold_float32_slack`); each of
    ``query_many``'s batches must equal ``query_batch`` on the same
    queries bit for bit, its dispatches must not wait on the card, and
    the whole must equal one ``query_batch`` of all the queries bit for
    bit. Each width's flat stages are timed by cumulative prefix, and the
    geometries its engine captured are counted with their graphs'
    memory."""
    mod = KERNEL_MODULES[family]
    q = pts[:RQ2_Q]
    out = {}
    for k in RQ2_K:
        model = cls(USERS, ITEMS, k, WD)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=CARD)
        eng = engine(model, params, train, damping=DAMPING)
        plain = engine(model, params, train, damping=DAMPING,
                                kernel="torch", device=CARD)
        row = {}
        for name, bq in (("query_batch", None), ("query_many", RQ2_BATCH)):
            for m in (*KERNEL_MODULES.values(), kseg):
                m.launches = 0
            t = time_influence_queries(eng, q, repeats=3, batch_queries=bq)
            row[name] = {**t.json(), "times_s": t.times_s,
                         "compile_time_s": t.compile_time_s,
                         "score_kernel_launches": mod.launches,
                         "segment_launches": kseg.launches}
            check(mod.launches >= 1 and kseg.launches >= 1,
                  f"{family} 7d k={k} {name}: a kernel never launched "
                  f"(score {mod.launches}, Hessian {kseg.launches})")
        check(row["query_batch"]["num_scores"] == row["query_many"]["num_scores"],
              f"{family} 7d k={k}: query_many scored another row count")
        whole = eng.query_batch(q)
        ops = operands(eng, pts, RQ2_Q)
        total = int(whole.counts.sum())

        @functools.cache
        def exact(ops=ops, total=total):
            return mod.fused_scores_reference(
                *kernel_args(to64(ops)))[:total].cpu().numpy()

        excuse = relu_excuse(family, ops)
        ref = plain.query_batch(q)
        what = f"{family} 7d k={k} kernel vs plain"
        if k not in RQ2_FLOAT64_K:
            row["kernel_vs_plain"] = compare_results(
                whole, ref, what, RTOL, ATOL, RHO_MIN, excuse, exact)
        else:
            check(np.array_equal(whole.counts, ref.counts) and all(
                np.array_equal(whole.related_of(t), ref.related_of(t))
                for t in range(RQ2_Q)), f"{what}: rows differ")
            got = np.concatenate([whole.scores_of(t) for t in range(RQ2_Q)])
            plain32 = np.concatenate([ref.scores_of(t) for t in range(RQ2_Q)])
            row["kernel_vs_plain"] = {
                "vs_float64": True,
                "max_abs_err_vs_plain": float(np.abs(got - plain32).max()),
                **hold_float32_slack(got, exact(), plain32, whole.counts,
                                     RTOL, ATOL, what + " vs float64",
                                     excuse)}
        dispatch_without_waits(eng)
        parts = eng.query_many(q, batch_queries=RQ2_BATCH)
        for j, part in enumerate(parts):
            same_bytes(part, eng.query_batch(q[j * RQ2_BATCH:
                                               (j + 1) * RQ2_BATCH]),
                       f"{family} 7d k={k} query_many batch {j} vs "
                       "query_batch on the same queries")
        same_bytes_stitched(parts, whole, f"{family} 7d k={k} query_many "
                            f"({RQ2_BATCH} a batch) vs one query_batch")
        row["query_many_vs_query_batch"] = "bitwise equal"
        row["stage_ms_cumulative"] = stage_times(eng, q, iters=3)
        row["graphs"] = graph_inventory(eng)
        out[str(k)] = row
        log(f"{family} 7d RQ2 k={k}: per-query ms "
            f"{row['query_batch']['per_query_ms']:.4f} (query_batch) / "
            f"{row['query_many']['per_query_ms']:.4f} (query_many), "
            f"{row['query_batch']['scores_per_sec']:.0f} scores/s, launches "
            f"{row['query_batch']['score_kernel_launches']} / "
            f"{row['query_many']['score_kernel_launches']}, kernel vs plain "
            f"{row['kernel_vs_plain']}, query_many vs query_batch "
            f"{row['query_many_vs_query_batch']}, stages (ms, cumulative) "
            f"{row['stage_ms_cumulative']}, graphs {row['graphs']}")
        del eng, plain, params, model, ops, exact
        torch.cuda.empty_cache()
    return out


# -- the split-invariance probe ----------------------------------------
def flat_stage_outputs(eng, batch) -> dict:
    """Every stage's per-query output of one flat dispatch of ``batch``:
    ``{stage: [tensor of query j, ...]}`` for the query's g rows and e
    rows, H_t, v_t, ihvp_t, reg_dot_t and its scores (query-pad rows and
    flat pad rows dropped)."""
    counts, tx, s_pad = eng._flat_inputs(batch)
    T = len(counts)

    def run(stage):
        return eng._flat_fn(s_pad, stage)(eng.params, eng.train_x,
                                          eng.train_y, eng._postings, tx)

    g, e = run("grads")
    H = run("hessian")
    ihvp, v = run("solve")
    B = run("operands")[5]
    scores = run("scores")[0]
    d = eng.model.block_size
    off = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    rows = [slice(int(off[j]), int(off[j + 1])) for j in range(T)]
    return {
        "g": [g[r] for r in rows], "e": [e[r] for r in rows],
        "H": list(H[:T]), "v": list(v[:T]), "ihvp": list(ihvp[:T]),
        "reg_dot": list(B[:T, d]), "scores": [scores[r] for r in rows],
    }


PROBE_STAGES = ("g", "e", "H", "v", "ihvp", "reg_dot", "scores")


def probe_layouts(n: int, wide: bool):
    """``(name, [batch index arrays])`` of the probe: each batch a list of
    positions into the probe's point list, whose first ``n`` points are
    the queries compared. ``wide`` (RQ2's 64 queries): two halves, the
    reverse order, and the queries inside a 72-query batch (t_pad 128);
    else (256 queries): inside 1024 (t_pad 1024), behind 44 others
    (rows shifted, t_pad 320), batches of 100 (t_pad 128, 128, 64) and
    the reverse order."""
    q = np.arange(n)
    if wide:
        return [("halves", [q[: n // 2], q[n // 2:]]),
                ("reversed", [q[::-1]]),
                ("inside 72", [np.arange(72)])]
    return [("inside 1024", [np.arange(1024)]),
            ("shifted 44", [np.concatenate([np.arange(n, n + 44), q])]),
            ("batches of 100", [q[i: i + 100] for i in range(0, n, 100)]),
            ("reversed", [q[::-1]])]


def solve_isolated(H, v, n: int, batches) -> dict:
    """The batched LU alone: the first ``n`` systems of (H, v) solved at
    their own batch size and again inside batches of each size in
    ``batches`` (rolled to other positions, padded by repeating the last
    system); per batch size the count of systems whose solution differs
    by a bit, for the library's solve over the whole batch (``library``,
    recorded: it changes with the batch size on the card) and for the
    engine's, in pieces of ``QUERY_PIECE`` systems (``engine``)."""
    out = {}
    for name, solve in (("library", solvers.solve_direct),
                        ("engine", lambda Hb, vb: _in_pieces(
                            solvers.solve_direct, Hb, vb))):
        ref = solve(H[:n], v[:n])
        out[name] = {}
        for b in batches:
            m = min(n, b)
            sel = np.concatenate([np.arange(m), np.full(b - m, m - 1)])
            shift = b // 3
            x = torch.roll(solve(torch.roll(H[sel], shift, 0),
                                 torch.roll(v[sel], shift, 0)), -shift, 0)[:m]
            out[name][str(b)] = int(sum(not torch.equal(x[j], ref[j])
                                        for j in range(m)))
    return out


def probe_split(eng, pts, n: int, wide: bool, solve_batches) -> dict:
    """Module 1's probe on one engine: the first ``n`` of ``pts`` through
    one flat dispatch, then through each of :func:`probe_layouts`; per
    layout the count of queries whose output differs by a bit at each
    stage, and the first stage that differs; and the batched LU alone
    (:func:`solve_isolated`)."""
    ref = flat_stage_outputs(eng, pts[:n])
    out = {}
    for name, batches in probe_layouts(n, wide):
        got = {s: [None] * n for s in PROBE_STAGES}
        for idx in batches:
            outs = flat_stage_outputs(eng, pts[idx])
            for j, q in enumerate(idx):
                if q < n:
                    for s in PROBE_STAGES:
                        got[s][q] = outs[s][j]
            del outs
        diff = {s: int(sum(not torch.equal(got[s][q], ref[s][q])
                           for q in range(n))) for s in PROBE_STAGES}
        first = next((s for s in PROBE_STAGES if diff[s]), None)
        out[name] = {"first_differing_stage": first, "queries_differing": diff}
        del got
    H = torch.stack(ref["H"])
    v = torch.stack(ref["v"])
    out["solve_isolated"] = solve_isolated(H, v, n, solve_batches)
    return out


def probe(train, pts) -> dict:
    """The split-invariance probe for MF and NCF: at k = 16 on 256
    queries, and at RQ2's other widths on 64."""
    out = {}
    for family, cls in (("mf", MF), ("ncf", NCF)):
        for k in (K_EMB, *(k for k in RQ2_K if k != K_EMB)):
            wide = k != K_EMB
            model = cls(USERS, ITEMS, k, WD)
            params = model.init_params(torch.Generator().manual_seed(0),
                                       device=CARD)
            eng = engine(model, params, train, damping=DAMPING)
            row = probe_split(eng, pts, RQ2_Q if wide else BATCHES[0], wide,
                              (64, 128, 256) if wide else (64, 256, 1024))
            out[f"{family} k={k}"] = row
            log(f"probe {family} k={k}: {json.dumps(row, sort_keys=True)}")
            del eng, params, model
            torch.cuda.empty_cache()
    return out


# -- phase 8: the rest of the solver ladder ----------------------------------
def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, NaNs included."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def ladder_engine(eng, train, **kw) -> InfluenceEngine:
    """An engine on ``eng``'s model and weights at another rung."""
    kw.setdefault("damping", DAMPING)
    return engine(eng.model, eng.params, train, **kw)


def certificate_operands(samp, pts, T):
    """The certificate kernel's operands ``(g, t, ihvp, Cx, wv, ws, abe,
    e, off, m)`` of a T-query sampled dispatch, from the sampled
    program's "certificate" prefix."""
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
    return samp._flat_fn(s_pad, "certificate", mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)


def synthetic_certificate(counts, ms, S: int, d: int, gen: torch.Generator):
    """Certificate operands for segments of ``counts`` rows on an S-row
    axis (offsets clamped to S: a last segment past S is truncated; rows
    past the total are pad rows of no segment), ``ms[k]`` rows of segment
    k sampled at weight n/m, random rows and query vectors."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    T = counts.numel()
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).clamp(
        max=S)
    s = torch.arange(S)
    t = torch.searchsorted(off[1:T].contiguous(), s, right=True).to(
        torch.int32)
    wv = (s < off[-1]).to(torch.float32)
    ws = torch.zeros(S)
    for k, (n, m) in enumerate(zip(counts.tolist(), ms)):
        rows = int(off[k]) + torch.randperm(n, generator=gen)[:m]
        rows = rows[rows < S]
        ws[rows] = float(np.float32(n) / np.float32(max(m, 1)))
    g = torch.randn(S, d, generator=gen) * 0.3
    ihvp = torch.randn(T, d, generator=gen)
    cx = torch.randn(T, d, generator=gen) * 0.1
    e = torch.randn(S, generator=gen)
    abe = e * (torch.rand(S, generator=gen) < 0.05) * wv
    m = torch.as_tensor(ms, dtype=torch.int32)
    return tuple(x.to(CARD) for x in (g, t, ihvp, cx, wv, ws, abe, e, off,
                                      m))


def certificate_hold(got, ops, what: str) -> float:
    """The kernel's ``(sigma, gmax, wmax)`` against the plain version on
    the same operands: NaN where it is NaN, the same infinity where it is
    infinite, else within CERT_RTOL of it plus CERT_ATOL_REL of the
    output's largest finite entry. Returns the worst
    error as a share of that entry, and the worst absolute error."""
    want = kcert.segment_certificate_reference(*ops)
    worst, worst_abs = 0.0, 0.0
    for a, b, name in zip(got, want, ("sigma", "gmax", "wmax")):
        nan = torch.isnan(b)
        check(torch.equal(torch.isnan(a), nan),
              f"{what} {name}: NaN where the plain version is not, or not "
              "where it is")
        a, b = a[~nan].double(), b[~nan].double()
        inf = torch.isinf(b)
        check(torch.equal(a[inf], b[inf]), f"{what} {name}: an infinite "
              "entry differs from the plain version's")
        a, b = a[~inf], b[~inf]
        if not a.numel():
            continue
        scale = float(b.abs().max())
        diff = (a - b).abs()
        check(bool((diff <= CERT_RTOL * b.abs() + CERT_ATOL_REL * scale
                    ).all()),
              f"{what} {name}: beyond rtol {CERT_RTOL} / atol "
              f"{CERT_ATOL_REL} x max of the plain version (max abs err "
              f"{float(diff.max()):.3e})")
        worst = max(worst, float(diff.max()) / max(scale, 1e-30))
        worst_abs = max(worst_abs, float(diff.max()))
    return worst, worst_abs


def cert_launch_twice(ops):
    got = kcert.segment_certificate(*ops)
    again = kcert.segment_certificate(*ops)
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, again)),
          "segment_certificate: two launches on the same inputs differ")
    return got


def certificate_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for the certificate of ``ops``: every
    input the function needs read once (g and the four row vectors the
    kernel reads, over the rows inside segments only: pad rows past
    off[-1] belong to no query; ihvp and Cx, off, m), three (T,) outputs
    written; per row in a segment ~10 d operations (two dots and h, its
    masked sum), per sampled row ~8 d more (a dot, h and the squared
    deviation)."""
    g, t, ihvp, cx, wv, ws, abe, e, off, m = ops
    d = g.shape[1]
    T = off.numel() - 1
    lo, hi = int(off[0]), int(off[-1])
    rows = hi - lo
    sampled = int((ws[lo:hi] > 0).sum())
    nb = nbytes(*(x[lo:hi] for x in (g, wv, ws, abe, e)), ihvp, cx, off,
                m) + 3 * T * 4
    return bound(nb, rows * d * 10 + sampled * d * 8)


def check_certificate(family: str, samp, pts, gen) -> dict:
    """8a: the certificate kernel against its plain version on the card,
    on the sampled program's operands at every batch size and on
    synthetic segments (empty; m = 0; m = 1; m = n; m = cap < n; the
    longest related set; a segment truncated at the flat pad; pad rows
    past the last segment; a non-finite row that is not sampled)."""
    d = samp.model.block_size
    longest = samp.index.max_related_count()
    cap = samp.sampled_cap
    cases = [(f"main path T={T}", certificate_operands(samp, pts, T))
             for T in BATCHES]
    counts = [0, 37, 37, 50, 300, longest, 500]
    ms = [0, 0, 1, 50, cap, cap, cap]
    cases.append(("edges", synthetic_certificate(
        counts, ms, sum(counts) - 200, d, gen)))
    cases.append(("pad tail", synthetic_certificate(
        [3, 0, cap, cap + 1], [3, 0, cap, cap], 2 * cap + 104, d, gen)))
    nonfinite = synthetic_certificate([40, 40], [8, 8], 80, d, gen)
    unsampled = int(torch.nonzero(nonfinite[5][:40] == 0)[0])
    nonfinite[0][unsampled] = float("inf")
    cases.append(("inf on an unsampled row", nonfinite))
    worst, worst_abs = 0.0, 0.0
    for name, ops in cases:
        got = cert_launch_twice(ops)
        w, a = certificate_hold(got, ops,
                                f"segment_certificate {family} {name}")
        worst, worst_abs = max(worst, w), max(worst_abs, a)
        log(f"segment_certificate {family} [{name}] S={ops[0].shape[0]} "
            f"d={d} T={ops[8].numel() - 1}: two launches the same bits; vs "
            f"plain max err {w:.3e} of max |out|")
    sigma = kcert.segment_certificate(*nonfinite)[0]
    check(bool(torch.isnan(sigma[0])) and bool(torch.isfinite(sigma[1])),
          "segment_certificate: an inf on an unsampled row did not make "
          "its segment's sigma, and only its, NaN")
    ops = cases[len(BATCHES) - 1][1]
    ms_kernel = graph_ms(lambda: kcert.segment_certificate(*ops), iters=20)
    ms_plain = time_ms(lambda: kcert.segment_certificate_reference(*ops),
                       iters=3, warmup=1)
    b_ms, b_by = certificate_bound_ms(ops)
    out = {"max_err_of_max_abs": worst, "max_abs_err": worst_abs,
           "cases": len(cases),
           "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms_kernel,
           "shape": {"S": ops[0].shape[0], "d": d,
                     "T": ops[8].numel() - 1,
                     "sampled_rows": int((ops[5] > 0).sum())}}
    log(f"segment_certificate {family} T={BATCHES[-1]}: {ms_kernel:.4f} ms "
        f"(graph replay), plain {ms_plain:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {100 * b_ms / ms_kernel:.1f}% of bound")
    return out


def lower_float64(H: torch.Tensor) -> np.ndarray:
    """H's lower triangles mirrored, in float64 on the host (what
    eigvalsh reads)."""
    L = np.tril(H.double().cpu().numpy())
    return L + np.swapaxes(np.tril(L, -1), 1, 2)


def eigmin_hold(H: torch.Tensor, what: str, alone=None,
                gate: bool = True) -> dict:
    """8g on one batch of blocks: the kernel's λ_min bit for bit its
    plain version on the card (the same operations in the same order),
    and (where ``gate``) within EIG_C · d · eps · ‖H‖_F of float64
    eigvalsh; two launches the same bits; the blocks ``alone`` (default
    the first and last) the same bits in a batch of 1. Returns the
    largest c seen against float64, the ranges of λ_min and of the bar,
    and the first launch's ms (events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = keig.block_eigmin(H)
    end.record()
    again = keig.block_eigmin(H)
    torch.cuda.synchronize()
    check(bits_equal(got, again), f"{what}: two launches differ")
    T, d = H.shape[0], H.shape[-1]
    for j in sorted({0, T - 1} if alone is None else set(alone)):
        one = keig.block_eigmin(H[j: j + 1].contiguous())
        check(bits_equal(one, got[j: j + 1]), f"{what}: block {j} alone "
              f"differs from block {j} in the batch of {T}")
    plain = keig.block_eigmin_reference(H)
    check(bits_equal(got, plain), f"{what}: not bit for bit the plain "
          "version")
    exact = np.linalg.eigvalsh(lower_float64(H))[:, 0]
    g = got.double().cpu().numpy()
    diff = np.abs(g - plain.double().cpu().numpy())
    unit = eigmin_unit(H)
    c_exact = float(np.max(np.abs(g - exact) / unit, initial=0.0))
    if gate:
        check(c_exact <= EIG_C, f"{what}: beyond {EIG_C} d eps ||H||_F of "
              f"float64 eigvalsh (c = {c_exact:.3e})")
    return {"T": T, "d": d, "c_float64": c_exact, "gated": gate,
            "first_launch_ms": start.elapsed_time(end),
            "max_abs_err": float(np.max(diff, initial=0.0,
                                        where=~np.isnan(diff))),
            "lambda_min_range": [float(np.min(g)), float(np.max(g))],
            "bar_range": [float(EIG_C * unit.min()),
                          float(EIG_C * unit.max())]}


def eigmin_unit(H: torch.Tensor) -> np.ndarray:
    """(T,) d · eps · ‖H‖_F of each block, float64 on the host (the
    float64 bar's unit)."""
    T, d = H.shape[0], H.shape[-1]
    return d * EPS32 * np.linalg.norm(
        H.double().reshape(T, -1).cpu().numpy(), axis=1)


def eigmin_line(r: dict) -> str:
    """One case of :func:`eigmin_hold` for the log."""
    bar = f"bar c = {EIG_C}" if r["gated"] else f"below {EIG_REACH}: no bar"
    return (f"bit for bit the plain version; c = {r['c_float64']:.3e} "
            f"against float64 ({bar}); λ_min in "
            f"[{r['lambda_min_range'][0]:.3e}, {r['lambda_min_range'][1]:.3e}]"
            f", bar in [{r['bar_range'][0]:.3e}, {r['bar_range'][1]:.3e}]")


def sampled_hessians(samp, pts, T: int) -> torch.Tensor:
    """The damped H (T, d, d) of a T-query sampled dispatch, from the
    sampled program's "hessian" prefix."""
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
    return samp._flat_fn(s_pad, "hessian", mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)


def eigmin_bound_ms(H: torch.Tensor) -> tuple[float, str]:
    """Least time an H100 could take for λ_min of ``H``: the lower
    triangles read once (all the function reads) and T floats written,
    against one tridiagonalisation's 4 d³ / 3 flops a block."""
    T, d = H.shape[0], H.shape[-1]
    return bound(4 * T * d * (d + 1) // 2 + 4 * T, T * 4.0 * d ** 3 / 3.0)


def check_eigmin(family: str, samp, pts) -> dict:
    """8g on the main path: ``block_eigmin`` on the sampled program's H
    at every batch size (:func:`eigmin_hold`; at the largest, blocks 0,
    1, T/2 and T - 1 alone), then its ms by graph replay at each, and at
    the largest beside its bound, the plain version and the library call
    it replaced (``eigvalsh`` in pieces of 64, events)."""
    out = {"cases": {}, "ms": {}}
    for T in BATCHES:
        H = sampled_hessians(samp, pts, T)
        r = eigmin_hold(H, f"block_eigmin {family} main path T={T}",
                        alone=(0, 1, T // 2, T - 1))
        out["cases"][str(T)] = r
        out["ms"][str(T)] = graph_ms(lambda: keig.block_eigmin(H), iters=20)
        log(f"block_eigmin {family} [main path T={T}] d={r['d']}: two "
            f"launches the same bits, a block alone its bits in the batch; "
            f"{eigmin_line(r)}; {out['ms'][str(T)]:.4f} ms (graph replay)")
    ms = out["ms"][str(T)]
    b_ms, b_by = eigmin_bound_ms(H)
    out.update({
        "plain_ms": time_ms(lambda: keig.block_eigmin_reference(H), iters=1,
                            warmup=1),
        "library_ms": time_ms(lambda: _in_pieces(
            lambda h: torch.linalg.eigvalsh(h)[:, 0], H), iters=1, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
        "rounds": keig.ROUNDS, "points": keig.STURM_POINTS,
        "cluster_ctas": keig.cluster_size(H.shape[-1]),
        "scratch_mb": eigmin_scratch_mb(H, T),
        "max_abs_err": max(r["max_abs_err"] for r in out["cases"].values()),
        "c_max": max(r["c_float64"] for r in out["cases"].values()),
        "shape": {"T": T, "d": H.shape[-1]}})
    log(f"block_eigmin {family} T={T}: {ms:.4f} ms (graph replay), plain "
        f"{out['plain_ms']:.2f} ms, eigvalsh in pieces of 64 "
        f"{out['library_ms']:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / ms:.2f}% of bound; device-memory scratch "
        f"{out['scratch_mb']} MiB")
    return out


def eigmin_scratch_mb(H: torch.Tensor, T: int) -> float:
    """MiB of device memory one ``block_eigmin`` call on T blocks (``H``
    repeated) takes beyond its (T,) output: the peak allocated during the
    call, less what was allocated before it and the output's bytes
    (``torch.cuda.max_memory_allocated``). Checked 0: the kernel holds a
    block in shared memory and allocates nothing."""
    big = H.repeat(-(-T // H.shape[0]), 1, 1)[:T].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    lam = keig.block_eigmin(big)
    torch.cuda.synchronize()
    taken = (torch.cuda.max_memory_allocated() - before
             - lam.untyped_storage().nbytes())
    del big, lam
    mb = taken / 2 ** 20
    check(taken == 0, f"block_eigmin d={H.shape[-1]}: {mb:.3f} MiB of "
          f"device memory beyond its output at T={T}")
    return mb


def synthetic_blocks(kind: str, d: int, T: int, gen: torch.Generator
                     ) -> torch.Tensor:
    """(T, d, d) float32 blocks on the card: ``diagonal``; ``repeated``
    (eigenvalues 1, 2, 5, each d/3 times); ``indefinite`` ((W + Wᵀ)/2);
    ``floor`` (λ_min at DAMPING, the rest in [0.5, 2]); ``random`` (a
    Gauss-Newton sum of 64 rows plus DAMPING, as the sampled H)."""
    if kind == "diagonal":
        return torch.diag_embed(torch.randn(T, d, generator=gen)).to(CARD)
    if kind == "indefinite":
        W = torch.randn(T, d, d, generator=gen)
        return ((W + W.transpose(1, 2)) / 2).to(CARD)
    if kind == "random":
        G = torch.randn(T, 64, d, generator=gen, dtype=torch.float64) * 0.3
        H = G.transpose(1, 2) @ G * (2 / 64) + DAMPING * torch.eye(
            d, dtype=torch.float64)
        return H.float().to(CARD)
    Q = torch.linalg.qr(torch.randn(T, d, d, generator=gen,
                                    dtype=torch.float64))[0]
    if kind == "repeated":
        lam = torch.tensor([1.0, 2.0, 5.0],
                           dtype=torch.float64).repeat_interleave(
            -(-d // 3))[:d]
    else:  # floor
        lam = torch.cat([torch.tensor([DAMPING], dtype=torch.float64),
                         0.5 + 1.5 * torch.rand(d - 1, generator=gen,
                                                dtype=torch.float64)])
    return ((Q * lam) @ Q.transpose(1, 2)).float().to(CARD)


def check_eigmin_synthetic() -> dict:
    """8g on synthetic blocks (:func:`synthetic_blocks`), each kind at a
    main-path width, random blocks at d = 18 and 130 (one CTA a block),
    and EIG_WIDE_T random and diagonal blocks at each of EIG_WIDE_D (a
    thread-block cluster a block), and the damping-floor and indefinite
    kinds at d = 512: at each wide width the kernel's ms (events) below
    ``eigvalsh`` in pieces of 64 on the same blocks, its rounds, cluster
    size and resident clusters, and the device-memory scratch a call on
    BATCHES[-1] blocks takes (:func:`eigmin_scratch_mb`)."""
    gen = torch.Generator().manual_seed(9)
    cases = [("diagonal", 34, EIG_T), ("repeated", 64, EIG_T),
             ("indefinite", 64, EIG_T), ("floor", 34, EIG_T),
             ("random", 18, EIG_T), ("random", 130, EIG_T)]
    for d in EIG_WIDE_D:
        cases += [("random", d, EIG_WIDE_T), ("diagonal", d, EIG_WIDE_T)]
    cases += [("floor", 512, EIG_WIDE_T), ("indefinite", 512, EIG_WIDE_T)]
    out = {}
    for kind, d, T in cases:
        H = synthetic_blocks(kind, d, T, gen)
        name = f"{kind} d={d}"
        r = out[name] = eigmin_hold(H, f"block_eigmin [{name}]",
                                    alone=(0,) if d in EIG_WIDE_D else None)
        if kind == "diagonal":
            check(bits_equal(keig.block_eigmin(H),
                             torch.diagonal(H, dim1=1, dim2=2).amin(1)),
                  f"block_eigmin [{name}]: a diagonal block's λ_min is not "
                  "its smallest diagonal entry")
        if kind == "indefinite":
            check(bool((keig.block_eigmin(H) < 0).all()),
                  "block_eigmin: an indefinite block's λ_min is not < 0")
        wide = ""
        if d in EIG_WIDE_D and kind == "random":
            r.update({
                "ms": time_ms(lambda: keig.block_eigmin(H), iters=3,
                              warmup=1),
                "library_ms": time_ms(lambda: _in_pieces(
                    lambda h: torch.linalg.eigvalsh(h)[:, 0], H), iters=1,
                    warmup=1),
                "rounds": keig.ROUNDS, "points": keig.STURM_POINTS,
                "cluster_ctas": keig.cluster_size(d),
                "resident_clusters": keig.resident_clusters(d),
                "scratch_mb_at_T": {
                    str(BATCHES[-1]): eigmin_scratch_mb(H, BATCHES[-1])}})
            check(r["ms"] < r["library_ms"], f"block_eigmin [{name}]: "
                  f"{r['ms']:.2f} ms, not below eigvalsh in pieces of 64 "
                  f"({r['library_ms']:.2f} ms) on the same blocks")
            wide = (f"; {r['ms']:.3f} ms, eigvalsh in pieces of 64 "
                    f"{r['library_ms']:.1f} ms ({r['library_ms'] / r['ms']:.1f}"
                    f"x the kernel); {r['rounds']} rounds of "
                    f"{r['points']} points; {r['cluster_ctas']} CTA(s) a "
                    f"block, {r['resident_clusters']} clusters resident "
                    "(-1: no cluster); device-memory scratch "
                    f"{r['scratch_mb_at_T'][str(BATCHES[-1])]} MiB at "
                    f"T={BATCHES[-1]}")
        log(f"block_eigmin [{name}] T={T}: two launches the same bits, a "
            f"block alone its bits in the batch; {eigmin_line(r)}{wide}")
    return out


def check_eigmin_small() -> dict:
    """8g below the main path's widths: EIG_SMALL_T random and indefinite
    blocks at each of EIG_SMALL_D, held as :func:`eigmin_hold` holds a
    case, to the float64 bar from EIG_REACH up; c printed beside float32
    ``eigvalsh``'s on the same blocks, and the least width of the sweep
    from which every case met the bar."""
    gen = torch.Generator().manual_seed(10)
    out = {}
    for d in EIG_SMALL_D:
        for kind in ("random", "indefinite"):
            H = synthetic_blocks(kind, d, EIG_SMALL_T, gen)
            name = f"{kind} d={d}"
            r = out[name] = eigmin_hold(H, f"block_eigmin [{name}]",
                                        gate=d >= EIG_REACH)
            lib = torch.linalg.eigvalsh(H)[:, 0].double().cpu().numpy()
            exact = np.linalg.eigvalsh(lower_float64(H))[:, 0]
            r["c_eigvalsh_float32"] = float(np.max(
                np.abs(lib - exact) / eigmin_unit(H)))
            log(f"block_eigmin [{name}] T={EIG_SMALL_T}: two launches the "
                f"same bits, a block alone its bits in the batch; "
                f"{eigmin_line(r)}; float32 eigvalsh c = "
                f"{r['c_eigvalsh_float32']:.3e}")
    met = [all(out[f"{k} d={e}"]["c_float64"] <= EIG_C
               for k in ("random", "indefinite") for e in EIG_SMALL_D
               if e >= d) for d in EIG_SMALL_D]
    reach = next((d for d, m in zip(EIG_SMALL_D, met) if m), None)
    log(f"block_eigmin: the float64 bar c = {EIG_C} met at every width of "
        f"the sweep from d = {reach} up (gated from {EIG_REACH})")
    return {"cases": out, "bar_met_from_d": reach}


def drive_sampled_wide(train, pts) -> dict:
    """8h: the sampled rung (cap SAMPLED_CAP) at RQ2's upper widths
    (WIDE_RUNG) on WIDE_RUNG_T queries at ML-1M shape, seeded weights,
    beside direct on the same queries: wall ms (median of 5), busy share,
    ``block_eigmin``'s launches and share of the device time, each
    captured geometry's graph pool; every bound finite and >= 0; the
    rung's H on those queries held as 8g's (:func:`eigmin_hold`)."""
    out = {}
    q = pts[:WIDE_RUNG_T]
    for family, k in WIDE_RUNG:
        cls = {"mf": MF, "ncf": NCF}[family]
        model = cls(USERS, ITEMS, k, WD)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=CARD)
        direct = engine(model, params, train, damping=DAMPING)
        samp = engine(model, params, train, damping=DAMPING,
                               solver="sampled", sampled_cap=SAMPLED_CAP)
        reset_counts()
        res = samp.query_batch(q)
        launched = keig.launches
        check(launched > 0, f"{family} 8h k={k}: block_eigmin never launched")
        check(bool(np.isfinite(res.err_bound).all())
              and bool((res.err_bound >= 0).all()),
              f"{family} 8h k={k}: bounds {res.err_bound[:4]}...")
        H = sampled_hessians(samp, q, WIDE_RUNG_T)
        held = eigmin_hold(H, f"block_eigmin {family} 8h k={k} "
                           f"T={WIDE_RUNG_T}", alone=(0, WIDE_RUNG_T - 1))
        log(f"block_eigmin {family} [8h k={k}] d={held['d']} "
            f"T={WIDE_RUNG_T}: two launches the same bits, a block alone "
            f"its bits in the batch; {eigmin_line(held)}")
        del H
        ms = wall_ms(lambda: samp.query_batch(q))
        ms_direct = wall_ms(lambda: direct.query_batch(q))
        dev = device_breakdown(lambda: samp.query_batch(q), ms,
                               match="eigmin_")
        row = out[f"{family} k={k}"] = {
            "d": model.block_size, "T": WIDE_RUNG_T, "ms": ms,
            "direct_ms": ms_direct, "busy_share": dev["busy_share"],
            "device_busy_ms": dev["device_busy_ms"],
            "eigmin_device_ms": dev["matched_ms"],
            "eigmin_share_of_device": dev["matched_ms"]
            / dev["device_busy_ms"],
            "eigmin_launches": launched, "eigmin_hold": held,
            "top_kernels": dev["top_kernels"],
            "graphs": graph_inventory(samp)}
        log(f"{family} 8h sampled rung k={k} (d={row['d']}), T={WIDE_RUNG_T}:"
            f" {ms:.2f} ms, direct {ms_direct:.2f} ms; busy share "
            f"{row['busy_share']:.2f}; block_eigmin {row['eigmin_device_ms']:.3f}"
            f" ms, {100 * row['eigmin_share_of_device']:.1f}% of the device "
            f"time; graphs {row['graphs']}")
        del direct, samp, params, model, res
        torch.cuda.empty_cache()
    return out


def check_segment_ht(family: str, samp, pts, gen) -> dict:
    """8b: ``segment_hessian`` on the sampled program's operands (weights
    wv·n/m) at every batch size, and on synthetic segments with weights
    n/m for m < n and for m = 1: bit for bit the plain pieced form and
    within the float64 bar (:func:`segment_hold`)."""
    d = samp.model.block_size
    cases = []
    for T in BATCHES:
        _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
        cases.append((f"main path T={T}", samp._flat_fn(
            s_pad, "segments", mode="sampled")(
            samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws,
            m)))
    P = kseg.piece_rows(d)
    for cap in (13, 1):
        counts = [0, 1, 37, P - 1, P + 1, 3 * P + 5, 500]
        g, t, wv, abe, off = synthetic_segments(counts, sum(counts) + 50, d,
                                                gen)
        ws = np.zeros(g.shape[0], np.float32)
        for k, n in enumerate(counts):
            mk = min(n, cap)
            rows = int(off[k]) + torch.randperm(n, generator=gen)[:mk]
            ws[rows.numpy()] = np.float32(n) / np.float32(max(mk, 1))
        cases.append((f"HT weights cap={cap}",
                      (g, t, wv * torch.as_tensor(ws).to(CARD), abe, off)))
    worst = 0.0
    for name, ops in cases:
        got = segment_launch_twice(ops)
        r = segment_hold(got, ops, f"segment_hessian {family} {name}")
        worst = max(worst, r["max_err_of_max_abs_H"])
        log(f"segment_hessian {family} [{name}] S={ops[0].shape[0]}: bit for "
            f"bit the pieced plain form under n/m weights; vs float64 {r}")
    return {"cases": len(cases), "max_err_of_max_abs_H": worst}


def reset_counts() -> None:
    for m in (*KERNEL_MODULES.values(), kseg, kcert, keig):
        m.launches = 0


def launch_counts() -> dict:
    return {name: m.launches for name, m in
            (*((SOURCES[f], m) for f, m in KERNEL_MODULES.items()),
             (SEGMENT_SOURCE, kseg), (CERT_SOURCE, kcert),
             (EIGMIN_SOURCE, keig))}


def host_waits(fn) -> int:
    """Host waits for the card during ``fn()``
    (``torch.cuda.set_sync_debug_mode("warn")``), the final fetch
    included."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn()`` ended by a synchronise, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sampled_small(family: str, model) -> dict:
    """The sampled rung at cap SAMPLED_CAP on phase 4's small input (about
    half its queries have more related rows than the cap, so their
    Hessians are HT-weighted samples): the card against the port's CPU
    path on the same samples, scores at phase 4's card-vs-CPU bar and
    bounds within SAMPLED_BOUND_RTOL."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x.astype(np.int64)
    kw = dict(damping=1e-3, solver="sampled", sampled_cap=SAMPLED_CAP)
    on_card = engine(tm, tp, tiny["train"], **kw).query_batch(tq)
    on_cpu = engine(tm, tp, tiny["train"], device="cpu", **kw
                             ).query_batch(tq)
    sampled = int((on_cpu.counts > SAMPLED_CAP).sum())
    check(sampled > 0 and bool((on_cpu.err_bound > 0).any()),
          f"{family} sampled, small input: no query was sampled")
    parity = compare_results(on_card, on_cpu, f"{family} sampled card vs "
                             "CPU (small)", CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    # each query's largest score error as a share of its largest |score|
    share = max((float(np.max(np.abs(on_card.scores_of(t)
                                     - on_cpu.scores_of(t))))
                 / float(np.max(np.abs(on_cpu.scores_of(t))))
                 for t in range(len(tq))
                 if on_cpu.counts[t] and np.any(on_cpu.scores_of(t))),
                default=0.0)
    check(share <= CPU_RTOL, f"{family} sampled card vs CPU (small): a "
          f"query's largest score error is {share:.3e} of its largest "
          f"|score|, want <= {CPU_RTOL}")
    a, b = on_card.err_bound.astype(np.float64), on_cpu.err_bound
    check(np.array_equal(a == 0, b == 0), f"{family} sampled card vs CPU "
          "(small): exact (bound 0) queries differ")
    rel = float(np.max(np.abs(a - b) / np.where(b > 0, b, 1.0)))
    check(rel <= SAMPLED_BOUND_RTOL, f"{family} sampled card vs CPU (small): "
          f"bounds differ by {rel:.3e} relative, want <= "
          f"{SAMPLED_BOUND_RTOL}")
    log(f"{family} sampled cap={SAMPLED_CAP}, small input ({sampled} of "
        f"{len(tq)} queries sampled): card vs CPU {parity}; scores within "
        f"{share:.3e} of each query's largest |score|; bounds within "
        f"{rel:.3e} relative")
    return {**parity, "sampled_queries": sampled, "bound_max_rel_err": rel,
            "max_err_of_query_max_abs": share}


def drive_sampled(family: str, eng, train, pts) -> dict:
    """8c: the sampled rung at cap SAMPLED_CAP, tol inf."""
    samp = ladder_engine(eng, train, solver="sampled",
                         sampled_cap=SAMPLED_CAP)
    reset_counts()
    res = {T: samp.query_batch(pts[:T]) for T in BATCHES}
    launches = launch_counts()
    for name in (SOURCES[family], SEGMENT_SOURCE, CERT_SOURCE,
                 EIGMIN_SOURCE):
        check(launches[name] > 0, f"the {family} sampled rung never "
              f"launched {name}")
    # a replayed graph is the eager program, bit for bit
    T0 = BATCHES[0]
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T0])
    eager = [o.cpu().numpy() for o in samp._flat_fn(s_pad, mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)]
    r0, total0 = res[T0], int(res[T0].counts.sum())
    check(r0._packed.tobytes() == eager[0][:total0].tobytes()
          and r0.ihvp.tobytes() == eager[1][:T0].tobytes()
          and r0.test_grad.tobytes() == eager[2][:T0].tobytes()
          and r0.err_bound.tobytes() == eager[3][:T0].tobytes(),
          f"{family} sampled: a replayed graph differs from the eager "
          "program")
    # no host wait while a dispatch is queued (the geometries are warm)
    enqueue = samp._enqueue_sampled

    def checked(points):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enqueue(points)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    samp._enqueue_sampled = checked
    try:
        for T in BATCHES:
            got = samp.query_batch(pts[:T])
            check(got._packed.tobytes() == res[T]._packed.tobytes()
                  and got.err_bound.tobytes() == res[T].err_bound.tobytes(),
                  f"{family} sampled T={T}: a dispatch under sync debug "
                  "mode differs")
    finally:
        del samp._enqueue_sampled
    check(not samp.sampled_stats()["escalations"], f"{family} sampled: "
          f"escalations {samp.sampled_stats()['escalations']}")
    log(f"{family} sampled: a replayed graph bitwise the eager program "
        f"(T={T0}); no host wait while a dispatch is queued "
        f"(set_sync_debug_mode('error'), T={BATCHES}); captured geometries "
        f"{len(samp.compiled_geometries()['jit'])}")
    # memory: each sampled geometry's graph pool (held for the engine's
    # life) beside the eager program's peak on the same batch (what the
    # uncaptured program took at once, then gave back to the allocator)
    eager_peak_mb = {}
    for T in BATCHES:
        _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = samp._flat_fn(s_pad, mode="sampled")(
            samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)
        torch.cuda.synchronize()
        eager_peak_mb[str(T)] = (torch.cuda.max_memory_allocated()
                                 - base) / 2 ** 20
        del outs
    graphs = graph_inventory(samp)
    log(f"{family} sampled graphs: pools {graphs['pool_mb']} MiB "
        f"({sum(graphs['pool_mb']):.1f} in all) for {graphs['geometries']} "
        f"geometries; the eager program's peak "
        f"{ {k: round(v, 1) for k, v in eager_peak_mb.items()} } MiB")
    direct = {T: eng.query_batch(pts[:T]) for T in BATCHES}
    T = BATCHES[-1]
    r, dr = res[T], direct[T]
    check(r.approx and r.err_bound.shape == (T,)
          and bool(np.isfinite(r.err_bound).all())
          and bool((r.err_bound >= 0).all()),
          f"{family} sampled: bounds {r.err_bound[:4]}...")
    ok = np.array([
        float(np.max(np.abs(r.scores_of(t) - dr.scores_of(t)), initial=0.0))
        <= float(r.err_bound[t]) + 1e-6 for t in range(T)])
    share = float(ok.mean())
    check(share >= FIDELITY_SHARE, f"{family} sampled: |sampled - direct| "
          f"<= err_bound + 1e-6 on {share:.4f} of {T} queries, want >= "
          f"{FIDELITY_SHARE}")
    # at these random weights λ_min sits at the damping floor, so the
    # bound is loose and the gate above says little: print a query's
    # typical largest |score| beside it
    typical = float(np.median([np.abs(dr.scores_of(t)).max(initial=0.0)
                               for t in range(T)]))
    log(f"{family} sampled cap={SAMPLED_CAP}: |sampled - direct| within the "
        f"bound on {share:.4f} of {T} queries; bound median "
        f"{float(np.median(r.err_bound)):.3e}, max "
        f"{float(r.err_bound.max()):.3e} (a query's largest |score|: "
        f"median {typical:.3e}); launches {launches}")
    small = sampled_small(family, eng.model)
    # at a cap above every count the rung is the direct path, bound 0
    T0 = BATCHES[0]
    full = ladder_engine(eng, train, solver="sampled", sampled_cap=10 ** 6)
    ex = full.query_batch(pts[:T0])
    check(ex._packed.tobytes() == direct[T0]._packed.tobytes()
          and ex.ihvp.tobytes() == direct[T0].ihvp.tobytes()
          and bool((ex.err_bound == 0.0).all()),
          f"{family} sampled at cap 1e6: not bitwise the direct path with "
          "bounds 0")
    log(f"{family} sampled at cap 1e6, T={T0}: bitwise the direct path, "
        "every bound exactly 0")
    # any split: every query's scores and bound the same bits
    for bq in SAMPLED_SPLITS:
        parts = samp.query_many(pts[:T], batch_queries=bq)
        same_bytes_stitched(parts, r, f"{family} sampled query_many({bq})")
        check(np.concatenate([p.err_bound for p in parts]).tobytes()
              == r.err_bound.tobytes(), f"{family} sampled query_many({bq}): "
              "bounds differ from one dispatch")
    log(f"{family} sampled: query_many at {SAMPLED_SPLITS} bitwise one "
        "dispatch, scores and bounds")
    # escalation: tol at the median bound of ESCALATE_T queries
    q = pts[:ESCALATE_T]
    eb = r.err_bound[:ESCALATE_T]
    tol = float(np.median(eb))
    over, keep = np.flatnonzero(eb > tol), np.flatnonzero(eb <= tol)
    esc = ladder_engine(eng, train, solver="sampled", sampled_cap=SAMPLED_CAP,
                        sampled_tol=tol, lissa_depth=ESCALATE_DEPTH)
    got = esc.query_batch(q)
    lissa = ladder_engine(eng, train, solver="lissa",
                          lissa_depth=ESCALATE_DEPTH).query_batch(q[over])
    for k, t in enumerate(over):
        check(got.scores_of(int(t)).tobytes() == lissa.scores_of(k).tobytes()
              and got.err_bound[t] == 0.0,
              f"{family} sampled escalation: query {t} not the lissa rung's")
    for t in keep:
        check(got.scores_of(int(t)).tobytes() == r.scores_of(int(t)).tobytes()
              and got.err_bound[t] == r.err_bound[t],
              f"{family} sampled escalation: kept query {t} changed")
    check(esc.sampled_stats()["escalations"] == {"tolerance": len(over)},
          f"{family} sampled escalation counts {esc.sampled_stats()}")
    log(f"{family} sampled tol={tol:.3e} on {ESCALATE_T} queries: "
        f"{len(over)} escalated to lissa (depth {ESCALATE_DEPTH}), each in "
        "its place, the rest unchanged")
    # times, beside direct in the same run
    times = {}
    for T in BATCHES:
        q = pts[:T]
        ms = wall_ms(lambda: samp.query_batch(q))
        ms_direct = wall_ms(lambda: eng.query_batch(q))
        total = int(res[T].counts.sum())
        times[str(T)] = {
            "ms": ms, "scores_per_s": total / ms * 1e3,
            "direct_ms": ms_direct,
            "direct_scores_per_s": total / ms_direct * 1e3,
            "device": device_breakdown(lambda: samp.query_batch(q), ms),
            "host_waits": host_waits(lambda: samp.query_batch(q)),
        }
        log(f"{family} sampled T={T}: {ms:.2f} ms ({total / ms:.0f} k "
            f"scores/s), direct {ms_direct:.2f} ms; busy share "
            f"{times[str(T)]['device']['busy_share']:.2f}; host waits "
            f"{times[str(T)]['host_waits']}")
    counts = samp.index.counts_batch(pts[:T])
    s_pad = samp._s_pad_for(int(counts.sum()))
    t0 = time.perf_counter()
    sampled_mod.sample_weights(pts[:T], counts, s_pad, SAMPLED_CAP)
    sw_ms = (time.perf_counter() - t0) * 1e3
    log(f"{family} sample_weights on the host, T={T}: {sw_ms:.2f} ms")
    return {"launches": launches, "fidelity_share": share,
            "replay_vs_eager": "bitwise equal",
            "host_waits_while_queued": 0,
            "bound_median": float(np.median(r.err_bound)),
            "typical_max_abs_score": typical, "small_card_vs_cpu": small,
            "escalated": int(len(over)), "times": times,
            "sample_weights_host_ms": sw_ms, "graphs": graphs,
            "eager_peak_mb": eager_peak_mb}


def library_times(eng, H, v) -> dict:
    """The ladder's library calls at T = 1024 by CUDA events: the bank's
    batched Cholesky (``cholesky_ex``) and ``eigh`` of ``factorize``, the
    bank hit's solve (two triangular solves and a matvec, in pieces of
    64), and the sampled rung's ``eigvalsh`` in pieces of 64."""
    Hc = H.contiguous()
    L = torch.linalg.cholesky_ex(Hc)[0]
    kind = torch.zeros(Hc.shape[0], dtype=torch.int32, device=CARD)
    return {
        "cholesky_ex_ms": time_ms(lambda: torch.linalg.cholesky_ex(Hc),
                                  iters=5),
        "eigh_ms": time_ms(lambda: torch.linalg.eigh(Hc), iters=1,
                           warmup=1),
        "bank_solve_ms": time_ms(lambda: _in_pieces(_bank_solve, L, kind, v),
                                 iters=5),
        "eigvalsh_pieces_ms": time_ms(lambda: _in_pieces(
            lambda h: torch.linalg.eigvalsh(h)[:, 0], Hc), iters=1, warmup=1),
    }


def drive_bank(family: str, eng, train, pts, workdir: str) -> dict:
    """8d: a bank of BANK_ENTRIES hot pairs built, published and loaded;
    hits against direct, misses bitwise direct, a hit alone and in the
    batch, all-hit batches timed beside direct, and a surgical refresh."""
    name = f"smoke-{family}"
    builder = ladder_engine(eng, train, cache_dir=workdir, model_name=name)
    pairs = fbank.select_hot_pairs(builder.index, BANK_ENTRIES)
    reset_counts()
    t0 = time.perf_counter()
    bank = fbank.build_bank(builder, pairs, batch_queries=512)
    build_s = time.perf_counter() - t0
    build_launches = launch_counts()
    check(build_launches[SEGMENT_SOURCE] > 0, f"{family} bank build never "
          f"launched {SEGMENT_SOURCE}")
    path = builder.factor_bank_path()
    fbank.publish_bank(bank, path, fbank.bank_fingerprint(
        name, eng.model.block_size, DAMPING, *builder._train_host))
    kinds = {"cholesky": int((bank.kind == fbank.KIND_CHOLESKY).sum()),
             "inverse": int((bank.kind == fbank.KIND_INVERSE).sum())}
    log(f"{family} bank: {len(bank)} entries built in {build_s:.2f} s "
        f"({kinds}), {bank.factor.nbytes / 1e6:.1f} MB")
    # the hot blocks for the library calls' times, taken now: the eager
    # Hessian of 512 hot queries (~10M rows) needs several GB, which the
    # graphs captured below for the all-hit batches hold later
    H_hot = builder.block_hessians(bank.pairs[:BATCHES[-1]].astype(np.int64),
                                   batch_queries=512)
    # misses fall through the sampled rung at a cap above every count:
    # bitwise the direct path
    pre = ladder_engine(eng, train, solver="precomputed", cache_dir=workdir,
                        model_name=name, sampled_cap=10 ** 6)
    check(pre.ensure_factor_bank() == len(bank)
          and pre.bank_stats()["dropped_stale"] == 0,
          f"{family} bank: loaded {pre.bank_stats()}")
    half = BANK_T // 2
    banked = {tuple(p) for p in bank.pairs.tolist()}
    misses = np.asarray([p for p in pts.tolist() if tuple(p) not in banked]
                        [:half], np.int64)
    hits = bank.pairs[:half].astype(np.int64)
    mixed = np.empty((2 * half, 2), np.int64)
    mixed[0::2], mixed[1::2] = hits, misses
    reset_counts()
    res = pre.query_batch(mixed)
    bank_launches = launch_counts()
    check(bank_launches[SOURCES[family]] > 0, f"{family} bank hits never "
          f"launched {SOURCES[family]}")
    check(pre.bank_stats()["hits"] == half
          and pre.bank_stats()["misses"] == half,
          f"{family} bank: {pre.bank_stats()}")
    ref = eng.query_batch(mixed)
    worst_rho, worst_rel = 1.0, 0.0
    for t in range(len(mixed)):
        a, b = res.scores_of(t), ref.scores_of(t)
        if t % 2:
            check(a.tobytes() == b.tobytes(), f"{family} bank miss {t} not "
                  "bitwise the direct path")
            continue
        check(bool(np.isfinite(a).all()), f"{family} bank hit {t}: non-finite")
        if len(a):
            worst_rel = max(worst_rel, float(np.max(np.abs(a - b)))
                            / max(float(np.max(np.abs(b))), 1e-30))
        if len(a) > 1 and np.ptp(a) > 0 and np.ptp(b) > 0:
            worst_rho = min(worst_rho, spearman(a, b))
    check(worst_rho >= BANK_RHO, f"{family} bank hits: Spearman "
          f"{worst_rho} < {BANK_RHO} against direct")
    for t in (0, 2, 4):
        solo = pre.query_batch(mixed[t:t + 1])
        check(solo.scores_of(0).tobytes() == res.scores_of(t).tobytes(),
              f"{family} bank hit {t}: alone differs from in the batch")
    log(f"{family} bank on {2 * half} queries (half hits): hits' Spearman "
        f">= {worst_rho:.6f} against direct (largest score difference "
        f"{worst_rel:.3e} of the query's largest |score|); misses bitwise "
        f"direct; a hit alone "
        f"the same bits as in the batch; launches {bank_launches}")
    # the mixed batch timed at the default sampled_cap (a miss then takes
    # the sampled rung, eigvalsh and all) and at cap 1e6, beside direct
    dflt = ladder_engine(eng, train, solver="precomputed", cache_dir=workdir,
                         model_name=name)
    check(dflt.sampled_cap == sampled_mod.DEFAULT_CAP
          and dflt.ensure_factor_bank() == len(bank),
          f"{family} bank at the default cap: {dflt.bank_stats()}")
    mixed_ms = {"default_cap": wall_ms(lambda: dflt.query_batch(mixed)),
                "cap_1e6": wall_ms(lambda: pre.query_batch(mixed)),
                "direct": wall_ms(lambda: eng.query_batch(mixed))}
    log(f"{family} bank mixed T={len(mixed)} (half misses): "
        f"{mixed_ms['default_cap']:.2f} ms at the default cap "
        f"{sampled_mod.DEFAULT_CAP}, {mixed_ms['cap_1e6']:.2f} ms at cap "
        f"1e6, direct {mixed_ms['direct']:.2f} ms")
    # the sampled graphs each precomputed engine's miss delegate holds
    miss_graphs = {"default_cap": graph_inventory(dflt._miss_delegate()),
                   "cap_1e6": graph_inventory(pre._miss_delegate())}
    log(f"{family} bank miss delegates' sampled graphs: {miss_graphs}")
    times = {"mixed": mixed_ms, "miss_delegate_graphs": miss_graphs}
    hot = bank.pairs.astype(np.int64)
    for T in BATCHES:
        q = hot[:T]
        ms = wall_ms(lambda: pre.query_batch(q))
        ms_direct = wall_ms(lambda: eng.query_batch(q))
        total = int(pre.index.counts_batch(q).sum())
        times[str(T)] = {"ms": ms, "direct_ms": ms_direct, "rows": total,
                         "device": device_breakdown(
                             lambda: pre.query_batch(q), ms)}
        log(f"{family} bank all-hit T={T} ({total} rows): {ms:.2f} ms, "
            f"direct {ms_direct:.2f} ms")
    # surgical refresh: one user's row moves. A hot user rated every hot
    # item, which touches every entry, so the user is the least active
    # one who rated some banked item but not all of them
    x = builder._train_host[0]
    items = np.unique(bank.pairs[:, 1])
    deg = builder.index.user_degrees()
    u0 = next(int(u) for u in np.argsort(deg, kind="stable") if deg[u] and
              0 < np.isin(x[builder.index.rows_of_user(int(u)), 1],
                          items).sum() < len(items))
    table = "P" if family == "mf" else "P_mlp"
    host = {k: v.detach().cpu().numpy().copy()
            for k, v in eng.params.items()}
    host[table][u0] += 0.125
    stale = np.asarray([
        u == u0 or u0 in x[builder.index.rows_of_item(i), 0]
        for u, i in bank.pairs.tolist()])
    check(0 < stale.sum() < len(bank), f"{family} bank refresh: user {u0} "
          f"touches {int(stale.sum())} of {len(bank)} entries")
    out = fbank.refresh_bank(eng.model, host, *builder._train_host,
                             builder.index, DAMPING, path, name)
    check(out == {"kept": int((~stale).sum()), "dropped": int(stale.sum())},
          f"{family} bank refresh {out}, want dropped {int(stale.sum())}")
    log(f"{family} bank refresh after user {u0}'s row moved: {out}")
    Hd = torch.as_tensor(H_hot).to(CARD)
    v = torch.randn(Hd.shape[0], Hd.shape[1], device=CARD)
    lib = library_times(eng, Hd, v)
    log(f"{family} library calls at T={Hd.shape[0]}: {lib}")
    return {"entries": len(bank), "kinds": kinds, "build_s": build_s,
            "mb": bank.factor.nbytes / 1e6, "hit_spearman_min": worst_rho,
            "hit_max_rel_diff": worst_rel, "times": times,
            "refresh": out, "launches": bank_launches,
            "build_launches": build_launches, "library_ms": lib}


def drive_full(train, pts) -> dict:
    """8e: ``FullInfluenceEngine`` on MF k = 16 at ML-1M shape (CG,
    maxiter FULL_MAXITER, two test points): ms an HVP, iterations and the
    relative residual; on phase 4's small input, the card against the
    port's CPU path."""
    model = MF(USERS, ITEMS, K_EMB, WD)
    params = model.init_params(torch.Generator().manual_seed(0), device=CARD)
    full = FullInfluenceEngine(model, params, train, damping=DAMPING,
                               solver="cg", cg_maxiter=FULL_MAXITER)
    tx = pts[:2].astype(np.int32)
    ty = np.ones(2, np.float32) * 3.0
    v = full.test_loss_grad(tx, ty)
    hvp_ms = time_ms(lambda: full._hvp(v), iters=5)
    t0 = time.perf_counter()
    scores = full.get_influence_on_test_loss(tx, ty)
    wall_s = time.perf_counter() - t0
    x = full.get_inverse_hvp(v)
    rr = full.relative_residual(v, x)
    check(scores.shape == (ROWS,) and bool(np.isfinite(scores).all()),
          f"full engine: scores {scores.shape}")
    log(f"full engine MF k={K_EMB}: {hvp_ms:.2f} ms an HVP, CG "
        f"{full.last_iterations} iterations, relative residual {rr:.3e}, "
        f"influence of {ROWS} rows in {wall_s:.2f} s")
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = MF(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    kw = dict(damping=FULL_SMALL_DAMPING, solver="cg", cg_tol=1e-12,
              cg_maxiter=300)
    tq, tyy = tiny["test"].x[:2], tiny["test"].y[:2]
    card = FullInfluenceEngine(tm, tp, tiny["train"], **kw
                               ).get_influence_on_test_loss(tq, tyy)
    cpu = FullInfluenceEngine(tm, tp, tiny["train"], device="cpu", **kw
                              ).get_influence_on_test_loss(tq, tyy)
    err = float(np.max(np.abs(card - cpu)) / np.max(np.abs(cpu)))
    check(np.allclose(card, cpu, rtol=FULL_RTOL,
                      atol=FULL_RTOL * np.abs(cpu).max()),
          f"full engine: card vs CPU beyond rtol {FULL_RTOL} (max err "
          f"{err:.3e} of max |score|)")
    log(f"full engine, small input: card vs CPU within rtol {FULL_RTOL} "
        f"(max err {err:.3e} of max |score|)")
    return {"hvp_ms": hvp_ms, "iterations": full.last_iterations,
            "relative_residual": rr, "influence_s": wall_s,
            "small_card_vs_cpu_err": err}


def drive_facade(workdir: str) -> dict:
    """8f: ``FIAModel`` on phase 4's small input, trained a few steps on
    the card; its influence bitwise the engine's."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    fia = FIAModel(model="MF", num_users=60, num_items=40, embedding_size=8,
                   weight_decay=1e-3, batch_size=200, data_sets=tiny,
                   initial_learning_rate=1e-2, damping=1e-3,
                   train_dir=workdir, model_name="smoke-facade")
    fia.train(num_steps=FACADE_STEPS, verbose=False)
    got = fia.get_influence_on_test_loss([0])
    eng = engine(fia.model, fia.params, tiny["train"], damping=1e-3)
    want = eng.get_influence_on_test_loss([0], tiny["test"])
    check(got.tobytes() == want.tobytes() and bool(np.isfinite(got).all()),
          "FIAModel: influence differs from the engine's")
    log(f"FIAModel: trained {FACADE_STEPS} steps on the card; "
        f"get_influence_on_test_loss bitwise the engine's ({got.size} rows)")
    return {"steps": FACADE_STEPS, "rows": int(got.size)}


def drive_ladder(engines, train, pts) -> dict:
    """Phase 8, per model: 8a-8d and 8g, then 8g's synthetic blocks, 8h,
    8e and 8f once."""
    out = {}
    gen = torch.Generator().manual_seed(8)
    with tempfile.TemporaryDirectory() as workdir:
        for family, (eng, _) in engines.items():
            samp = ladder_engine(eng, train, solver="sampled",
                                 sampled_cap=SAMPLED_CAP)
            out[family] = {
                "certificate": check_certificate(family, samp, pts, gen),
                "eigmin": check_eigmin(family, samp, pts),
                "segment_ht": check_segment_ht(family, samp, pts, gen),
                "sampled": drive_sampled(family, eng, train, pts),
                "bank": drive_bank(family, eng, train, pts, workdir),
            }
            torch.cuda.empty_cache()
        out["eigmin_synthetic"] = check_eigmin_synthetic()
        out["eigmin_small"] = check_eigmin_small()
        out["sampled_wide"] = drive_sampled_wide(train, pts)
        out["full"] = drive_full(train, pts)
        out["facade"] = drive_facade(workdir)
    return out


# -- phase 9: recovery and observability -----------------------------------
# 9a: query_many over 1024 queries, 256 a batch, 4 in flight, a worker
# death injected at the second dispatch; 9b: query_batch(1024) with a
# worker death (then halves) and a preemption (then the same size) at the
# first dispatch; 9c: a real CUDA OOM on the flat path, all but
# OOM_MARGIN bytes of the card's free memory (and the allocator's cached
# free blocks) held by blockers, and one inside a capture; 9d: a
# real CUDA OOM on the padded direct program at PADDED_T queries, the
# allocator capped at OOM_CAP_SHARE of the full batch's own memory above
# what is resident; 9e: a device-side assert in a child process, whose
# next query must raise DEVICE_LOST within STICKY_LIMIT_S; 9f: tracing on.
RECOVERY_Q, RECOVERY_BATCH, RECOVERY_WINDOW = 1024, 256, 4
OOM_MARGIN = 1 << 20
BLOCKER_PIECES = 100_000  # the most blockers 9c allocates
OOM_Q = 100  # 9c's query count: a geometry no earlier phase captured
OOM_CAPTURE_Q = 200  # 9c's capture-time OOM: another new geometry
# what a failed capture may leave reserved: a library workspace of the
# warm-up's stream, not the graph's private pool (hundreds of MiB here)
CAPTURE_LEFT_MB = 64
OOM_CAP_SHARE = 0.75
STICKY_LIMIT_S = 60.0
TRACE_REPS = 3
# the child of 9e: a small engine on the card with the CPU rung on (so
# that taking it would show), one query, then an out-of-range index on
# the card (a device-side assert, which poisons the CUDA context) and
# the query again; prints what the query raised
STICKY_CHILD = r"""
import json, time
import torch
from fia_tpu_torch import obs
from fia_tpu_torch.data.synthetic import synthetic_splits
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF
from fia_tpu_torch.reliability import inject, taxonomy
tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
model = MF(60, 40, 8, 1e-3)
eng = InfluenceEngine(model, model.init_params(torch.Generator().manual_seed(0)),
                      tiny["train"], damping=1e-3, cpu_fallback=True)
q = tiny["test"].x[:21]
eng.query_batch(q)
x = torch.zeros(4, device="cuda")
x[torch.tensor([1 << 20], device="cuda")] += 1.0  # device-side assert
out = {"cls": None, "message": None}
t0 = time.perf_counter()
with inject.active() as inj:
    try:
        eng.query_batch(q)
    except Exception as e:
        out["cls"] = taxonomy.classify(e)
        out["message"] = str(e).splitlines()[0][:300]
out["seconds"] = time.perf_counter() - t0
snap = obs.REGISTRY.snapshot()["counters"]
out["uploads"] = inj.counts.get("engine.upload", 0)
out["resets"] = snap.get("engine.device_resets", 0)
out["retries"] = sum(v for k, v in snap.items()
                     if k.startswith("reliability.retries_total"))
out["reliability_diags"] = snap.get("diag_total{channel=reliability}", 0)
out["cpu_rung"] = eng._cpu_engine is not None
print("STICKY " + json.dumps(out), flush=True)
"""


def recovery_counts() -> dict:
    """The registry's recovery counters: retries (any kind), device-state
    resets, reliability diagnostics (the CPU rung announces itself so,
    and so does the NaN ladder)."""
    snap = obs.REGISTRY.snapshot()["counters"]
    return {"retries": sum(v for k, v in snap.items()
                           if k.startswith("reliability.retries_total")),
            "resets": snap.get("engine.device_resets", 0.0),
            "cpu_rung_batches": snap.get("engine.cpu_fallback_batches", 0.0),
            "reliability_diags": snap.get("diag_total{channel=reliability}",
                                          0.0)}


def no_recovery(phase: str) -> None:
    """Fail if ``phase`` passed through a recovery ladder: it must pass on
    the card, with no retry, rebuild or CPU rung."""
    got = recovery_counts()
    check(not any(got.values()), f"phase {phase} went through a recovery "
          f"ladder: {got}")
    log(f"phase {phase}: no retry, reset or reliability diagnostic")


def engine_tensors(eng) -> dict:
    """``id -> tensor`` of every tensor reachable from the engine and its
    delegates: their attributes (dicts, tuples and lists of them), the
    captured programs' static inputs and outputs, the CPU rung aside."""
    out, seen = {}, set()
    stack = [eng, *eng._delegates_deep()]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            out[id(obj)] = obj
        elif isinstance(obj, dict):
            stack.extend(obj.values())
            stack.extend(obj.keys())
        elif isinstance(obj, (tuple, list)):
            stack.extend(obj)
        elif isinstance(obj, InfluenceEngine):
            stack.extend(v for k, v in vars(obj).items() if k != "_cpu_engine")
        elif isinstance(obj, _FlatGraph):
            stack.extend((obj.inputs, obj.out))
    return out


def recover_worker_stream(family: str, eng, pts) -> dict:
    """9a: a worker death mid-stream in ``query_many``."""
    q = pts[:RECOVERY_Q]
    kw = dict(batch_queries=RECOVERY_BATCH, window=RECOVERY_WINDOW)
    base = eng.query_many(q, **kw)
    ref = eng.query_batch(q)
    same_bytes_stitched(base, ref, f"{family} 9a fault-free query_many")
    # the second dispatch raises while the first is still in flight
    before = engine_tensors(eng)
    progs_before = len(eng._programs)
    builds0 = compilemon.count()
    with inject.active(inject.Fault(sites.ENGINE_DISPATCH_FLAT, at=1,
                                    kind=taxonomy.WORKER),
                       strict=True) as inj:
        got = eng.query_many(q, **kw)
    builds = compilemon.count() - builds0
    check(inj.counts.get(sites.ENGINE_UPLOAD, 0) == 1,
          f"{family} 9a: engine.upload fired {inj.counts}")
    check(len(got) == len(base), f"{family} 9a: {len(got)} batches")
    for k, (g, b) in enumerate(zip(got, base)):
        same_bytes(g, b, f"{family} 9a batch {k}")
    after = engine_tensors(eng)
    stale = set(before) & set(after)
    check(not stale, f"{family} 9a: {len(stale)} pre-reset tensors still "
          "reachable from the engine or its delegates")
    check(builds > 0, f"{family} 9a: nothing was recaptured after the reset")
    out = {"dispatches": inj.counts.get(sites.ENGINE_DISPATCH_FLAT, 0),
           "uploads": inj.counts.get(sites.ENGINE_UPLOAD, 0),
           "graphs_before": progs_before, "graphs_after": len(eng._programs),
           "captures_in_recovery": builds,
           "tensors_before": len(before), "tensors_after": len(after),
           "pre_reset_tensors_reachable": 0, "bitwise": True}
    log(f"{family} 9a worker death mid-stream: {json.dumps(out)}")
    return out


def recover_batch(family: str, eng, pts) -> dict:
    """9b: the halving and preemption ladders in one ``query_batch``."""
    q = pts[:RECOVERY_Q]
    base = eng.query_batch(q)
    out = {}
    for kind, want in ((taxonomy.WORKER, 3), (taxonomy.PREEMPTION, 2)):
        t0 = time.perf_counter()
        with inject.active(inject.Fault(sites.ENGINE_DISPATCH_FLAT, at=0,
                                        kind=kind), strict=True) as inj:
            got = eng.query_batch(q)
        secs = time.perf_counter() - t0
        n = inj.counts.get(sites.ENGINE_DISPATCH_FLAT, 0)
        check(n == want and inj.counts.get(sites.ENGINE_UPLOAD, 0) == 1,
              f"{family} 9b {kind}: {inj.counts} (want {want} dispatches, "
              "one upload)")
        same_bytes(got, base, f"{family} 9b {kind}")
        out[kind] = {"dispatches": n, "seconds": secs, "bitwise": True}
    log(f"{family} 9b ladders: {json.dumps(out)}")
    return out


def free_bytes() -> int:
    torch.cuda.synchronize()
    return int(torch.cuda.mem_get_info()[0])


@contextlib.contextmanager
def blocking(margin: int):
    """Blockers holding, for the block, all of the card's free memory but
    ``margin`` bytes (in whole 2 MiB pages, as the allocator maps them),
    and every free block of 1 MiB or more inside the allocator's cached
    segments (which would serve an allocation without asking the card);
    released to the card when the block ends."""
    gc.collect()
    torch.cuda.empty_cache()
    n = (free_bytes() - margin) // (2 << 20) * (2 << 20)
    held = [torch.empty(n, dtype=torch.uint8, device=CARD)]
    size = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    while size >= 1 << 20 and len(held) < BLOCKER_PIECES:
        try:
            held.append(torch.empty(size, dtype=torch.uint8, device=CARD))
        except torch.cuda.OutOfMemoryError:
            size //= 2
    try:
        yield
    finally:
        del held
        torch.cuda.empty_cache()


def capture_state_clean(what: str) -> None:
    check(not torch.cuda.is_current_stream_capturing()
          and torch.cuda.current_stream() == torch.cuda.default_stream(),
          f"{what}: a capture was left open, or the capture stream is "
          "still current")


def capture_oom(family: str, off, eng, q) -> dict:
    """9c, inside a capture: the program of a new geometry asks, while
    the stream captures, for more memory than the card has. The CUDA OOM
    must rise classified OOM with the capture ended (no stream left
    capturing, the previous stream current), the graph's pool released,
    and the engine must capture that geometry afterwards and answer as
    another engine does."""
    total = torch.cuda.get_device_properties(0).total_memory
    inner = off._flat_fn

    def greedy(s_pad, stage="scores", mode="direct"):
        fn = inner(s_pad, stage, mode)

        def run(*args):
            if torch.cuda.is_current_stream_capturing():
                torch.empty(total, dtype=torch.uint8, device=CARD)
            return fn(*args)

        return run

    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    off._flat_fn = greedy
    err = None
    try:
        off.query_batch(q)
    except Exception as e:
        err = e
    finally:
        del off._flat_fn
    check(err is not None, f"{family} 9c: no OOM inside the capture")
    cls, text = taxonomy.classify(err), str(err)
    del err  # its traceback holds the failed program's tensors
    check(cls == taxonomy.OOM and ": capture: " in text,
          f"{family} 9c in a capture: {cls!r}: {text[:400]}")
    capture_state_clean(f"{family} 9c in a capture")
    gc.collect()
    torch.cuda.empty_cache()
    left_mb = (torch.cuda.memory_reserved() - reserved0) / 2**20
    check(left_mb < CAPTURE_LEFT_MB, f"{family} 9c: the failed capture "
          f"left {left_mb} MiB reserved")
    same_bytes(off.query_batch(q), eng.query_batch(q),
                f"{family} 9c the geometry captured after the OOM")
    return {"class": cls, "reserved_left_mb": left_mb,
            "recaptured": "bitwise another engine's answer"}


def recover_flat_oom(family: str, eng, train, pts) -> dict:
    """9c: a real CUDA OOM on the flat path (an uncaptured geometry under
    a blocker): it rises classified OOM with the CPU rung off, the CPU
    rung answers with it on, and once the blocker is freed the same
    engines answer on the card as before."""
    q = pts[:OOM_Q]
    want = eng.query_batch(q)  # the card's answer, another engine
    off = engine(eng.model, eng.params, train, damping=DAMPING)
    err = None
    with blocking(OOM_MARGIN):
        try:
            off.query_batch(q)  # a fresh engine: the geometry is new
        except Exception as e:
            err = e
    check(err is not None, f"{family} 9c: no OOM under the blocker")
    cls, text = taxonomy.classify(err), str(err)
    del err  # its traceback holds the failed program's tensors
    check(cls == taxonomy.OOM, f"{family} 9c: the failure classified "
          f"{cls!r}: {text[:400]}")
    stage = ("capture" if ": capture: " in text else
             "warm-up" if ": warm-up: " in text else "eager")
    capture_state_clean(f"{family} 9c")
    again = off.query_batch(q)
    same_bytes(again, want, f"{family} 9c after the OOM (rung off)")
    in_capture = capture_oom(family, off, eng, pts[:OOM_CAPTURE_Q])
    # the CPU rung, on phase 4's small input
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(eng.model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq, tq2 = tiny["test"].x[:21], tiny["test"].x[21:50]
    card = engine(tm, tp, tiny["train"], damping=1e-3)
    card_ans = card.query_batch(tq2)
    on = InfluenceEngine(tm, tp, tiny["train"], damping=1e-3,
                         cpu_fallback=True)
    first = on.query_batch(tq)  # captured before the OOM
    before = recovery_counts()
    with blocking(OOM_MARGIN):
        rung = on.query_batch(tq2)  # an uncaptured geometry: the CPU rung
    capture_state_clean(f"{family} 9c (CPU rung)")
    check(on._cpu_engine is not None, f"{family} 9c: the CPU rung did not run")
    after = recovery_counts()
    diags = after["reliability_diags"] - before["reliability_diags"]
    batches = after["cpu_rung_batches"] - before["cpu_rung_batches"]
    check(diags == 1 and batches == 1, f"{family} 9c: {diags} reliability "
          f"diagnostics and {batches} CPU-rung batches, want 1 and 1")
    parity = compare_results(rung, card_ans, f"{family} 9c CPU rung vs card",
                             CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    same_bytes(on.query_batch(tq), first, f"{family} 9c replay after the OOM")
    same_bytes(on.query_batch(tq2), card_ans,
                f"{family} 9c the same engine on the card after the OOM")
    out = {"rung_off": {"class": cls, "failed_in": stage,
                        "message": text.splitlines()[0][:200]},
           "in_capture": in_capture,
           "cpu_rung": {"reliability_diags": diags, "batches": batches,
                        **parity},
           "after_blocker_freed": "bitwise the card's answer"}
    log(f"{family} 9c flat OOM: {json.dumps(out)}")
    return out


def chunk_log(eng) -> list:
    """Record each padded dispatch of ``eng`` as (queries, succeeded)."""
    log_, inner = [], eng._query_padded

    def spy(points, pad_to, s_pad=None):
        try:
            out = inner(points, pad_to, s_pad)
        except Exception:
            log_.append((len(points), False))
            raise
        log_.append((len(points), True))
        return out

    eng._query_padded = spy
    return log_


def recover_padded_oom(family: str, eng, train, pts) -> dict:
    """9d: a real CUDA OOM on the padded direct program: the batch ends
    in halves, the ceiling persists, and a fresh engine pre-chunks."""
    q = pts[:PADDED_T]
    full = padded_engine(eng, train, "direct", model_name=f"{family}-9d-ref")
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    ref = full.query_batch(q)
    need = torch.cuda.max_memory_reserved() - reserved0
    del full
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    limit = torch.cuda.memory_reserved() + OOM_CAP_SHARE * need
    name = f"{family}-9d"
    capped = padded_engine(eng, train, "direct", model_name=name)
    fresh = padded_engine(eng, train, "direct", model_name=name)
    first, second = chunk_log(capped), chunk_log(fresh)
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        got = capped.query_batch(q)
        pad = got._pad
        ok, bad = memlimits.load(capped._memkey)
        with inject.active() as inj:  # an empty plan: counts dispatches
            again = fresh.query_batch(q)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    failed = [n for n, ok_ in first if not ok_]
    check(failed and failed[0] == PADDED_T, f"{family} 9d: the capped "
          f"batch's dispatches {first}: no OOM at the full batch")
    check(bad == min(failed) * pad, f"{family} 9d: memlimits recorded "
          f"cells_bad {bad}, want {min(failed)} x {pad}")
    check(all(ok_ for _, ok_ in second)
          and [n for n, _ in second] == [n for n, ok_ in first if ok_]
          and inj.counts.get(sites.ENGINE_DISPATCH_PADDED, 0) == len(second),
          f"{family} 9d: the fresh engine dispatched {second}, want the "
          f"capped run's successful chunks {first} and no failure")
    ops = operands(eng, pts, PADDED_T)
    parity = compare_results(got, ref, f"{family} 9d halves vs uncapped",
                             PADDED_RTOL, PADDED_ATOL, PADDED_RHO,
                             relu_excuse(family, ops))
    same_bytes(again, got, f"{family} 9d the pre-chunked engine")
    bitwise = (got._packed.tobytes() == ref._packed.tobytes()
               and got.ihvp.tobytes() == ref.ihvp.tobytes())
    out = {"uncapped_mb": need / 2**20, "cap_mb": limit / 2**20,
           "dispatches": first, "fresh_dispatches": second,
           "cells_ok": ok, "cells_bad": bad, "pad": pad,
           "bitwise_vs_uncapped": bitwise, **parity}
    log(f"{family} 9d padded OOM: {json.dumps(out)}")
    return out


def recover_sticky() -> dict:
    """9e: a device-side assert in a child process, then a query: it
    must raise DEVICE_LOST within STICKY_LIMIT_S, with no retry, reset
    or CPU rung."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STICKY_CHILD],
                          capture_output=True, text=True,
                          timeout=STICKY_LIMIT_S + 120)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("STICKY ")]
    check(len(lines) == 1, f"9e: the child printed no result (exit "
          f"{proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(lines[0][len("STICKY "):])
    check(out["cls"] == taxonomy.DEVICE_LOST, f"9e: the query raised "
          f"{out['cls']!r}: {out['message']}")
    check(out["seconds"] < STICKY_LIMIT_S, f"9e: {out['seconds']:.1f} s to "
          "raise")
    check(not (out["uploads"] or out["resets"] or out["retries"]
               or out["reliability_diags"] or out["cpu_rung"]),
          f"9e: the failure went through a recovery ladder: {out}")
    out["child_seconds"] = time.perf_counter() - t0
    log(f"9e sticky error: {json.dumps(out)}")
    return out


def trace_on_card(family: str, eng, pts) -> dict:
    """9f: tracing on, no host wait in a dispatch, the same bits."""
    q = pts[:RECOVERY_Q]
    kw = dict(batch_queries=RECOVERY_BATCH, window=RECOVERY_WINDOW)

    def walls(traced: bool):
        obs.configure(trace=traced)
        try:
            times, res = [], None
            for _ in range(TRACE_REPS):
                # host results: the fetch already waited on the card
                res, s = fenced_time(eng.query_many, q, **kw)
                times.append(s * 1e3)
            return float(np.median(times)), res
        finally:
            obs.configure(trace=False)

    plain_ms, plain = walls(False)
    obs.TRACER.reset()
    dispatch = eng._dispatch_flat
    dispatch_without_waits(eng)
    try:
        traced_ms, traced = walls(True)
        obs.configure(trace=True)
        try:
            with obs.trace(f"{family}-9f"):
                one = eng.query_batch(q[:RECOVERY_BATCH])
        finally:
            obs.configure(trace=False)
    finally:
        eng._dispatch_flat = dispatch
    for k, (a, b) in enumerate(zip(traced, plain)):
        same_bytes(a, b, f"{family} 9f traced batch {k}")
    same_bytes_stitched([one], plain[0], f"{family} 9f traced query_batch")
    spans = [span_fields(s) for s in obs.TRACER.flush()]
    names = [s["name"] for s in spans]
    for name in ("engine.query", "engine.dispatch_flat"):
        check(name in names, f"{family} 9f: no {name} span")
    doc = json.loads(json.dumps(perfetto(spans)))
    check(len([e for e in doc["traceEvents"] if e["ph"] == "X"])
          == len(spans), f"{family} 9f: the Perfetto export lost spans")
    prom = prometheus(obs.REGISTRY.snapshot())
    for line in prom.splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])  # every sample parses
    out = {"untraced_ms": plain_ms, "traced_ms": traced_ms,
           "spans": len(spans),
           "dispatch_spans": names.count("engine.dispatch_flat"),
           "prometheus_lines": len(prom.splitlines()), "bitwise": True}
    log(f"{family} 9f tracing: {json.dumps(out)}")
    return out


def drive_recovery(engines, train, pts) -> dict:
    """Phase 9 (each model: 9a, 9b, 9c, 9d, 9f; 9e once), its memory
    envelope in a file of its own."""
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        os.environ["FIA_MEMLIMIT_CACHE"] = os.path.join(workdir, "mem.json")
        for family, (eng0, _) in engines.items():
            t0 = time.perf_counter()
            eng = InfluenceEngine(eng0.model, eng0.params, train,
                                  damping=DAMPING)  # the CPU rung on
            row = {"9a": recover_worker_stream(family, eng, pts),
                   "9b": recover_batch(family, eng, pts),
                   "9c": recover_flat_oom(family, eng, train, pts),
                   "9d": recover_padded_oom(family, eng0, train, pts),
                   "9f": trace_on_card(family, eng, pts)}
            row["seconds"] = time.perf_counter() - t0
            out[family] = row
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        out["9e"] = recover_sticky()
    return out


def main() -> int:
    # -- phase 1: the card ---------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    # the padded path's learned memory envelope goes to a file of this
    # run's own, not into the checkout
    envelope_dir = tempfile.TemporaryDirectory()
    os.environ["FIA_MEMLIMIT_CACHE"] = os.path.join(envelope_dir.name,
                                                    "mem.json")
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build --------------------------------------------------
    build = {"nvcc": nvcc_version(), "seconds": {}, "ptxas": {}}
    log(f"nvcc: {build['nvcc']}")
    secs = common.build([*SOURCES.values(), SEGMENT_SOURCE, CERT_SOURCE,
                         EIGMIN_SOURCE])
    for name, s in secs.items():
        log(f"build {name}: {s:.2f} s")
        build["seconds"][name] = s
        build["ptxas"][name] = ptxas_report(common.build_log(name))
        for fn, r in build["ptxas"][name].items():
            log(f"  ptxas: {fn}: {r.get('registers')} registers, spill "
                f"stores {r.get('spill_stores')} B, loads "
                f"{r.get('spill_loads')} B")

    # -- main paths' set-up (ML-1M shape, seeded weights) ---------------
    t0 = time.perf_counter()
    train = synthesize_ratings(USERS, ITEMS, ROWS, seed=0)
    pts = sample_heldout_pairs(train.x, USERS, ITEMS, max(BATCHES), seed=17)
    engines = {f: setup_engines(cls(USERS, ITEMS, K_EMB, WD), train)
               for f, cls in (("mf", MF), ("ncf", NCF))}
    index = engines["mf"][0].index
    longest = index.max_related_count()
    longest_rq2 = int(index.counts_batch(pts[:RQ2_Q]).max())
    log(f"set-up: {time.perf_counter() - t0:.2f} s; longest related set "
        f"{longest} rows (RQ2's 64 queries: {longest_rq2})")

    # -- phases 3 and 4, per model: kernels, then main path --------------
    checked, driven = {}, {}
    seg_checked = check_segment(engines, pts, longest, longest_rq2)
    for family, (eng, plain) in engines.items():
        checked[family] = check_kernel(family, eng, pts)
        driven[family] = drive(family, eng, plain, pts)
    no_recovery("3-4")

    # -- the split-invariance probe, the any-split and graph phases ----
    t_split = time.perf_counter()
    probed = probe(train, pts)
    for name, row in probed.items():
        for layout, r in row.items():
            if layout == "solve_isolated":
                check(not any(r["engine"].values()), f"probe {name}: the "
                      "engine's batched LU alone changes bits with the "
                      f"batch size: {r}")
            else:
                check(r["first_differing_stage"] is None,
                      f"probe {name} [{layout}]: stage "
                      f"{r['first_differing_stage']} differs by batch split: "
                      f"{r['queries_differing']}")
    split, graphs = {}, {}
    for family, (eng, _) in engines.items():
        split[family] = drive_any_split(family, eng, pts)
        graphs[family] = drive_graphs(family, eng, train, pts)
    split_s = time.perf_counter() - t_split
    log(f"probe, any-split and graph phases: {split_s:.1f} s")
    no_recovery("S")

    # -- phase 5: times --------------------------------------------------
    perf = {"card": card, "build": build, "models": {},
            "segment_kernel_vs_plain": seg_checked, "probe": probed,
            "split_and_graph_seconds": split_s}
    rows, seg_rows = [], {}
    for family, (eng, _) in engines.items():
        batches, last, seg_last = measure(family, eng, train, pts)
        perf["models"][family] = {
            "batches": batches,
            "kernel_vs_plain": checked[family],
            "any_split": split[family],
            "graphs": graphs[family],
            **driven[family],
        }
        seg_rows[family] = seg_last
        rows.append({
            "name": SOURCES[family],
            "route": "cuda",
            "source": f"fia_tpu_torch/influence/kernels/csrc/{SOURCES[family]}.cu",
            "replaces": REPLACES[family],
            "launches": driven[family]["launches"],
            "max_abs_err": checked[family]["max_abs_err"],
            "ms": last["ms"], "plain_ms": last["plain_ms"],
            "bound_ms": last["bound_ms"], "bound_by": last["bound_by"],
            "library_ms": None,
            "shape": last["shape"],
        })
    # the Hessian kernel's row: NCF's (d = 64) times, pieces and scratch at
    # T = 1024; launches (two a call) of both models' main paths; plain_ms
    # the row-order scatter form by graph replay, pieced_ms the kernel's
    # bit-for-bit reference (events, host waits a step)
    seg_last = seg_rows["ncf"]
    rows.append({
        "name": SEGMENT_SOURCE,
        "route": "cuda",
        "source": f"fia_tpu_torch/influence/kernels/csrc/{SEGMENT_SOURCE}.cu",
        "replaces": SEGMENT_REPLACES,
        "launches": sum(d["segment_launches"] for d in driven.values()),
        "max_abs_err": seg_checked["max_abs_err"],
        "max_err_of_max_abs_H": seg_checked["max_err_of_max_abs_H"],
        "launches_per_call": 2,
        "ms": seg_last["ms"], "plain_ms": seg_last["plain_ms"],
        "bound_ms": seg_last["bound_ms"], "bound_by": seg_last["bound_by"],
        "library_ms": None,
        "onehot_ms": seg_last["onehot_ms"],
        "pieced_ms": seg_last["pieced_ms"],
        "piece_rows": seg_last["piece_rows"], "pieces": seg_last["pieces"],
        "scratch_mb": seg_last["scratch_mb"],
        "shape": seg_last["shape"],
        "mf": seg_rows["mf"],
    })

    no_recovery("5")

    # -- phase 6: the padded per-query program -------------------------
    for family, (eng, _) in engines.items():
        perf["models"][family]["padded"] = drive_padded(family, eng, train,
                                                        pts)
    no_recovery("6")

    # -- phase 7: training, checkpoints, RQ1 and RQ2 -------------------
    t7 = time.perf_counter()
    classes = {"mf": MF, "ncf": NCF}
    seg_by_path = {}
    for row, (family, (eng, _)) in zip(rows, engines.items()):
        out = {"card_vs_cpu": train_small(family, classes[family])}
        params, out["full"] = train_full(family, eng.model, train, pts)
        trained = engine(eng.model, params, train, damping=DAMPING)
        out["rq1"] = drive_rq1(family, trained, train, pts)
        out["rq2"] = drive_rq2(family, classes[family], train, pts)
        perf["models"][family]["train"] = out
        row["launches_by_path"] = {
            "query_batch": row["launches"],
            "rq1": out["rq1"]["score_kernel_launches"],
            "rq2_query_batch": {k: v["query_batch"]["score_kernel_launches"]
                                for k, v in out["rq2"].items()},
            "rq2_query_many": {k: v["query_many"]["score_kernel_launches"]
                               for k, v in out["rq2"].items()},
        }
        seg_by_path[family] = {
            "query_batch": driven[family]["segment_launches"],
            "rq1": out["rq1"]["segment_launches"],
            "rq2_query_batch": {k: v["query_batch"]["segment_launches"]
                                for k, v in out["rq2"].items()},
            "rq2_query_many": {k: v["query_many"]["segment_launches"]
                               for k, v in out["rq2"].items()},
        }
    rows[-1]["launches_by_path"] = seg_by_path
    perf["phase7_seconds"] = time.perf_counter() - t7
    log(f"phase 7: {perf['phase7_seconds']:.1f} s")
    no_recovery("7")

    # -- phase 8: the rest of the solver ladder ------------------------
    t8 = time.perf_counter()
    ladder = perf["ladder"] = drive_ladder(engines, train, pts)
    for row, family in zip(rows, engines):
        lad = ladder[family]
        row["launches_by_path"]["sampled"] = lad["sampled"]["launches"][
            SOURCES[family]]
        row["launches_by_path"]["bank"] = lad["bank"]["launches"][
            SOURCES[family]]
    for family in engines:
        lad = ladder[family]
        seg_by_path[family]["sampled"] = lad["sampled"]["launches"][
            SEGMENT_SOURCE]
        seg_by_path[family]["bank"] = lad["bank"]["launches"][SEGMENT_SOURCE]
        seg_by_path[family]["bank_build"] = lad["bank"]["build_launches"][
            SEGMENT_SOURCE]
    # the certificate kernel's row: NCF's (d = 64) times at T = 1024, MF's
    # beside them; launches of both models' sampled rungs (three a call)
    cert = ladder["ncf"]["certificate"]
    rows.append({
        "name": CERT_SOURCE,
        "route": "cuda",
        "source": f"fia_tpu_torch/influence/kernels/csrc/{CERT_SOURCE}.cu",
        "replaces": CERT_REPLACES,
        "launches": sum(ladder[f]["sampled"]["launches"][CERT_SOURCE]
                        for f in engines),
        "max_abs_err": max(ladder[f]["certificate"]["max_abs_err"]
                           for f in engines),
        "max_err_of_max_abs": max(ladder[f]["certificate"][
            "max_err_of_max_abs"] for f in engines),
        "launches_per_call": kcert.LAUNCHES_PER_CALL,
        "ms": cert["ms"], "plain_ms": cert["plain_ms"],
        "bound_ms": cert["bound_ms"], "bound_by": cert["bound_by"],
        "library_ms": None,
        "shape": cert["shape"],
        "mf": ladder["mf"]["certificate"],
        "ptxas": build["ptxas"][CERT_SOURCE],
        "launches_by_path": {
            path: {f: ladder[f][path]["launches"][CERT_SOURCE]
                   for f in engines} for path in ("sampled", "bank")},
    })
    # the λ_min kernel's row: NCF's (d = 64) times at T = 1024, MF's
    # beside them; launches of both models' sampled rungs (one a call)
    eig = ladder["ncf"]["eigmin"]
    rows.append({
        "name": EIGMIN_SOURCE,
        "route": "cuda",
        "source": f"fia_tpu_torch/influence/kernels/csrc/{EIGMIN_SOURCE}.cu",
        "replaces": EIGMIN_REPLACES,
        "launches": sum(ladder[f]["sampled"]["launches"][EIGMIN_SOURCE]
                        for f in engines),
        "max_abs_err": max(ladder[f]["eigmin"]["max_abs_err"]
                           for f in engines),
        "c_max": max(ladder[f]["eigmin"]["c_max"] for f in engines),
        "launches_per_call": keig.LAUNCHES_PER_CALL,
        "ms": eig["ms"][str(BATCHES[-1])], "plain_ms": eig["plain_ms"],
        "bound_ms": eig["bound_ms"], "bound_by": eig["bound_by"],
        "library_ms": eig["library_ms"],
        "shape": eig["shape"],
        "mf": ladder["mf"]["eigmin"],
        "synthetic": ladder["eigmin_synthetic"],
        "small": ladder["eigmin_small"],
        "sampled_wide": ladder["sampled_wide"],
        "ptxas": build["ptxas"][EIGMIN_SOURCE],
        "launches_by_path": {
            path: {f: ladder[f][path]["launches"][EIGMIN_SOURCE]
                   for f in engines} for path in ("sampled", "bank")},
    })
    perf["phase8_seconds"] = time.perf_counter() - t8
    log(f"phase 8: {perf['phase8_seconds']:.1f} s")
    no_recovery("8")

    # -- phase 9: recovery and observability ---------------------------
    t9 = time.perf_counter()
    perf["recovery"] = drive_recovery(engines, train, pts)
    perf["phase9_seconds"] = time.perf_counter() - t9
    log(f"phase 9: {perf['phase9_seconds']:.1f} s")
    envelope_dir.cleanup()

    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
