"""Drive the PyTorch/CUDA port (``fia_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. require a CUDA device; print the card's name and power limit;
  2. build every CUDA kernel of the paths from the sources in the
     checkout (one ``nvcc`` each, all started together); print
     ``nvcc --version`` and each kernel instantiation's ``ptxas``
     registers and spills;
  3. hold each kernel against its plain PyTorch version on the card, at
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
     NCF; require that it launched its kernel, that its scores equal
     those of the same engine with the plain score stage, and that a
     small input agrees with the port's CPU path;
  5. time the stages, the end-to-end query rate and each kernel beside
     its bound and its plain version (CUDA events; the card's power
     limit is printed beside them).

NCF's kernel and plain version sum each relu pre-activation in another
order, so a pre-activation within rounding of 0 can take the other side
of its mask and move that row's score far beyond the bar. Such a row
passes only if the plain version in float64 puts one of the row's
pre-activations within ``BOUNDARY_REL`` of 0; the rows so excused are
counted and printed, and any other row beyond the bar fails the run.

Likewise two rows whose exact scores differ by about one float32 ulp can
be ordered either way by two summation orders, and one such swap costs a
query of 156 rows 3.2e-6 of Spearman. A query below ``RHO_MIN`` passes
only if the plain version in float64 puts every pair the two rankings
order differently within ``TIE_REL`` of each other; such pairs are
counted and printed.

The last lines of standard output are a ``perf`` line, the card's
``nvidia-smi`` name and power limit, a ``{"kernels": [...]}`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from fia_tpu_torch.data.synthetic import (
    sample_heldout_pairs,
    synthesize_ratings,
    synthetic_splits,
)
from fia_tpu_torch.influence.engine import STAGES, InfluenceEngine
from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import mf as kmf
from fia_tpu_torch.influence.kernels import ncf as kncf
from fia_tpu_torch.models import MF, NCF

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
SOURCES = {"mf": "mf_scores", "ncf": "ncf_scores"}
KERNEL_MODULES = {"mf": kmf, "ncf": kncf}
REPLACES = {"mf": "fia_tpu/influence/kernels/mf.py:25",
            "ncf": "fia_tpu/influence/kernels/ncf.py:30"}


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
    with torch.cuda.graph(graph):
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


def device_breakdown(fn, wall_ms: float, top: int = 8) -> dict:
    """Device time of one ``fn`` call by kernel (``torch.profiler``), and
    the busy share of ``wall_ms``, the call's unprofiled host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    return {
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                        for e in kern[:top]],
    }


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


def float32_ties(a, b, exact) -> tuple[int, bool]:
    """The pairs of rows that rankings ``a`` and ``b`` order differently:
    their count, and whether ``exact`` (float64) puts every one of them
    within TIE_REL of each other."""
    sa = np.sign(a[:, None] - a[None, :])
    sb = np.sign(b[:, None] - b[None, :])
    i, j = np.nonzero(np.triu(sa != sb, 1))
    gap = np.abs(exact[i] - exact[j])
    tie = gap <= TIE_REL * np.maximum(np.abs(exact[i]), np.abs(exact[j]))
    return len(i), bool(tie.all())


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
                n, ties = float32_ties(
                    a, b, exact()[offsets[t]: offsets[t + 1]][keep])
                check(ties, f"{what}: query {t} Spearman {rho} < {rho_min} "
                      "and its rankings differ beyond float32 ties")
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
    eng = InfluenceEngine(model, params, train, damping=DAMPING)
    check(eng.active_kernel_variant() == "cuda",
          f"{type(model).__name__} engine did not pick cuda")
    plain = InfluenceEngine(model, params, train, damping=DAMPING,
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


def drive(family: str, eng, plain, pts) -> dict:
    """Phase 4: the main path, launches counted from 0, against the
    plain score stage on the card and a small input against the CPU."""
    mod = KERNEL_MODULES[family]
    for m in KERNEL_MODULES.values():
        m.launches = 0
    results = {T: eng.query_batch(pts[:T]) for T in BATCHES}
    launches = mod.launches
    check(launches > 0, f"the {family} main path never launched "
          f"{SOURCES[family]}")
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
        excuse = None
        if family == "ncf":
            rel_x, tables64 = ops[2], to64(ops[6:])

            def excuse(rows, rel_x=rel_x, tables64=tables64):
                idx = torch.as_tensor(rows, device=rel_x.device)
                return boundary_rows(rel_x[idx], tables64).cpu().numpy()
        parity[T] = compare_results(res, ref, f"{family} T={T} kernel vs "
                                    "plain", RTOL, ATOL, RHO_MIN, excuse,
                                    exact)
        log(f"{family} T={T}: {int(res.counts.sum())} scores, kernel vs "
            f"plain {parity[T]}")
    # a small input against the port's CPU path
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(eng.model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x[:21]
    on_card = InfluenceEngine(tm, tp, tiny["train"], damping=1e-3
                              ).query_batch(tq)
    on_cpu = InfluenceEngine(tm, tp, tiny["train"], damping=1e-3,
                             device="cpu").query_batch(tq)
    cpu_parity = compare_results(on_card, on_cpu, f"{family} card vs CPU "
                                 "(small)", CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    log(f"{family} card vs CPU path, small input: {cpu_parity}")
    return {"launches": launches, "parity": {str(T): v for T, v in
                                             parity.items()},
            "cpu_parity": cpu_parity}


def measure(family: str, eng, pts) -> tuple[dict, dict]:
    """Phase 5: stage prefixes, query rate, the kernel beside its bound
    and its plain version, and the device breakdown, per batch size."""
    mod = KERNEL_MODULES[family]
    batches, last = {}, None
    for T in BATCHES:
        counts, tx, s_pad = eng._flat_inputs(pts[:T])
        args = (eng.params, eng.train_x, eng.train_y, eng._postings, tx)
        stage_ms = {}
        for stage in STAGES:
            fn = eng._flat_fn(s_pad, stage)
            stage_ms[stage] = time_ms(lambda: fn(*args), iters=5)
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            eng.query_batch(pts[:T])  # returns host arrays: synchronised
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls[1:]))
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
            "query_batch_ms": wall * 1e3,
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
        log(f"{family} T={T}: {json.dumps(batches[str(T)], sort_keys=True)}")
    return batches, last


def main() -> int:
    # -- phase 1: the card ---------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build --------------------------------------------------
    build = {"nvcc": nvcc_version(), "seconds": {}, "ptxas": {}}
    log(f"nvcc: {build['nvcc']}")
    secs = common.build(list(SOURCES.values()))
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
    log(f"set-up: {time.perf_counter() - t0:.2f} s")

    # -- phases 3 and 4, per model: kernel, then main path ---------------
    checked, driven = {}, {}
    for family, (eng, plain) in engines.items():
        checked[family] = check_kernel(family, eng, pts)
        driven[family] = drive(family, eng, plain, pts)

    # -- phase 5: times --------------------------------------------------
    perf = {"card": card, "build": build, "models": {}}
    rows = []
    for family, (eng, _) in engines.items():
        batches, last = measure(family, eng, pts)
        perf["models"][family] = {
            "batches": batches,
            "kernel_vs_plain": checked[family],
            **driven[family],
        }
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

    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
