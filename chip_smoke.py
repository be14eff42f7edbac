"""Drive the PyTorch/CUDA port (``fia_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. require a CUDA device; print the card's name and power limit;
  2. build every CUDA kernel of the path from the sources in the
     checkout (one ``nvcc`` each, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes plus edge cases (a ragged row count, a fully
     masked segment, rows matching neither query id, the scalar path);
  4. drive the main path — ``InfluenceEngine.query_batch``, MF at ML-1M
     shape (6040 users x 3706 items, 975,460 rows, k = 16), random seeded
     weights — for 256 and then 1024 held-out queries; require that it
     launched every kernel, that its scores equal those of the same
     engine with the plain score stage, and that a small input agrees
     with the port's CPU path;
  5. time the stages, the end-to-end query rate and each kernel beside
     its bound and its plain version (CUDA events; the card's power
     limit is printed beside them).

The last lines of standard output are a ``perf`` line, the card's
``nvidia-smi`` name and power limit, a ``{"kernels": [...]}`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
from fia_tpu_torch.models import MF

# ML-1M shape and the reference's MF defaults (bench.py's full run)
USERS, ITEMS, ROWS = 6040, 3706, 975_460
K_EMB, WD, DAMPING = 16, 1e-3, 1e-6
BATCHES = (256, 1024)
# kernel against its plain version, same inputs, same card
RTOL, ATOL = 2e-5, 1e-6
RHO_MIN = 1.0 - 1e-6  # ~5 adjacent swaps of float-noise ties at 400 rows
# the card against the port's CPU path on a small input: another
# Hessian summation order and another LU implementation
CPU_RTOL, CPU_ATOL, CPU_RHO_MIN = 1e-4, 1e-5, 0.9999
# published H100 SXM peaks (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def graph_ms(fn, iters: int) -> float:
    """Device ms of one ``fn`` call: ``iters`` calls captured in one
    CUDA graph and replayed between two events, so the host's launch
    overhead is not counted."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def compare_results(res, ref, what: str, rtol: float, atol: float,
                    rho_min: float) -> dict:
    """Counts and related rows exact, scores allclose, per-query
    Spearman; returns the worst errors seen."""
    check(np.array_equal(res.counts, ref.counts), f"{what}: counts differ")
    max_abs, min_rho = 0.0, 1.0
    for t in range(len(res.counts)):
        a, b = res.scores_of(t), ref.scores_of(t)
        check(a.shape == b.shape == (int(res.counts[t]),),
              f"{what}: query {t} has {a.shape} scores, want {res.counts[t]}")
        check(bool(np.isfinite(a).all()), f"{what}: non-finite scores")
        if len(a):
            max_abs = max(max_abs, float(np.max(np.abs(a - b))))
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                fail(f"{what}: query {t} scores differ beyond rtol {rtol} "
                     f"atol {atol} (max abs {np.max(np.abs(a - b)):.3e})")
        if len(a) > 1 and np.ptp(a) > 0 and np.ptp(b) > 0:
            min_rho = min(min_rho, spearman(a, b))
    check(min_rho >= rho_min, f"{what}: Spearman {min_rho} < {rho_min}")
    check(bool(np.isfinite(res.ihvp).all()), f"{what}: non-finite ihvp")
    return {"max_abs_err": max_abs, "min_spearman": min_rho}


def mf_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for one MF score call on these
    operands: each input read once, the output written once, against
    ~4k + 10 fp32 operations a row."""
    tx, t, rel_x, e, wv, B, P, Q = ops
    S, k = rel_x.shape[0], P.shape[1]
    nbytes = sum(x.numel() * x.element_size()
                 for x in (tx, t, rel_x, e, wv, B, P, Q)) + S * 4
    flops = S * (4 * k + 10)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_cases(ops, gen: torch.Generator):
    """(name, operands) at the main path's shapes plus edge cases."""
    tx, t, rel_x, e, wv, B, P, Q = ops
    S = rel_x.shape[0]
    cases = [("main path", ops)]
    r = S - 37  # not a multiple of the 64-row block
    cases.append(("ragged S", (tx, t[:r], rel_x[:r], e[:r], wv[:r], B, P, Q)))
    wv0 = wv.clone()
    wv0[t == 0] = 0.0  # segment 0 fully masked
    cases.append(("masked segment", (tx, t, rel_x, e, wv0, B, P, Q)))
    foreign = rel_x.clone()
    pick = torch.randint(0, S, (S,), generator=gen).to(rel_x.device)
    foreign[::3] = rel_x[pick[::3]]  # mostly rows of other queries
    cases.append(("foreign rows", (tx, t, foreign, e, wv, B, P, Q)))
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
    secs = common.build(["mf_scores"])
    for name, s in secs.items():
        log(f"build {name}: {s:.2f} s")
        for line in common.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # -- main path set-up (ML-1M shape, seeded weights) -----------------
    t0 = time.perf_counter()
    train = synthesize_ratings(USERS, ITEMS, ROWS, seed=0)
    pts = sample_heldout_pairs(train.x, USERS, ITEMS, max(BATCHES), seed=17)
    model = MF(USERS, ITEMS, K_EMB, WD)
    params = model.init_params(torch.Generator().manual_seed(0), device="cuda")
    eng = InfluenceEngine(model, params, train, damping=DAMPING)
    check(eng.active_kernel_variant() == "cuda", "engine did not pick cuda")
    plain = InfluenceEngine(model, params, train, damping=DAMPING,
                            kernel="torch", device="cuda")
    log(f"set-up: {time.perf_counter() - t0:.2f} s")

    def operands(T):
        _, tx, s_pad = eng._flat_inputs(pts[:T])
        out = eng._flat_fn(s_pad, "operands")(
            eng.params, eng.train_x, eng.train_y, eng._postings, tx)
        return (*out, eng.params["P"], eng.params["Q"])

    # -- phase 3: kernel against its plain version ----------------------
    gen = torch.Generator().manual_seed(1)
    kernel_err = 0.0
    for name, ops in kernel_cases(operands(BATCHES[0]), gen):
        tx, t, rel_x, e, wv, B, P, Q = ops
        got = kmf.fused_scores(rel_x, t, e, wv, tx, P, Q, B)
        want = kmf.fused_scores_reference(rel_x, t, e, wv, tx, P, Q, B)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if len(got) else 0.0
        check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
              f"mf_scores {name}: max abs err {err:.3e} beyond rtol {RTOL} "
              f"atol {ATOL}")
        check(bool((got[wv == 0] == 0).all()),
              f"mf_scores {name}: a wv = 0 row scored non-zero")
        kernel_err = max(kernel_err, err)
        log(f"mf_scores vs plain [{name}] S={len(got)} max abs err {err:.3e}")

    # -- phase 4: the main path -----------------------------------------
    kmf.launches = 0
    results = {T: eng.query_batch(pts[:T]) for T in BATCHES}
    launches = kmf.launches
    check(launches > 0, "the main path never launched mf_scores")
    d = model.block_size
    parity = {}
    for T, res in results.items():
        check(res.ihvp.shape == (T, d) and res.test_grad.shape == (T, d),
              f"T={T}: ihvp/test_grad shapes {res.ihvp.shape}")
        ref = plain.query_batch(pts[:T])
        parity[T] = compare_results(res, ref, f"T={T} kernel vs plain",
                                    RTOL, ATOL, RHO_MIN)
        log(f"T={T}: {int(res.counts.sum())} scores, kernel vs plain "
            f"{parity[T]}")
    # a small input against the port's CPU path
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = MF(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x[:21]
    on_card = InfluenceEngine(tm, tp, tiny["train"], damping=1e-3
                              ).query_batch(tq)
    on_cpu = InfluenceEngine(tm, tp, tiny["train"], damping=1e-3,
                             device="cpu").query_batch(tq)
    cpu_parity = compare_results(on_card, on_cpu, "card vs CPU (small)",
                                 CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    log(f"card vs CPU path, small input: {cpu_parity}")

    # -- phase 5: times --------------------------------------------------
    perf = {"card": card, "batches": {}}
    kernel_row = None
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
        ops = operands(T)
        tx_, t_, rel_x_, e_, wv_, B_, P_, Q_ = ops

        def kernel():
            return kmf.fused_scores(rel_x_, t_, e_, wv_, tx_, P_, Q_, B_)

        def plain_version():
            return kmf.fused_scores_reference(rel_x_, t_, e_, wv_, tx_, P_,
                                              Q_, B_)

        k_ms = graph_ms(kernel, iters=50)
        p_ms = graph_ms(plain_version, iters=20)
        call_ms = time_ms(kernel, iters=50)  # eager, host launch included
        bound, bound_by = mf_bound_ms(ops)
        total = int(counts.sum())
        perf["batches"][str(T)] = {
            "scores": total, "s_pad": s_pad,
            "stage_ms_cumulative": stage_ms,
            "hessian_stage_ms": stage_ms["hessian"] - stage_ms["grads"],
            "query_batch_ms": wall * 1e3,
            "scores_per_s": total / wall,
            "mf_scores_ms": k_ms, "mf_scores_plain_ms": p_ms,
            "mf_scores_call_ms": call_ms,
            "mf_scores_bound_ms": bound,
            "query_batch_device": device_breakdown(
                lambda: eng.query_batch(pts[:T]), wall * 1e3),
        }
        kernel_row = {
            "name": "mf_scores",
            "route": "cuda",
            "source": "fia_tpu_torch/influence/kernels/csrc/mf_scores.cu",
            "replaces": "fia_tpu/influence/kernels/mf.py:25",
            "launches": launches,
            "max_abs_err": kernel_err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,
            "shape": {"S": int(rel_x_.shape[0]), "T": int(tx_.shape[0]),
                      "k": K_EMB},
        }
    perf["parity"] = {str(T): v for T, v in parity.items()}
    perf["cpu_parity"] = cpu_parity

    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"kernels": [kernel_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
