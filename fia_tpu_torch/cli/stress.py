"""The ML-20M stress driver (port of ``scripts/stress.py``,
``BASELINE.json``'s fifth config: MF on full MovieLens-20M, scaled).

Synthesises a train split with ML-20M's marginals (138,493 users, 26,744
items, 20,000,263 rows; nothing is downloaded), trains MF or NCF for
``--train_steps`` minibatch steps, times ``--num_queries`` held-out
influence queries through the flat direct path
(``eval/rq2.time_influence_queries``) and, with ``--full_space``, probes
the full-parameter engine (CG over every train row). Prints one JSON
line with the reference's keys: the step time, queries/s and scores/s.

  python -m fia_tpu_torch.cli.stress                        # ML-20M, card
  python -m fia_tpu_torch.cli.stress --smoke --backend cpu  # tiny, CPU
  python -m fia_tpu_torch.cli.stress --model_parallel 2 --embed_size 64

The reference's flags one for one, plus ``--backend``: none runs on the
CUDA device and raises without one, ``cpu`` runs on the CPU; ``--smoke``
only shrinks the shapes. ``--model_parallel M > 1`` row-shards the
embedding tables (``shard_tables=True``) on ``make_hybrid_mesh(
model_parallel=M)`` over the backend's slots, laying M virtual slots
over one device where fewer are visible: there it is a correctness run,
never a speedup. Fresh weights come from a ``torch.Generator`` seeded
with ``--seed``, not from ``jax.random``'s draws, so the trained params
are the port's own; the data and the queries, and so every related-row
count, are the reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.device import resolve_device
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.parallel import distributed as dist
from fia_tpu_torch.parallel import mesh as pmesh

#: ML-20M's marginals (the reference's stress scale)
ML20M = (138_493, 26_744, 20_000_263)
#: --smoke's shapes and caps (the reference's)
SMOKE = dict(users=600, items=300, rows=30_000, steps=200, queries=16,
             batch=1024)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for CI / CPU (does not choose the "
                         "device: add --backend cpu)")
    ap.add_argument("--model", choices=["MF", "NCF"], default="MF",
                    help="NCF exercises the GMF+MLP tower at stress "
                         "scale (twice the embedding params per id; "
                         "the MLP weights stay outside the FIA block)")
    ap.add_argument("--embed_size", type=int, default=16)
    ap.add_argument("--train_steps", type=int, default=2000)
    ap.add_argument("--num_queries", type=int, default=256)
    ap.add_argument("--model_parallel", type=int, default=1,
                    help=">1 row-shards the embedding tables over a "
                         "'model' mesh axis (virtual slots over one "
                         "device where fewer are visible)")
    ap.add_argument("--batch_size", type=int, default=8192)
    ap.add_argument("--full_space", action="store_true",
                    help="also probe the FULL-parameter influence engine "
                         "(chunked-HVP CG over every train row) at this "
                         "scale — the non-block Koh&Liang path")
    ap.add_argument("--hvp_batch", type=int, default=1 << 20,
                    help="rows per chunk of the full-space HVP")
    ap.add_argument("--cg_maxiter", type=int, default=10,
                    help="full-space CG iteration cap (10 = the "
                         "reference's probe; 100 = its fmin_ncg cap)")
    ap.add_argument("--stream", choices=["zipf", "cal"], default="zipf",
                    help="train synthesis: Zipf or the cal2-style "
                         "calibrated stream (waterfilled degrees, unique "
                         "pairs; Zipf item marginal)")
    ap.add_argument("--users", type=int, default=None,
                    help="override the ML-20M user count (e.g. ML-1M "
                         "scale for a converged full-space row)")
    ap.add_argument("--items", type=int, default=None)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coordinator", type=str, default=None,
                    help="coordinator address for multi-process runs "
                         "(host:port); joins the process group before "
                         "any device use")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--backend", type=str, default=None,
                    choices=[None, "cuda", "cpu"],
                    help="torch device (default: the CUDA device, raising "
                         "without one; 'cpu' runs on the CPU)")
    return ap


def shapes(args) -> tuple[int, int, int, int, int, int]:
    """``(users, items, rows, steps, queries, batch)`` of a run: ML-20M's
    and the flags', or --smoke's caps; --users/--items/--rows override
    the first three either way."""
    if args.smoke:
        users, items, rows = SMOKE["users"], SMOKE["items"], SMOKE["rows"]
        steps = min(args.train_steps, SMOKE["steps"])
        n_q = min(args.num_queries, SMOKE["queries"])
        batch = SMOKE["batch"]
    else:
        users, items, rows = ML20M
        steps, n_q, batch = (args.train_steps, args.num_queries,
                             args.batch_size)
    return (args.users or users, args.items or items, args.rows or rows,
            steps, n_q, batch)


def synthesize(args, users: int, items: int, rows: int) -> RatingDataset:
    """The train split: the Zipf generator, or the calibrated stream
    with min_degree 16 (ML-20M's source keeps users with >= 20 ratings;
    16 is the ML-1M leave-4-out convention) unless the mean degree is too
    small for it (the smoke shapes)."""
    from fia_tpu_torch.data.synthetic import (synthesize_calibrated,
                                              synthesize_ratings)

    if args.stream == "cal":
        min_deg = min(16, max(1, rows // users - 1))
        return synthesize_calibrated(users, items, rows, heldout_x=None,
                                     seed=args.seed, min_degree=min_deg)
    return synthesize_ratings(users, items, rows, seed=args.seed)


def stress_mesh(model_parallel: int, device):
    """The ``('data', 'model')`` mesh of ``--model_parallel`` (None at
    1): ``make_hybrid_mesh`` over the backend's slots. A size that does
    not divide the slots exits, as in the reference."""
    if model_parallel <= 1:
        return None
    try:
        return dist.make_hybrid_mesh(model_parallel=model_parallel,
                                     device=device)
    except ValueError as e:
        raise SystemExit(f"--model_parallel {model_parallel}: {e}")


def stress_engine(args, model, params, train, mesh, device):
    """The stress configuration's engine: direct solve, damping 1e-6,
    pad bucket 512, the tables row-sharded on a mesh. MF keeps the
    default ``model_name`` ("model"), as in the reference, so its padded
    envelope is learned under that key; NCF gets its own."""
    from fia_tpu_torch.influence.engine import InfluenceEngine

    return InfluenceEngine(
        model, params, train, damping=1e-6, solver="direct",
        pad_bucket=512, mesh=mesh, shard_tables=mesh is not None,
        device=device,
        **({"model_name": "ncf"} if args.model == "NCF" else {}))


@dataclass
class StressRun:
    """One run's printed line (``out``) and what produced it."""

    args: argparse.Namespace
    out: dict
    model: object
    params: dict
    engine: object
    points: np.ndarray
    full: object = None


def _log(msg: str) -> None:
    print(f"stress: {msg}", file=sys.stderr, flush=True)


def run(args, train: RatingDataset, log=None) -> StressRun:
    """Train, time the queries and (``--full_space``) probe the full
    engine on an already synthesised split; ``args`` from
    :func:`parser`. Returns the run with its JSON line (not printed)."""
    from fia_tpu_torch.data.synthetic import sample_heldout_pairs
    from fia_tpu_torch.eval.rq2 import time_influence_queries
    from fia_tpu_torch.train.trainer import Trainer, TrainConfig

    dev = resolve_device(args.backend)
    users, items, rows, steps, n_q, batch = shapes(args)
    k = args.embed_size
    # physical devices of the job (virtual slots are not devices)
    devices = pmesh.process_count() * (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    mesh = stress_mesh(args.model_parallel, args.backend)

    model = (NCF if args.model == "NCF" else MF)(users, items, k,
                                                 weight_decay=1e-3)
    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device=dev)
    train_x, train_y = train.x, train.y
    if dist.spans_processes(mesh):
        # every process synthesised the same split (same seed): place it
        # on this process's slots and train on the first one's copy
        me = pmesh.process_index()
        first = next(j for j, s in enumerate(mesh.devices.flat)
                     if int(s.process_index) == me)
        train_x = dist.put_global(mesh, torch.as_tensor(train_x))[first]
        train_y = dist.put_global(mesh, torch.as_tensor(train_y))[first]

    tr = Trainer(model, TrainConfig(batch_size=batch, num_steps=steps,
                                    learning_rate=1e-2), event_log=log,
                 device=dev)
    t0 = time.perf_counter()
    state = tr.fit(tr.init_state(params), train_x, train_y)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    step_ms = 1e3 * train_s / max(steps, 1)
    _log(f"{steps} train steps in {train_s:.1f}s ({step_ms:.2f} ms/step)")

    engine = stress_engine(args, model, state.params, train, mesh,
                           args.backend)
    points = sample_heldout_pairs(train.x, users, items, n_q, seed=17)
    timing = time_influence_queries(engine, points, repeats=3)
    out = {
        "metric": f"stress-ml20m-scale influence ({args.model} k={k})",
        "value": round(timing.scores_per_sec, 1),
        "unit": "scores/sec",
        "details": {
            "backend": dev.type,
            "devices": devices,
            "model": args.model,
            "model_parallel": args.model_parallel,
            "users": users, "items": items, "train_rows": rows,
            "train_stream": args.stream,
            "train_step_ms": round(step_ms, 3),
            "queries_per_sec": round(timing.queries_per_sec, 2),
            "per_query_ms": round(timing.per_query_ms, 3),
            "compile_s": round(timing.compile_time_s, 2),
            "num_queries": timing.num_queries,
            "num_scores": timing.num_scores,
        },
    }
    res = StressRun(args, out, model, state.params, engine, points)
    if args.full_space:
        out["details"]["full_space"] = full_space_probe(
            args, res, train, mesh)
    if log is not None:
        log.log("query_batch", **timing.json())
    return res


def full_space_probe(args, res: StressRun, train, mesh) -> dict:
    """The full-parameter engine on the first query: test gradient, CG
    solve, every row scored (timed together, the first call included),
    then the solve's relative residual (one more HVP) timed apart, as in
    the reference."""
    from fia_tpu_torch.influence.full import FullInfluenceEngine

    fe = res.full = FullInfluenceEngine(
        res.model, res.params, train, damping=1e-4, solver="cg",
        cg_maxiter=args.cg_maxiter, hvp_batch=args.hvp_batch, mesh=mesh,
        device=args.backend)
    _log(f"full-space probe ({fe.num_params} params, {fe.num_train} rows, "
         f"hvp_batch={fe.hvp_batch}, cg_maxiter={args.cg_maxiter})")
    t0 = time.perf_counter()
    v = fe._pred_grad(torch.as_tensor(np.asarray(res.points[:1]))
                      .to(fe.device))
    ihvp = fe.get_inverse_hvp(v)
    scores = fe._score_all(ihvp).cpu().numpy()
    fs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = fe.relative_residual(v, ihvp)
    res_s = time.perf_counter() - t0
    _log(f"full-space query in {fs_s:.1f}s (incl. first call); rel "
         f"residual {rr:.2e} (+{res_s:.1f}s)")
    return {
        "num_params": fe.num_params,
        "cg_maxiter": args.cg_maxiter,
        "hvp_batch": fe.hvp_batch,
        "e2e_incl_compile_s": round(fs_s, 2),
        "finite": bool(np.isfinite(scores).all()),
        "rel_residual": round(rr, 6),
        "residual_extra_s": round(res_s, 2),
    }


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dist.initialize(coordinator_address=args.coordinator,
                    num_processes=args.num_processes,
                    process_id=args.process_id)
    dev = resolve_device(args.backend)

    from fia_tpu_torch.utils.logging import EventLog

    users, items, rows, *_ = shapes(args)
    _log(f"{users} users x {items} items, {rows} rows, "
         f"k={args.embed_size}, backend={dev.type}")
    t0 = time.perf_counter()
    train = synthesize(args, users, items, rows)
    _log(f"synthesized ({args.stream}) in "
         f"{time.perf_counter() - t0:.1f}s")
    # virtual 'model' slots over one device where fewer are visible
    slots = dist.runtime_info(dev.type).local_device_count
    armed = (pmesh.virtual_devices(args.model_parallel)
             if slots < args.model_parallel else contextlib.nullcontext())
    log = EventLog(os.path.join("output", "events-stress.jsonl"))
    try:
        with armed:
            res = run(args, train, log)
        log.log("run_done", value=res.out["value"])
    finally:
        log.close()
    print(json.dumps(res.out))
    return res.out


if __name__ == "__main__":
    main()
