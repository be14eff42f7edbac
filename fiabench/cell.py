"""One run of one cell: set-up, the measured window, the check.

The traffic is a closed loop of one client: it hands the next job to
``InfluenceEngine.query_many`` as soon as the previous one has returned
its results to the host, until ``seconds`` have passed; the job then in
flight finishes the window. The engine is built with the direct solver,
no cache directory and no factor bank, over a ``data`` mesh of the
cell's cards where it asks for more than one.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from fiabench import check, data, reference, roofline
from fiabench.devtrace import Trace
from fiabench.spec import metric_reader

#: the share of the window after which the traced run starts profiling
#: (at a job boundary), and the most it profiles
PROFILE_FROM, PROFILE_MAX_S = 0.4, 3.0


def _engine(cfg: dict, ratings, params: dict, chips: int, device: str):
    """The program under test over this run's data and weights."""
    from fia_tpu_torch import models
    from fia_tpu_torch.data.dataset import RatingDataset
    from fia_tpu_torch.influence.engine import InfluenceEngine
    from fia_tpu_torch.parallel import mesh as pmesh

    model = getattr(models, cfg["port_model"])(
        cfg["num_users"], cfg["num_items"], cfg["embedding_size"],
        cfg["weight_decay"])
    mesh = pmesh.make_mesh(chips, device=device) if chips > 1 else None
    return InfluenceEngine(model, params, RatingDataset(ratings.x, ratings.y),
                           damping=cfg["damping"], solver="direct",
                           cache_dir=None, mesh=mesh,
                           device=None if mesh is not None else device)


def _batches(job: np.ndarray, size: int) -> list[np.ndarray]:
    return [job[i:i + size] for i in range(0, len(job), size)]


def launches(eng, ratings, job: np.ndarray, size: int, chips: int) -> list:
    """The ``roofline.Launch`` of every query shard ``job`` dispatches:
    the engine's geometry of each batch, and the work of the shard's
    queries counted from the ratings (shards of ⌈T / chips⌉ queries)."""
    out = []
    for b in _batches(job, size):
        t_pad, s_pad = eng.flat_geometry(b)
        q = -(-len(b) // chips)
        for k in range(chips):
            sh = b[k * q:(k + 1) * q]
            if not len(sh):
                continue
            nu = ratings.user_deg[sh[:, 0]]
            ni = ratings.item_deg[sh[:, 1]]
            both = ratings.pair_rows(sh[:, 0], sh[:, 1])
            out.append(roofline.Launch(
                t_pad, s_pad, len(sh), int((nu + ni).sum()),
                int((nu + both).sum()), int((ni + both).sum()),
                int(2 * both.sum())))
    return out


def _sync(devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(spec, name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        keep: bool = False):
    """One run of workload ``name``; returns the result line's object
    (without ``device``'s platform fields, which ``run.py`` adds), and
    with ``keep`` also ``(cfg, params, ratings, sample)``, what the check
    compared (for ``calibrate.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.workload(name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    chips = int(cell["chips"])
    limits = check.load_limits(name)
    with contextlib.ExitStack() as stack:
        if device == "cpu" and chips > 1:
            from fia_tpu_torch.parallel import mesh as pmesh
            stack.enter_context(pmesh.virtual_devices(chips))
        out, kept = _run(spec, cell, cfg, traffic, chips, limits, seed,
                         seconds, trace, device, t_start)
    return (out, kept) if keep else out


def _run(spec, cell, cfg, traffic, chips, limits, seed, seconds, trace,
         device, t_start):
    from fia_tpu_torch import obs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device(device)
    t0 = time.perf_counter()
    ratings = data.load_ratings(cfg)
    jobs = data.job_pool(ratings, traffic)
    order = data.JobOrder(len(jobs), seed)
    params = reference.make_params(cfg, seed, dev0)
    eng = _engine(cfg, ratings, params, chips, device)
    devs = sorted({dev0, *eng._devices()}, key=str)
    _sync(devs)
    data_s = time.perf_counter() - t0

    bq, win = int(traffic["batch_queries"]), int(traffic["window"])
    geoms = sorted({eng.flat_geometry(b) for job in jobs
                    for b in _batches(job, bq)})
    pre = eng.precompile_flat(geoms)
    t_warm = time.perf_counter()
    eng.query_many(jobs[order[0]], batch_queries=bq, window=win)  # warm
    _sync(devs)
    warm_s = time.perf_counter() - t_warm
    captures0 = len(eng._programs)
    keeper = check.Keeper(int(traffic["job_queries"]), seed)
    if trace:
        obs.configure(trace=True)
        obs.TRACER.flush()
    prof, prof_jobs, prof_path = None, [], None

    # -- the window -------------------------------------------------------
    lat, scores = [], 0
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    print(f"fiabench: set-up {setup_s:.3f} s: before the data "
          f"{t0 - t_start:.3f}, data and engine {data_s:.3f}, "
          f"{len(geoms)} geometries {pre['seconds']:.3f}, warm job "
          f"{warm_s:.3f}", file=sys.stderr, flush=True)
    j = 0
    while True:
        now = time.perf_counter()
        if now - w0 >= seconds:
            break
        if trace and prof is None and now - w0 >= PROFILE_FROM * seconds:
            prof = _profiler(devs)
            prof.__enter__()
            p0 = now
        job = jobs[order[j]]
        a = time.perf_counter()
        res = eng.query_many(job, batch_queries=bq, window=win)
        lat.append(time.perf_counter() - a)
        scores += int(sum(int(r.counts.sum()) for r in res))
        keeper.take(j, job, res)
        del res
        if prof is not None and prof_path is None:
            prof_jobs.append(job)
            if time.perf_counter() - p0 >= min(PROFILE_MAX_S,
                                               0.3 * seconds):
                prof_path = _stop(prof, devs)
        j += 1
    w1 = time.perf_counter()
    if prof is not None and prof_path is None:
        prof_path = _stop(prof, devs)
    window_s = w1 - w0

    peak = max(torch.cuda.max_memory_allocated(d) for d in devs
               if d.type == "cuda") if device == "cuda" else 0
    ctx = {"cell": cell, "config": cfg, "traffic": traffic, "chips": chips,
           "latencies_s": lat, "window_s": window_s, "scores": scores,
           "setup_s": setup_s, "data_s": data_s, "precompile": pre,
           "captures_in_window": len(eng._programs) - captures0,
           "peak_bytes": peak, "d": eng.model.block_size}
    if trace:
        ctx["spans"] = [(s.name, s.t0, s.t1) for s in obs.TRACER.flush()]
        obs.configure(trace=False)
        ctx["launches"] = [ln for job in prof_jobs
                           for ln in launches(eng, ratings, job, bq, chips)]
        ctx["trace"] = None
        if prof_path is not None:
            ctx["trace"] = Trace.load(prof_path)
            os.unlink(prof_path)
    del eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    sample = keeper.sample()
    t_check = time.perf_counter()
    readings = check.compare(cfg, params, ratings, sample, dev0)
    readings["nonfinite"] = keeper.nonfinite
    print(f"fiabench: checked {len(sample)} queries in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr,
          flush=True)
    correct, checks = check.judge(readings, limits)

    metrics = {}
    for m in spec.metrics(cell["name"], trace):
        v = _value(m["name"], ctx, trace)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": j, "failed": keeper.failed_jobs,
           "metrics": metrics,
           "device": {"count": chips, "memory_peak_bytes": int(peak)},
           "compared": {k: readings[k] for k in (
               "compared", "kink_excused", "ihvp_err", "score_err",
               "worst_cond")}}
    if trace and ctx["trace"] is not None:
        tr = ctx["trace"]
        busy = [tr.busy_s(c) for c in tr.cards()]
        out["device"]["busy_s"] = sum(busy) / max(len(busy), 1)
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out, (cfg, params, ratings, sample)


def _value(name: str, ctx: dict, trace: bool):
    """An end-to-end metric from the harness's clock, or a per-layer
    metric from its reader."""
    if not trace:
        if name == "scores_per_s":
            return ctx["scores"] / ctx["window_s"]
        if name == "job_p95_ms":
            lat = ctx["latencies_s"]
            if len(lat) < 2:
                return 1e3 * max(lat)
            return 1e3 * statistics.quantiles(lat, n=20,
                                              method="inclusive")[18]
        if name == "setup_s":
            return ctx["setup_s"]
        raise KeyError(f"no end-to-end metric {name!r}")
    return metric_reader(name)(ctx)


def _profiler(devs):
    from torch.profiler import ProfilerActivity, profile

    _sync(devs)
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devs):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _stop(prof, devs) -> str:
    _sync(devs)
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path
