"""The host time of each step of the flat pipeline in an untraced run.

    python3 fiabench/spanstat.py --workload <name> --seed N [--seconds 15]

One run of the cell with the engine's obs spans on from the start and no
profiler (the benchmark's untraced run, plus the spans' own cost), then
the spans of each window job after the first, grouped by step and by
their place in the job: the first batch's dispatch and finalize against
the others'. Prints the run's result line, then one ``SPANSTAT`` line:
per ``<span>|first`` or ``<span>|rest``, the count, median, 90th
percentile and sum a job in milliseconds; ``job``, the whole
``engine.query_many``; ``caller_between_jobs``, the host's time from one
job's end to the next's start. Needs the card.

The tracer's export queue is bounded, so a long window drops its oldest
spans; the run then fails rather than read a partial window (shorten
``--seconds``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the steps whose spans are ranked by their place in the job
STEPS = ("engine.dispatch_flat", "engine.finalize_flat")


def _quant(v: list, jobs: int) -> dict:
    v = sorted(v)
    return {"n": len(v), "median": statistics.median(v),
            "p90": v[int(0.9 * (len(v) - 1))], "sum_per_job": sum(v) / jobs}


def stats(spans) -> dict:
    """``SPANSTAT``'s object from the finished spans of one run: the first
    ``engine.query_many`` (set-up's warm job) and the window's first job
    are left out."""
    by_trace = defaultdict(list)
    for s in spans:
        by_trace[s.trace_id].append(s)
    roots = sorted((s for s in spans if s.name == "engine.query_many"),
                   key=lambda s: s.t0)[2:]
    times = defaultdict(list)
    for r in roots:
        mine = sorted(by_trace[r.trace_id], key=lambda s: s.t0)
        seq = {s.seq: s for s in mine}
        rank = {}
        for step in STEPS:
            for k, s in enumerate(x for x in mine if x.name == step):
                rank[s.seq] = k
        for s in mine:
            if s is r:
                continue
            top = s if s.seq in rank else seq.get(s.parent_seq)
            k = rank.get(top.seq, 0) if top is not None else 0
            times[f"{s.name}|{'first' if k == 0 else 'rest'}"].append(
                1e3 * (s.t1 - s.t0))
        times["job"].append(1e3 * (r.t1 - r.t0))
    for a, b in zip(roots, roots[1:]):
        times["caller_between_jobs"].append(1e3 * (b.t0 - a.t1))
    return {k: _quant(v, max(len(roots), 1))
            for k, v in sorted(times.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    from fia_tpu_torch import obs
    from fiabench import cell
    from fiabench.spec import Spec

    torch.set_num_threads(1)
    obs.configure(trace=True)
    out = cell.run(Spec(), args.workload, args.seed, args.seconds, False,
                   device="cuda", t_start=T_START)
    spans = obs.TRACER.flush()
    obs.configure(trace=False)
    print(json.dumps(out), flush=True)
    jobs = sum(s.name == "engine.query_many" for s in spans)
    if jobs != out["attempted"] + 1:  # the warm job, then the window's
        print(f"spanstat: {jobs} jobs' spans for {out['attempted']} + 1 "
              "jobs run: the tracer dropped the oldest; shorten --seconds",
              file=sys.stderr)
        return 1
    print("SPANSTAT " + json.dumps(stats(spans)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
