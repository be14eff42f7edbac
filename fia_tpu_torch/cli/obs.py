"""Observability CLI: render the obs event stream a service wrote (port
of ``fia_tpu/cli/obs.py``: on the same file, the same output bytes and
exit codes).

Reads the JSONL file a :class:`~fia_tpu_torch.serve.service.InfluenceService`
(or either package's service) produced — ``obs.span`` lines interleaved with the
``serve.*`` stream, plus the final ``obs.metrics`` registry snapshot —
and renders it three ways:

- ``report PATH`` — trace-completeness audit (every ok ``serve.request``
  root must carry its full admit→queue→batch→dispatch→solver chain)
  plus a registry summary: per-solver-rung and per-mode latency
  percentiles, counters, gauges. Exits nonzero on incomplete chains,
  so a gate can rest on it.
- ``trace PATH [--last N] [--out FILE]`` — Chrome/Perfetto
  ``trace_event`` JSON (open in ui.perfetto.dev); ``--last N`` keeps
  only the N most recent traces by first-span time.
- ``prom PATH`` — Prometheus text exposition of the last
  ``obs.metrics`` snapshot in the file.

Run:  python -m fia_tpu_torch.cli.obs report output/serve-MF-synthetic.jsonl
      python -m fia_tpu_torch.cli.obs trace output/serve-MF-synthetic.jsonl \\
          --last 20 --out /tmp/trace.json
      python -m fia_tpu_torch.cli.obs prom output/serve-MF-synthetic.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from fia_tpu_torch.obs.export import perfetto, prometheus, read_spans
from fia_tpu_torch.obs.registry import percentile_from_snapshot

# What this CLI reads, per event — the emitted schemas' fields
# (serve/metrics.py SCHEMA ∪ obs/events.py SCHEMA), which lint rule
# FIA401 cross-checks both ways (its port is ROADMAP A.14b). Keep it a
# literal dict.
CONSUMES = {
    "obs.span": ("trace", "span", "parent", "name", "t0", "dur_us",
                 "attrs", "events"),
    "obs.metrics": ("snapshot",),
}

# The complete span chain every served (ok) request must carry,
# in seq order under the serve.request root (serve/service.py
# _trace_request); rejected requests stop after serve.queue.
REQUEST_CHAIN = ("serve.request", "serve.admit", "serve.queue",
                 "serve.batch", "serve.dispatch", "serve.solver")
REJECT_CHAIN = REQUEST_CHAIN[:3]


def last_snapshot(path: str) -> dict | None:
    """The final ``obs.metrics`` snapshot in the file (the service
    writes one on close; later ones supersede earlier)."""
    snap = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from a killed process
            if d.get("event") == "obs.metrics":
                snap = d.get("snapshot")
    return snap


def audit_chains(spans: list[dict]) -> dict:
    """Group request spans by trace and check chain completeness."""
    by_trace: dict[str, dict[str, dict]] = {}
    for s in spans:
        if s["name"].startswith("serve.") and s["name"] in REQUEST_CHAIN:
            by_trace.setdefault(s["trace"], {})[s["name"]] = s
    ok = rejected = incomplete = 0
    broken: list[str] = []
    for trace, chain in by_trace.items():
        root = chain.get("serve.request")
        if root is None:
            incomplete += 1
            broken.append(trace)
            continue
        want = (REQUEST_CHAIN
                if (root.get("attrs") or {}).get("status") == "ok"
                else REJECT_CHAIN)
        if all(n in chain for n in want):
            if len(want) == len(REQUEST_CHAIN):
                ok += 1
            else:
                rejected += 1
        else:
            incomplete += 1
            broken.append(trace)
    return {"requests": len(by_trace), "ok_complete": ok,
            "rejected_complete": rejected, "incomplete": incomplete,
            "broken_traces": broken[:10]}


def _hist_rows(snap: dict, prefix: str) -> list[tuple[str, dict]]:
    return [(k, h) for k, h in snap.get("histograms", {}).items()
            if k.startswith(prefix)]


def _print_hist_block(title: str, rows: list[tuple[str, dict]]) -> None:
    if not rows:
        return
    print(title)
    for key, h in rows:
        label = key.split("{", 1)[1][:-1] if "{" in key else key
        p50 = percentile_from_snapshot(h, 50) / 1e3
        p99 = percentile_from_snapshot(h, 99) / 1e3
        print(f"  {label:<24} n={h['count']:<6} "
              f"p50={p50:.2f}ms  p99={p99:.2f}ms")


def cmd_report(args) -> int:
    spans = read_spans(args.path)
    snap = last_snapshot(args.path)
    if not spans and snap is None:
        print(f"no obs events in {args.path}", file=sys.stderr)
        return 1
    audit = audit_chains(spans)
    print(f"spans: {len(spans)}  request traces: {audit['requests']}  "
          f"ok-complete: {audit['ok_complete']}  "
          f"rejected-complete: {audit['rejected_complete']}  "
          f"incomplete: {audit['incomplete']}")
    if audit["broken_traces"]:
        print(f"  broken: {', '.join(audit['broken_traces'])}")
    if snap is not None:
        _print_hist_block("solve by solver rung:",
                          _hist_rows(snap, "serve.solve_by_solver_us"))
        _print_hist_block("solve by serving mode:",
                          _hist_rows(snap, "serve.solve_by_mode_us"))
        _print_hist_block("queue wait by mode:",
                          _hist_rows(snap, "serve.queue_wait_us"))
        counters = snap.get("counters", {})
        if counters:
            print("counters:")
            for k in sorted(counters):
                print(f"  {k} = {counters[k]:g}")
        gauges = snap.get("gauges", {})
        if gauges:
            print("gauges:")
            for k in sorted(gauges):
                print(f"  {k} = {gauges[k]:g}")
    return 1 if audit["incomplete"] else 0


def cmd_trace(args) -> int:
    spans = read_spans(args.path)
    if not spans:
        print(f"no obs.span lines in {args.path}", file=sys.stderr)
        return 1
    if args.last:
        first_t0: dict[str, float] = {}
        for s in spans:
            tid = s["trace"]
            if tid not in first_t0 or s["t0"] < first_t0[tid]:
                first_t0[tid] = s["t0"]
        keep = set(sorted(first_t0, key=first_t0.get)[-args.last:])
        spans = [s for s in spans if s["trace"] in keep]
    doc = perfetto(spans)
    if args.out:
        from fia_tpu_torch.utils.io import save_json_atomic

        save_json_atomic(args.out, doc)
        print(f"{len(doc['traceEvents'])} trace events -> {args.out}",
              file=sys.stderr)
    else:
        print(json.dumps(doc))
    return 0


def cmd_prom(args) -> int:
    snap = last_snapshot(args.path)
    if snap is None:
        print(f"no obs.metrics snapshot in {args.path}", file=sys.stderr)
        return 1
    sys.stdout.write(prometheus(snap))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fia_tpu_torch.cli.obs",
        description=__doc__.split("\n\n", 1)[0],
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("report", help="chain audit + registry summary")
    p.add_argument("path")
    p.set_defaults(fn=cmd_report)
    p = sub.add_parser("trace", help="Perfetto trace_event JSON")
    p.add_argument("path")
    p.add_argument("--last", type=int, default=0,
                   help="keep only the N most recent traces")
    p.add_argument("--out", default="",
                   help="write JSON here instead of stdout")
    p.set_defaults(fn=cmd_trace)
    p = sub.add_parser("prom", help="Prometheus text snapshot")
    p.add_argument("path")
    p.set_defaults(fn=cmd_prom)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
