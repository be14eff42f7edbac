"""Online influence-query serving driver (port of
``fia_tpu/cli/serve.py``).

Turns a trained model into a stdin/stdout JSONL service backed by
:class:`fia_tpu_torch.serve.InfluenceService`: one request object per input
line (``{"user": u, "item": i, "id": ..., "deadline_s": ...}`` — bare
``u i`` pairs are accepted too), one response object per output line
(the ``serve.request`` schema of fia_tpu_torch/serve/metrics.py plus the
score payload). It runs on the card unless ``--backend cpu`` is given;
``--mesh N`` serves over a ``data`` mesh of N slots.

Modes (checked in this order; ``--warmup`` composes with the others):

- ``--warmup N``: build (on the card, capture as CUDA graphs) the flat
  dispatch geometries of the micro-batches the scheduler would plan for
  N representative test points, then dispatch those batches once. Exits
  nonzero when any planned geometry is left unbuilt — a cold geometry
  would otherwise pay its capture inside someone's latency budget.
  Standalone it reports and exits; combined with ``--smoke_requests``
  or the stdin loop it arms the caches first and the traffic mode runs
  on a warm hot path that builds nothing.
- ``--smoke_requests N``: self-contained synthetic open-loop stream — N
  queries over the test split with a repeat-heavy hot set — then a
  latency/cache report. Exits nonzero unless every request either
  succeeded or was rejected with a classified reason, and the hot tier
  actually absorbed repeats (the reference's CI gate, ``make serve-smoke``).
- default: the stdin loop, draining after every ``--drain_every`` lines
  (micro-batching needs a queue; a pipe full of requests provides one).

Run:  python -m fia_tpu_torch.cli.serve --dataset synthetic --model MF \
        --num_steps_train 300 --warmup 32 --train_dir /tmp/serve-smoke
"""

from __future__ import annotations

import json
import sys

import numpy as np

from fia_tpu_torch.cli import common
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.reliability import taxonomy
from fia_tpu_torch.serve import InfluenceService, Request, ServeConfig


def add_serve_flags(p):
    p.add_argument("--max_batch", type=int, default=1024,
                   help="mega-batch coalescing cap per device dispatch "
                        "(big fused dispatches amortize the host "
                        "dispatch wall; dial down when p50 latency "
                        "matters more than throughput)")
    p.add_argument("--max_queue", type=int, default=4096,
                   help="admission bound: queued requests beyond this "
                        "are rejected with reason 'overload'")
    p.add_argument("--cache_entries", type=int, default=1024,
                   help="hot-block LRU capacity (solved (u,i) blocks)")
    p.add_argument("--coalesce", choices=["bucket", "fifo"],
                   default="bucket",
                   help="dispatch order: pad-bucket sorted or arrival")
    p.add_argument("--request_deadline", type=float, default=0.0,
                   help="default per-request budget in seconds "
                        "(0 = unbounded); expired requests are rejected "
                        "with reason 'deadline'")
    p.add_argument("--disk_cache", type=int, default=1,
                   help="1: verified on-disk tier under --train_dir")
    p.add_argument("--metrics", type=str, default="auto",
                   help="serving metrics JSONL path; 'auto' derives one "
                        "under --train_dir, 'none' disables")
    p.add_argument("--drain_every", type=int, default=32,
                   help="stdin mode: drain the queue every N lines")
    p.add_argument("--warmup", type=int, default=0,
                   help="build the planned dispatch geometries over N "
                        "test points ahead of serving (nonzero exit "
                        "when a planned geometry is left unbuilt); "
                        "alone: report and exit, with a traffic mode: "
                        "arm first, then serve warm")
    p.add_argument("--smoke_requests", type=int, default=0,
                   help="run an N-request synthetic smoke stream, "
                        "report, exit (nonzero on failure)")
    p.add_argument("--smoke_hot_frac", type=float, default=0.5,
                   help="smoke stream: fraction of requests drawn from "
                        "a small hot set of repeated queries")
    p.add_argument("--class_quota", action="append", default=None,
                   metavar="CLASS=FRAC",
                   help="per-class queue quota as a fraction of "
                        "--max_queue (repeatable, e.g. "
                        "--class_quota scavenger=0.25); defaults keep "
                        "interactive/batch at 1.0 and scavenger at 0.5")
    p.add_argument("--class_weight", action="append", default=None,
                   metavar="CLASS=W",
                   help="fair-queueing DRR weight per class "
                        "(repeatable; defaults interactive=8 batch=3 "
                        "scavenger=1)")
    p.add_argument("--smoke_class_mix", type=str, default="",
                   help="smoke stream tenant mix, e.g. "
                        "'interactive=0.2,batch=0.5,scavenger=0.3' "
                        "(empty = unclassed legacy stream)")
    p.add_argument("--trace", type=int, default=0,
                   help="1: per-request span tracing — obs.span lines "
                        "interleave into the metrics JSONL, in the "
                        "reference's schema (docs/observability.md)")
    return p


def _parse_class_kv(pairs, cast) -> dict | None:
    """``["scavenger=0.25", ...]`` → {"scavenger": 0.25} (None in/out
    passthrough; validation happens in the serve layer)."""
    if not pairs:
        return None
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        out[k.strip()] = cast(v)
    return out


def build_service(args):
    """Model + engine + service from the shared CLI plumbing."""
    if getattr(args, "trace", 0):
        from fia_tpu_torch import obs

        obs.configure(trace=True)
    common.apply_backend(args)
    mesh = common.mesh_for(args)
    splits = common.load_splits(args)
    model, params = common.build_model(args, splits)
    name = common.model_name_for(args, splits=splits)
    _, state, _ = common.train_or_load(args, model, params, splits,
                                       verbose=False)
    engine = InfluenceEngine(
        model, state.params, splits["train"],
        cache_dir=args.train_dir, model_name=name,
        mesh=mesh, **common.engine_kwargs(args),
    )
    metrics = args.metrics
    if metrics == "none":
        metrics = None
    elif metrics == "auto":
        import os

        metrics = os.path.join(
            args.train_dir, f"serve-{args.model}-{args.dataset}.jsonl"
        )
    cfg = ServeConfig(
        max_batch=args.max_batch, max_queue=args.max_queue,
        cache_entries=args.cache_entries, coalesce=args.coalesce,
        default_deadline_s=args.request_deadline or None,
        disk_cache=bool(args.disk_cache), metrics_path=metrics,
        mesh=mesh,
        class_quotas=_parse_class_kv(
            getattr(args, "class_quota", None), float),
        class_weights=_parse_class_kv(
            getattr(args, "class_weight", None), int),
    )
    try:
        svc = InfluenceService(engine=engine, config=cfg)
    except Exception as e:
        # construction validates mesh liveness + fingerprint; report a
        # classified failure as an operator-readable line and a clean
        # nonzero exit, never a raw backend traceback
        kind = taxonomy.classify(e)
        if kind is None:
            raise
        line = {"event": "serve.construct_failed", "kind": kind,
                "error": str(e)}
        # the liveness probe names the dead mesh slots (and whole hosts)
        if getattr(e, "devices", None):
            line["devices"] = [int(d) for d in e.devices]
        if getattr(e, "hosts", None):
            line["hosts"] = [int(h) for h in e.hosts]
        print(json.dumps(line), file=sys.stderr)
        raise SystemExit(1)
    return svc, splits


def parse_request(line: str) -> Request | None:
    """One stdin line → Request (JSON object or bare ``u i``), None on
    blank lines."""
    line = line.strip()
    if not line:
        return None
    if line.startswith("{"):
        d = json.loads(line)
        kw = {}
        if d.get("class") is not None:
            kw["cls"] = str(d["class"])
        if d.get("tenant") is not None:
            kw["tenant"] = str(d["tenant"])
        return Request(user=int(d["user"]), item=int(d["item"]),
                       id=d.get("id"), deadline_s=d.get("deadline_s"),
                       **kw)
    parts = line.split()
    return Request(user=int(parts[0]), item=int(parts[1]))


def smoke_stream(test_x, n: int, hot_frac: float, seed: int,
                 class_mix: str = ""):
    """A repeat-heavy synthetic request stream over the test split:
    ``hot_frac`` of requests revisit a small hot set (what a real
    serving workload looks like, and what makes hot-tier hits
    assertable). ``class_mix`` ('cls=frac,...') samples a priority
    class per request from the given distribution; empty keeps the
    unclassed legacy stream."""
    rng = np.random.default_rng(seed)
    hot = test_x[rng.choice(len(test_x), size=max(4, n // 25),
                            replace=False)]
    classes, probs = None, None
    if class_mix:
        mix = _parse_class_kv(class_mix.split(","), float)
        classes = list(mix)
        total = sum(mix.values())
        probs = [mix[c] / total for c in classes]
    out = []
    for k in range(n):
        if rng.random() < hot_frac:
            u, i = hot[rng.integers(len(hot))]
        else:
            u, i = test_x[rng.integers(len(test_x))]
        kw = {}
        if classes:
            kw["cls"] = classes[int(rng.choice(len(classes), p=probs))]
            kw["tenant"] = f"t-{kw['cls']}"
        out.append(Request(user=int(u), item=int(i), id=f"smoke{k}",
                           **kw))
    return out


def run_smoke(svc: InfluenceService, splits, args) -> int:
    reqs = smoke_stream(np.asarray(splits["test"].x), args.smoke_requests,
                        args.smoke_hot_frac, args.seed,
                        class_mix=getattr(args, "smoke_class_mix", ""))
    responses = svc.run(reqs, drain_every=args.max_batch)
    report = svc.close()
    print(json.dumps({"event": "serve.smoke", **report}))

    failures = []
    unreasoned = [r for r in responses
                  if not r.ok and not r.reason]
    unresolved = len(reqs) - len(responses)
    if unreasoned or unresolved:
        failures.append(
            f"{len(unreasoned)} rejected without reason, "
            f"{unresolved} never resolved"
        )
    if svc.cache.stats.hits_hot <= 0:
        failures.append("hot-block cache never hit on a repeat-heavy "
                        "stream")
    if report["ok"] + sum(report["rejected"].values()) != len(reqs):
        failures.append("request accounting does not add up")
    for cls, lane in report.get("classes", {}).items():
        if lane["ok"] + sum(lane["rejected"].values()) != lane["requests"]:
            failures.append(f"class {cls!r} accounting does not add up")
    for f in failures:
        print(f"SMOKE FAIL: {f}", file=sys.stderr)
    if not failures:
        print(f"serve smoke ok: {report['ok']}/{len(reqs)} served, "
              f"hot hits {svc.cache.stats.hits_hot}, "
              f"p95 solve {report['solve_ms']['p95']}ms")
    return 1 if failures else 0


def run_warmup(svc: InfluenceService, splits, args) -> int:
    pts = np.asarray(splits["test"].x[: args.warmup], np.int64)
    info = svc.warmup(pts)
    print(json.dumps({"event": "serve.warmup", **info}))
    if not info["all_planned_compiled"]:
        print("WARMUP FAIL: planned dispatch geometries left "
              f"unbuilt (planned {info['planned_geometries']}, "
              f"aot {info['aot']})", file=sys.stderr)
        return 1
    return 0


def run_stdin(svc: InfluenceService, args) -> int:
    n = 0
    for line in sys.stdin:
        req = parse_request(line)
        if req is None:
            continue
        r = svc.submit(req)
        if r is not None:  # immediate rejection
            print(json.dumps(r.json()), flush=True)
        n += 1
        if args.drain_every and n % args.drain_every == 0:
            for resp in svc.drain():
                print(json.dumps(resp.json()), flush=True)
    for resp in svc.drain():
        print(json.dumps(resp.json()), flush=True)
    report = svc.close()
    print(json.dumps({"event": "serve.rollup.final", **report}),
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = add_serve_flags(common.base_parser(__doc__))
    args = p.parse_args(argv)
    svc, splits = build_service(args)
    if args.warmup:
        rc = run_warmup(svc, splits, args)
        if rc or not args.smoke_requests:
            return rc
    if args.smoke_requests:
        return run_smoke(svc, splits, args)
    return run_stdin(svc, args)


if __name__ == "__main__":
    raise SystemExit(main())
