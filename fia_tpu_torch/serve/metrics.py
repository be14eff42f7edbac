"""Serving metrics: per-request JSONL events and latency rollups (copy
of ``fia_tpu/serve/metrics.py``: the same schema, so the reference's
readers, ``scripts/latency_report.py`` and ``python -m fia_tpu.cli.obs``,
read the port's files unchanged).

Schema (one JSON object per line, via utils/logging.EventLog — every
record carries ``t``, a wall-clock epoch-seconds stamp):

``serve.request`` — one line per finished request::

    {"t": ..., "event": "serve.request", "id": ..., "user": u,
     "item": i, "status": "ok"|"rejected", "reason": null|"deadline"|
     "overload"|"invalid"|<taxonomy kind>, "tier": null|"hot"|"disk"|
     "compute", "queue_wait_ms": f, "solve_ms": f,
     "batch_id": n|null, "batch_size": n|null,
     "approx": bool, "err_bound": f|null,
     "class": "interactive"|"batch"|"scavenger", "tenant": s|null}

``approx``/``err_bound`` are the certified-approximate stamp
(docs/design.md §22): True marks an answer served from the subsampled
``sampled`` rung (a brownout miss, or any dispatch on a
solver='sampled' engine) and ``err_bound`` carries its concentration
bound on the per-row score error. Exact answers log ``false``/null.

``serve.batch`` — one line per micro-batch dispatch::

    {"event": "serve.batch", "batch_id": n, "size": n,
     "total_rows": n, "solve_ms": f, "status": "ok"|<reason>}

``serve.rollup`` — the aggregate summary (also returned by
:meth:`ServeMetrics.rollup`)::

    {"event": "serve.rollup", "requests": n, "ok": n,
     "rejected": {reason: n}, "tiers": {tier: n}, "hot_hit_rate": f,
     "queue_wait_ms": {"p50": f, "p95": f, "max": f},
     "solve_ms": {"p50": f, "p95": f, "max": f},
     "batches": n, "mean_batch_size": f, "cache": {...},
     "modes": {mode: n}, "mode_transitions": n,
     "device_loss_recoveries": n, "host_loss_recoveries": n,
     "answered_approx": n,
     "classes": {cls: {"requests": n, "ok": n, "rejected": {reason: n},
                       "answered_approx": n, "queue_wait_ms": {...}}}}

``serve.mode`` — one line per brownout-ladder transition
(docs/reliability.md "Degraded modes")::

    {"event": "serve.mode", "from": mode, "to": mode, "tick": n,
     "error_rate": f, "queue_frac": f}

``scripts/latency_report.py`` renders a human report from these lines;
the schema is the stable surface operators build dashboards on.
"""

from __future__ import annotations

import numpy as np

from fia_tpu_torch.obs.export import span_fields
from fia_tpu_torch.obs.registry import REGISTRY
from fia_tpu_torch.obs.trace import TRACER
from fia_tpu_torch.serve.request import Response
from fia_tpu_torch.utils.logging import EventLog

# The declared event schema — THE stable surface operators build
# dashboards on, field for field the reference's (whose linter
# cross-checks every emit against it). `t` and `event` are implicit on
# every record.
SCHEMA = {
    "serve.request": (
        "id", "user", "item", "status", "reason", "tier",
        "queue_wait_ms", "solve_ms", "batch_id", "batch_size", "mode",
        "approx", "err_bound", "class", "tenant",
    ),
    "serve.batch": (
        "batch_id", "size", "total_rows", "solve_ms", "status",
    ),
    "serve.rollup": (
        "requests", "ok", "rejected", "tiers", "hot_hit_rate",
        "queue_wait_ms", "solve_ms", "batches", "mean_batch_size",
        "cache", "modes", "mode_transitions", "device_loss_recoveries",
        "host_loss_recoveries", "answered_approx", "classes",
    ),
    # one line per brownout-ladder transition (serve/health.py): the
    # windowed signal values that drove the step, for post-mortems
    "serve.mode": ("from", "to", "tick", "error_rate", "queue_frac"),
    # streaming updates (docs/design.md §17): one line per
    # apply_updates attempt, and one per epoch-fenced serving swap with
    # its surgical-invalidation accounting
    "stream.update": (
        "update_id", "status", "reason", "steps", "new_rows",
        "base_step", "resumed_step", "touched_users", "touched_items",
        "staleness_ms", "seconds",
    ),
    "stream.swap": (
        "epoch", "wholesale", "hot_rekeyed", "hot_dropped",
        "disk_rekeyed", "disk_dropped",
    ),
    # surgical factor-bank refresh on a params/train change
    "factor.refresh": ("kept", "dropped", "model_key"),
    # audit subsystem (docs/design.md §23): one line per reverse
    # top-k sweep over the training stream ...
    "audit.sweep": (
        "sweep_id", "test_points", "train_rows", "rows_scored",
        "chunks", "k", "seconds", "rows_per_s",
    ),
    # ... and one per live unlearning apply (removal/reweight flowed
    # through the epoch-fenced stream loop)
    "audit.apply": (
        "plan_id", "action", "status", "reason", "rows_removed",
        "rows_reweighted", "predicted_delta", "steps",
        "touched_users", "touched_items", "seconds",
    ),
}


def _pcts(values: list[float]) -> dict:
    if not values:
        return {"p50": 0.0, "p95": 0.0, "max": 0.0}
    a = np.asarray(values, np.float64)
    return {
        "p50": round(float(np.percentile(a, 50)), 3),
        "p95": round(float(np.percentile(a, 95)), 3),
        "max": round(float(a.max()), 3),
    }


class ServeMetrics:
    """Accumulates per-request records and mirrors them to JSONL.

    ``path``: JSONL file (falsy disables the file, rollups still work).
    """

    def __init__(self, path: str | None = None):
        self.log = EventLog(path)
        self.queue_wait_ms: list[float] = []
        self.solve_ms: list[float] = []
        self.by_status: dict[str, int] = {}
        self.by_reason: dict[str, int] = {}
        self.by_tier: dict[str, int] = {}
        self.by_mode: dict[str, int] = {}
        self.batch_sizes: list[int] = []
        self.mode_transitions = 0
        self.device_loss_recoveries = 0
        self.host_loss_recoveries = 0
        self.answered_approx = 0
        self.err_bounds: list[float] = []  # stamped bounds, ok+approx
        # per-class accounting (multi-tenant rollup "classes" block):
        # class -> {"requests", "ok", "rejected": {reason: n},
        #           "approx", queue-wait samples}
        self.by_class: dict[str, dict] = {}

    def record_request(self, resp: Response) -> None:
        self.by_status[resp.status] = self.by_status.get(resp.status, 0) + 1
        if resp.reason:
            self.by_reason[resp.reason] = (
                self.by_reason.get(resp.reason, 0) + 1
            )
        if resp.cache_tier:
            self.by_tier[resp.cache_tier] = (
                self.by_tier.get(resp.cache_tier, 0) + 1
            )
        if resp.mode:
            self.by_mode[resp.mode] = self.by_mode.get(resp.mode, 0) + 1
        if resp.ok:
            self.queue_wait_ms.append(resp.queue_wait_s * 1e3)
            self.solve_ms.append(resp.solve_s * 1e3)
        # per-class lane accounting (the multi-tenant fairness surface)
        cls = resp.cls or "none"
        lane = self.by_class.setdefault(cls, {
            "requests": 0, "ok": 0, "rejected": {}, "approx": 0,
            "queue_wait_ms": [],
        })
        lane["requests"] += 1
        if resp.ok:
            lane["ok"] += 1
            lane["queue_wait_ms"].append(resp.queue_wait_s * 1e3)
            if resp.approx:
                lane["approx"] += 1
        elif resp.reason:
            lane["rejected"][resp.reason] = (
                lane["rejected"].get(resp.reason, 0) + 1
            )
        # mirror into the process-wide obs registry: the per-rung /
        # per-mode µs histograms scripts/latency_report.py renders
        # p50/p99 from (via the obs.metrics snapshot line)
        mode = resp.mode or "none"
        REGISTRY.counter(
            "serve.requests_total", status=resp.status, mode=mode
        ).inc()
        if resp.reason:
            REGISTRY.counter(
                "serve.rejects_total", reason=resp.reason).inc()
            REGISTRY.counter(
                "serve.rejects_by_class_total",
                **{"reason": resp.reason, "class": cls}).inc()
        if resp.ok and resp.approx:
            # certified-approximate answers (the sampled rung): counted
            # per mode so brownout salvage is visible next to the
            # degraded-shed counter it replaces
            self.answered_approx += 1
            if resp.err_bound is not None:
                self.err_bounds.append(float(resp.err_bound))
            REGISTRY.counter("serve.approx_total", mode=mode).inc()
        if resp.ok:
            solver = resp.extra.get("solver") or "none"
            REGISTRY.histogram(
                "serve.queue_wait_us", mode=mode
            ).observe(resp.queue_wait_s * 1e6)
            REGISTRY.histogram(
                "serve.solve_by_mode_us", mode=mode
            ).observe(resp.solve_s * 1e6)
            REGISTRY.histogram(
                "serve.solve_by_solver_us", solver=solver
            ).observe(resp.solve_s * 1e6)
            # class-labelled twins of the latency histograms: NEW
            # series (the mode/solver-labelled ones above are a pinned
            # surface), rendered per class by scripts/latency_report.py
            REGISTRY.histogram(
                "serve.queue_wait_by_class_us", **{"class": cls}
            ).observe(resp.queue_wait_s * 1e6)
            REGISTRY.histogram(
                "serve.solve_by_class_us", **{"class": cls}
            ).observe(resp.solve_s * 1e6)
            if resp.cache_tier:
                REGISTRY.counter(
                    "serve.tier_total", tier=resp.cache_tier).inc()
        self.log.log("serve.request", **resp.json(include_payload=False))

    def record_batch(self, batch_id: int, size: int, total_rows: int,
                     solve_s: float, status: str = "ok") -> None:
        self.batch_sizes.append(int(size))
        self.log.log(
            "serve.batch", batch_id=batch_id, size=int(size),
            total_rows=int(total_rows),
            solve_ms=round(solve_s * 1e3, 3), status=status,
        )

    def record_mode(self, **fields) -> None:
        """One ``serve.mode`` line (a brownout-ladder transition)."""
        self.mode_transitions += 1
        self.log.log("serve.mode", **fields)

    def record_device_loss_recovery(self) -> None:
        """Count one completed mesh-shrink recovery (no event line of
        its own — the ``mesh.rebuild`` site and the rollup carry it)."""
        self.device_loss_recoveries += 1

    def record_host_loss_recovery(self) -> None:
        """Count one completed host-drop mesh-shrink recovery (no event
        line of its own — the ``host.lost`` / ``mesh.rebuild_multihost``
        sites and the rollup carry it)."""
        self.host_loss_recoveries += 1

    def record_update(self, **fields) -> None:
        """One ``stream.update`` line (an apply_updates attempt)."""
        self.log.log("stream.update", **fields)

    def record_swap(self, **fields) -> None:
        """One ``stream.swap`` line (an epoch-fenced serving swap)."""
        self.log.log("stream.swap", **fields)

    def record_factor_refresh(self, **fields) -> None:
        """One ``factor.refresh`` line (surgical bank revalidation)."""
        self.log.log("factor.refresh", **fields)

    def record_audit_sweep(self, **fields) -> None:
        """One ``audit.sweep`` line (a reverse top-k sweep)."""
        self.log.log("audit.sweep", **fields)

    def record_audit_apply(self, **fields) -> None:
        """One ``audit.apply`` line (a live unlearning apply)."""
        self.log.log("audit.apply", **fields)

    def rollup(self, cache_stats: dict | None = None) -> dict:
        n = sum(self.by_status.values())
        hot = self.by_tier.get("hot", 0)
        served = sum(self.by_tier.values())
        out = {
            "requests": n,
            "ok": self.by_status.get("ok", 0),
            "rejected": dict(self.by_reason),
            "tiers": dict(self.by_tier),
            "hot_hit_rate": round(hot / served, 4) if served else 0.0,
            "queue_wait_ms": _pcts(self.queue_wait_ms),
            "solve_ms": _pcts(self.solve_ms),
            "batches": len(self.batch_sizes),
            "mean_batch_size": round(
                float(np.mean(self.batch_sizes)), 2
            ) if self.batch_sizes else 0.0,
            "modes": dict(self.by_mode),
            "mode_transitions": self.mode_transitions,
            "device_loss_recoveries": self.device_loss_recoveries,
            "host_loss_recoveries": self.host_loss_recoveries,
            "answered_approx": self.answered_approx,
            # per-class lanes: the same accounting identity holds per
            # class (requests == ok + Σ rejected within each lane)
            "classes": {
                cls: {
                    "requests": lane["requests"],
                    "ok": lane["ok"],
                    "rejected": dict(lane["rejected"]),
                    "answered_approx": lane["approx"],
                    "queue_wait_ms": _pcts(lane["queue_wait_ms"]),
                }
                for cls, lane in sorted(self.by_class.items())
            },
        }
        if cache_stats is not None:
            out["cache"] = dict(cache_stats)
        return out

    def log_rollup(self, cache_stats: dict | None = None) -> dict:
        r = self.rollup(cache_stats)
        self.log.log("serve.rollup", **r)
        return r

    def flush_obs(self) -> None:
        """Drain the tracer's finished spans into the JSONL stream
        (one ``obs.span`` line each — obs/events.py SCHEMA). The
        service calls this once per drain; a falsy metrics path makes
        it a queue drain with no file writes."""
        for sp in TRACER.flush():
            self.log.log("obs.span", **span_fields(sp))

    def close(self) -> None:
        self.flush_obs()
        # final registry snapshot: the ``obs.metrics`` line the CLI's
        # ``prom`` renderer and the latency report's histogram
        # sections read (deterministic series order)
        self.log.log("obs.metrics", snapshot=REGISTRY.snapshot())
        self.log.close()
