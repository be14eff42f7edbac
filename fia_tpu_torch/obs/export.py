"""Exporters: JSONL span fields, Perfetto trace JSON, Prometheus text
(copy of ``fia_tpu/obs/export.py``; the same output bytes).

Three render targets over the same data:

- ``span_fields`` / ``read_spans`` — the JSONL wire form
  (``obs.span`` lines, interleaved with any other event lines).
- ``perfetto`` — Chrome/Perfetto ``trace_event`` JSON (load in
  ui.perfetto.dev or chrome://tracing); one row per trace, complete
  ("ph":"X") events with µs timestamps normalised to the first span.
- ``prometheus`` — text exposition format over a registry snapshot
  (``# TYPE`` lines, ``_bucket{le=...}``/``_sum``/``_count`` for
  histograms), for scrape-style integration without a client lib.
"""

from __future__ import annotations

import json

from fia_tpu_torch.obs.registry import US_BUCKETS


def span_fields(sp) -> dict:
    """JSONL field dict for one finished span (the ``obs.span``
    payload — keep in sync with obs/events.py SCHEMA)."""
    return {
        "trace": sp.trace_id,
        "span": sp.span_id,
        "parent": sp.parent_id,
        "name": sp.name,
        "t0": round(sp.t0, 6),
        "dur_us": round((sp.t1 - sp.t0) * 1e6, 1),
        "attrs": dict(sp.attrs),
        "events": list(sp.events),
    }


def read_spans(path: str) -> list[dict]:
    """All ``obs.span`` records from a JSONL file (torn tail lines
    from a killed process are skipped)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("event") == "obs.span":
                out.append(d)
    return out


def perfetto(spans: list[dict]) -> dict:
    """Chrome ``trace_event`` JSON from JSONL span dicts.

    Each distinct trace id becomes one ``tid`` row (first-seen order,
    which is deterministic given a deterministic span stream); ``ts``
    is µs since the earliest span so the viewer opens at t=0.
    """
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_min = min(s["t0"] for s in spans)
    tids: dict[str, int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s["trace"], len(tids) + 1)
        args = dict(s.get("attrs") or {})
        if s.get("events"):
            args["events"] = s["events"]
        args["span"] = s["span"]
        if s.get("parent"):
            args["parent"] = s["parent"]
        events.append({
            "name": s["name"],
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": round((s["t0"] - t_min) * 1e6, 1),
            "dur": s["dur_us"],
            "cat": s["name"].split(".", 1)[0],
            "args": args,
        })
    meta = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": f"trace {trace_id}"}}
        for trace_id, tid in tids.items()
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _prom_name(series: str) -> tuple[str, str]:
    """Split a registry series key into (metric_name, label_block).
    Dots become underscores — Prometheus metric-name charset."""
    if "{" in series:
        name, rest = series.split("{", 1)
        labels = rest[:-1]  # drop trailing }
        block = "{" + ",".join(
            f'{kv.split("=", 1)[0]}="{kv.split("=", 1)[1]}"'
            for kv in labels.split(",")
        ) + "}"
    else:
        name, block = series, ""
    return name.replace(".", "_"), block


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def prometheus(snapshot: dict) -> str:
    """Text exposition format for a Registry.snapshot() dict. Series
    arrive pre-sorted from the snapshot, so output is deterministic."""
    lines: list[str] = []
    typed: set[str] = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for series, val in snapshot.get("counters", {}).items():
        name, block = _prom_name(series)
        _type(name, "counter")
        lines.append(f"{name}{block} {_fmt(val)}")
    for series, val in snapshot.get("gauges", {}).items():
        name, block = _prom_name(series)
        _type(name, "gauge")
        lines.append(f"{name}{block} {_fmt(val)}")
    buckets = snapshot.get("buckets_us", list(US_BUCKETS))
    for series, h in snapshot.get("histograms", {}).items():
        name, block = _prom_name(series)
        _type(name, "histogram")
        inner = block[1:-1] if block else ""
        cum = 0
        for bound, c in zip(buckets, h["counts"]):
            cum += c
            lab = f"le=\"{_fmt(bound)}\""
            lab = f"{inner},{lab}" if inner else lab
            lines.append(f"{name}_bucket{{{lab}}} {cum}")
        lab = 'le="+Inf"'
        lab = f"{inner},{lab}" if inner else lab
        lines.append(f"{name}_bucket{{{lab}}} {h['count']}")
        lines.append(f"{name}_sum{block} {_fmt(h['sum'])}")
        lines.append(f"{name}_count{block} {h['count']}")
    return "\n".join(lines) + "\n"
