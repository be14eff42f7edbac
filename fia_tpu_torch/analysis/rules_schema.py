"""FIA401 — serving metrics schema consistency.

``serve/metrics.py`` declares the stable event schema (``SCHEMA``:
event name → field names) that operators build dashboards on;
``scripts/latency_report.py`` declares what it reads (``CONSUMES``).
This rule cross-checks the two against each other and against the
actual ``EventLog.log(...)`` call sites in ``fia_tpu_torch/serve/``, so a
renamed field or a new event can't silently decouple the producer
from the report:

- every event literal logged under ``fia_tpu_torch/serve/`` must be a
  ``SCHEMA`` key;
- statically visible keyword fields at those call sites must be
  declared for that event;
- every event/field in ``CONSUMES`` must exist in ``SCHEMA``.

Since the obs spine landed the checked schema is the UNION of the
serving ``SCHEMA`` and the obs event schema
(``fia_tpu_torch/obs/events.py`` ``SCHEMA`` — the ``obs.span`` /
``obs.metrics`` lines the service mirrors into the same JSONL
stream), and the consumer side covers every declared consumer
(``config.OBS_CONSUMERS``: the latency report plus the
``fia_tpu_torch.cli.obs`` reader), in BOTH directions:

- each consumer's ``CONSUMES`` ⊆ the union schema (a renamed field
  breaks the reader loudly);
- every ``obs.*`` event in the obs schema is consumed by at least one
  declared consumer (an event nobody reads is dead weight on the hot
  path).

Extra consumers and the obs schema are checked only when their files
exist under the lint root, so foreign/synthetic trees lint clean.

``t`` and ``event`` are implicit (EventLog stamps them on every
record).
"""

from __future__ import annotations

import ast
import os

from fia_tpu_torch.analysis import config, core
from fia_tpu_torch.analysis.core import Finding, ProjectRule, SourceFile, register
from fia_tpu_torch.analysis.visitor import const_str, literal_or_none


def _load_decl(root: str, rel: str, name: str):
    """literal_eval a module-level ``NAME = {...}`` declaration.

    Returns ``(mapping, lineno)`` or ``(None, reason)``. The module
    comes from the invocation parse cache (``core.parsed_module``) —
    the schema/consumer files are already in the lint file set, so
    this never re-parses them from disk.
    """
    tree = core.parsed_module(root, rel)
    if tree is None:
        return None, f"{rel} missing or unparseable"
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
        ):
            value = literal_or_none(node.value)
            if isinstance(value, dict):
                return (
                    {str(k): frozenset(v) for k, v in value.items()},
                    node.lineno,
                )
            return None, f"{rel}:{node.lineno} {name} is not a literal dict"
    return None, f"{rel} declares no module-level {name}"


def _log_calls(sf: SourceFile):
    """(node, event_literal, visible_kwarg_names) for EventLog-style
    ``*.log("event.name", field=...)`` calls."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "log"):
            continue
        if not node.args:
            continue
        event = const_str(node.args[0])
        if event is None or "." not in event:
            continue  # not a schema'd serving event
        kwargs = {kw.arg for kw in node.keywords if kw.arg is not None}
        yield node, event, kwargs


@register
class MetricsSchemaRule(ProjectRule):
    """Emitted serving events and the latency report must agree."""

    id = "FIA401"
    name = "metrics-schema-drift"

    def check_project(self, files: list[SourceFile], root: str):
        findings: list[Finding] = []
        in_scope = [
            sf for sf in files
            if sf.tree is not None and config.METRICS_SCOPE in sf.rel
        ]
        schema, schema_ref = _load_decl(
            root, config.METRICS_MODULE, "SCHEMA"
        )
        if schema is None:
            # only demand the declaration when serving code is actually
            # being linted — foreign trees have no serving schema
            if in_scope:
                findings.append(Finding(
                    self.id, config.METRICS_MODULE, 1, 0,
                    "missing serving metrics schema declaration: "
                    f"{schema_ref}",
                ))
            return findings
        implicit = config.METRICS_IMPLICIT_FIELDS

        # obs extension: union in the tracing/metrics event schema when
        # present (absent in synthetic/foreign trees — plain serve-only
        # checking then)
        obs_schema: dict = {}
        if os.path.exists(os.path.join(root, config.OBS_MODULE)):
            obs_schema, obs_ref = _load_decl(
                root, config.OBS_MODULE, "SCHEMA"
            )
            if obs_schema is None:
                findings.append(Finding(
                    self.id, config.OBS_MODULE, 1, 0,
                    f"missing obs event schema declaration: {obs_ref}",
                ))
                obs_schema = {}
        union = {**schema, **obs_schema}

        # producer side: every .log("x.y", ...) in the serving subtree
        for sf in in_scope:
            for node, event, kwargs in _log_calls(sf):
                if event not in union:
                    findings.append(Finding(
                        self.id, sf.rel, node.lineno, node.col_offset,
                        f"event {event!r} is not declared in "
                        f"{config.METRICS_MODULE} SCHEMA (or the obs "
                        f"schema at {config.OBS_MODULE})",
                    ))
                    continue
                undeclared = sorted(kwargs - union[event] - implicit)
                if undeclared:
                    findings.append(Finding(
                        self.id, sf.rel, node.lineno, node.col_offset,
                        f"event {event!r} emits undeclared field(s) "
                        f"{', '.join(undeclared)} (add to SCHEMA or drop)",
                    ))

        # consumer side: each declared consumer's CONSUMES ⊆ the union
        # schema. The latency report is mandatory (the original
        # contract); extra obs consumers are checked when present.
        consumers = [config.METRICS_CONSUMER] + [
            c for c in config.OBS_CONSUMERS
            if c != config.METRICS_CONSUMER
            and os.path.exists(os.path.join(root, c))
        ]
        consumed_events: set[str] = set()
        for rel in consumers:
            consumes, c_ref = _load_decl(root, rel, "CONSUMES")
            if consumes is None:
                findings.append(Finding(
                    self.id, rel, 1, 0,
                    f"missing consumer declaration: {c_ref}",
                ))
                continue
            consumed_events |= set(consumes)
            for event, fields in sorted(consumes.items()):
                if event not in union:
                    findings.append(Finding(
                        self.id, rel, 1, 0,
                        f"consumer {rel} reads unknown event {event!r}",
                    ))
                    continue
                missing = sorted(set(fields) - union[event] - implicit)
                if missing:
                    findings.append(Finding(
                        self.id, rel, 1, 0,
                        f"consumer {rel} reads field(s) "
                        f"{', '.join(missing)} that {event!r} does not "
                        f"emit (SCHEMA at "
                        f"{config.METRICS_MODULE}:{schema_ref})",
                    ))

        # reverse direction: every obs.* event someone emits must have
        # at least one declared reader — an exported event nobody
        # consumes is hot-path weight with no dashboard behind it
        for event in sorted(set(obs_schema) - consumed_events):
            findings.append(Finding(
                self.id, config.OBS_MODULE, 1, 0,
                f"obs event {event!r} is declared but no consumer "
                f"({', '.join(consumers)}) reads it — wire it into a "
                "CONSUMES or drop the event",
            ))
        return findings
