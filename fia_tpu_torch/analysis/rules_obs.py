"""FIA402 — bare ``print(`` in library code.

Everything under ``fia_tpu_torch/`` except the CLI mains writes no stdout:
stdout is the machine-readable surface (the bench JSON line, the serve
CLI's response stream), and a stray ``print`` in library code either
corrupts that stream or vanishes into a log nobody reads. Human-facing
diagnostics route through :func:`fia_tpu_torch.obs.diag` instead — one call
lands the note on stderr, bumps ``diag_total{channel=...}`` in the
metrics registry, and attaches a span event to the active trace, so
the message survives in every export the obs spine has.

Deliberate stdout contracts (the trainer's interactive step progress,
the reference-format model-eval report) carry an inline justified
suppression — which doubles as documentation of *why* that line owns
stdout.
"""

from __future__ import annotations

import ast

from fia_tpu_torch.analysis import config
from fia_tpu_torch.analysis.core import FileRule, Finding, SourceFile, register
from fia_tpu_torch.analysis.visitor import call_name


@register
class BarePrintRule(FileRule):
    """Bare print() in fia_tpu_torch/ library code (diagnostics go via obs)."""

    id = "FIA402"
    name = "bare-print-in-library"

    def check(self, sf: SourceFile):
        rel = sf.rel
        if not rel.startswith(config.OBS_PRINT_SCOPE):
            return []
        if any(rel.startswith(p)
               for p in config.OBS_PRINT_EXEMPT_PREFIXES):
            return []
        findings: list[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and call_name(node) == "print":
                findings.append(Finding(
                    self.id, rel, node.lineno, node.col_offset,
                    "bare print() in library code — route diagnostics "
                    "through fia_tpu_torch.obs.diag (stderr + metrics counter "
                    "+ span event) or the JSONL event stream; stdout "
                    "belongs to CLI mains",
                ))
        return findings
