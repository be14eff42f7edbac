"""Finding reporters: terminal lines and machine-readable JSON."""

from __future__ import annotations

import json

from fia_tpu_torch.analysis.core import LintResult, all_rules


def terminal_report(result: LintResult) -> str:
    """One `path:line:col: RULE message` line per finding + summary."""
    lines = [f.render() for f in result.findings]
    counts = ", ".join(
        f"{rid}={n}" for rid, n in sorted(
            result.as_dict()["counts"].items()
        )
    )
    if result.findings:
        lines.append(
            f"fialint: {len(result.findings)} finding(s) in "
            f"{result.files_checked} file(s) [{counts}]"
            + (f"; {len(result.suppressed)} suppressed"
               if result.suppressed else "")
        )
    else:
        lines.append(
            f"fialint: OK ({result.files_checked} file(s) clean"
            + (f", {len(result.suppressed)} justified suppression(s)"
               if result.suppressed else "")
            + ")"
        )
    return "\n".join(lines)


def json_report(result: LintResult) -> str:
    """Deterministic JSON document (stable key order, sorted findings)."""
    return json.dumps(result.as_dict(), indent=1, sort_keys=True)


def rule_catalog() -> str:
    """`RULEID name — summary` lines for --list-rules."""
    out = []
    for rid, rule in sorted(all_rules().items()):
        out.append(f"{rid} {rule.name} — {rule.describe()}")
    return "\n".join(out)
