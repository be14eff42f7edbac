"""CLI entry point: ``python -m fia_tpu_torch.analysis.lint [paths...]``.

Exit codes: 0 clean, 1 findings, 2 usage error.

Common invocations::

    python -m fia_tpu_torch.analysis.lint fia_tpu_torch/     # the package
    python -m fia_tpu_torch.analysis.lint --self-check       # the gate
    python -m fia_tpu_torch.analysis.lint --select FIA101 ... # one rule
    python -m fia_tpu_torch.analysis.lint --select FIA5 ...  # a family
    python -m fia_tpu_torch.analysis.lint --json fia_tpu_torch/
    python -m fia_tpu_torch.analysis.lint --list-rules

``--select``/``--disable`` accept exact rule ids and family *prefixes*
(``FIA5`` expands to every registered FIA5xx rule), so ``make
lint-determinism`` stays correct as the family grows.

``--self-check`` lints the port's package (``fia_tpu_torch/``, resolved
relative to the installed package, with the repository as the root) and
must come back clean — ``tests/test_torch_analysis.py`` holds it so, and
``chip_smoke.py`` runs it on the card's host.

Baseline workflow (landing a new rule warn-first)::

    python -m fia_tpu_torch.analysis.lint --self-check --write-baseline b.json
    ...                      # existing findings snapshotted, not fixed
    python -m fia_tpu_torch.analysis.lint --self-check --baseline b.json
    # exit 0: only pre-existing findings;  exit 1: NEW findings appeared

Baseline keys are line-number-insensitive (rule, path, message with
digit runs collapsed), so pure code motion doesn't churn the snapshot;
genuinely new findings in a file do.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from fia_tpu_torch.analysis.core import LintResult, all_rules, lint_paths
from fia_tpu_torch.analysis.reporters import (
    json_report,
    rule_catalog,
    terminal_report,
)

_DIGITS_RE = re.compile(r"\d+")


def _baseline_key(f) -> str:
    """Line-insensitive identity of a finding for baseline matching."""
    return f"{f.rule}|{f.path}|{_DIGITS_RE.sub('#', f.message)}"


def _baseline_counts(findings) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        k = _baseline_key(f)
        out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


def write_baseline(path: str, result: LintResult) -> None:
    doc = {"version": 1, "counts": _baseline_counts(result.findings)}
    # fialint: disable=FIA101 -- the baseline snapshot is the linter's own state file; the linter must not import the (numpy-using) atomic-io layer
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)  # fialint: disable=FIA101 -- same linter state file write
        fh.write("\n")


def apply_baseline(path: str, result: LintResult):
    """Split current findings against a snapshot.

    Returns ``(new_findings, new_groups, resolved_groups)``: findings
    whose group has MORE occurrences than the snapshot recorded (the
    whole group is shown when its count grew — the engine cannot know
    which member is the new one), plus group-level new/resolved counts.
    """
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    base = doc.get("counts", {})
    groups: dict[str, list] = {}
    for f in result.findings:
        groups.setdefault(_baseline_key(f), []).append(f)
    new_findings, new_groups = [], 0
    for k, fs in sorted(groups.items()):
        if len(fs) > base.get(k, 0):
            new_groups += 1
            new_findings.extend(fs)
    resolved = sum(1 for k, n in base.items()
                   if n > len(groups.get(k, [])))
    return new_findings, new_groups, resolved


def self_check_paths() -> tuple[list[str], str]:
    """The port's lint surface, anchored at the package location: the
    package itself, with the repository as the root (the reference's
    ``scripts/`` and ``bench.py`` belong to its own linter)."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg_dir)
    return [pkg_dir], root


def _parse_rule_set(spec: list[str] | None) -> set[str] | None:
    if not spec:
        return None
    requested: set[str] = set()
    for chunk in spec:
        requested.update(r.strip() for r in chunk.split(",") if r.strip())
    known = set(all_rules())
    out: set[str] = set()
    unknown: set[str] = set()
    for rid in requested:
        if rid in known:
            out.add(rid)
            continue
        # family prefix: FIA5 -> every registered FIA5xx rule
        family = {k for k in known if k.startswith(rid)} if (
            re.fullmatch(r"FIA\d{1,2}", rid)
        ) else set()
        if family:
            out |= family
        else:
            unknown.add(rid)
    if unknown:
        raise SystemExit(
            f"fialint: unknown rule id(s): {', '.join(sorted(unknown))} "
            f"(known: {', '.join(sorted(known))})"
        )
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fia_tpu_torch.analysis.lint",
        description="Repo-native static analysis for fia_tpu_torch "
                    "(rule catalog: docs/lint.md; capture rules: "
                    "fia_tpu_torch/analysis/rules_trace.py).",
    )
    ap.add_argument("paths", nargs="*", help="files/directories to lint")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON report instead of terminal lines")
    ap.add_argument("--select", action="append", metavar="RULES",
                    help="comma-separated rule ids to run exclusively")
    ap.add_argument("--disable", action="append", metavar="RULES",
                    help="comma-separated rule ids to skip")
    ap.add_argument("--self-check", action="store_true",
                    help="lint the port's own fia_tpu_torch/")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--baseline", metavar="PATH",
                    help="fail only on findings NOT in this snapshot")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="snapshot current findings to PATH and exit 0")
    args = ap.parse_args(argv)

    if args.baseline and args.write_baseline:
        print("fialint: --baseline and --write-baseline are mutually "
              "exclusive", file=sys.stderr)
        return 2

    if args.list_rules:
        print(rule_catalog())
        return 0

    root = None
    paths = list(args.paths)
    if args.self_check:
        sc_paths, root = self_check_paths()
        paths.extend(sc_paths)
    if not paths:
        ap.print_usage(sys.stderr)
        print("fialint: no paths given (or use --self-check)",
              file=sys.stderr)
        return 2

    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"fialint: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2

    result = lint_paths(
        paths,
        select=_parse_rule_set(args.select),
        disable=_parse_rule_set(args.disable),
        root=root,
    )

    if args.write_baseline:
        write_baseline(args.write_baseline, result)
        print(f"fialint: baseline written to {args.write_baseline} "
              f"({len(result.findings)} finding(s) snapshotted)")
        return 0

    if args.baseline:
        try:
            new, new_groups, resolved = apply_baseline(
                args.baseline, result
            )
        except (OSError, ValueError) as e:
            print(f"fialint: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        delta = LintResult(
            findings=new, suppressed=result.suppressed,
            files_checked=result.files_checked, root=result.root,
        )
        print(json_report(delta) if args.json else terminal_report(delta))
        print(f"fialint: baseline {args.baseline}: {new_groups} new "
              f"finding group(s), {resolved} resolved "
              f"({len(result.findings)} total current)",
              file=sys.stderr)
        return 0 if not new else 1

    print(json_report(result) if args.json else terminal_report(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
