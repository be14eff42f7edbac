"""Lint-engine core: findings, rule registry, suppressions, the run.

The port's copy of ``fia_tpu/analysis/core.py``. The engine is
deliberately dependency-free (stdlib ``ast`` only) so it can run before
anything heavy imports: importing it loads no ``torch``, and
``python -m fia_tpu_torch.analysis.lint --self-check`` gates the port's
tree from ``tests/test_torch_analysis.py``.

Architecture:

- :class:`SourceFile` — one parsed file: source text, AST, and the
  per-line suppression map parsed from ``# fialint:`` comments.
- :class:`FileRule` — checks one file at a time (most rules).
- :class:`ProjectRule` — checks cross-file invariants (site registry
  vs docs, emitted metrics schema vs consumer) and runs once per
  invocation over every collected file plus the repo root.
- :func:`lint_paths` — the entry point: collect, parse, run rules, apply
  suppressions, return a :class:`LintResult`.

Suppression syntax (justification REQUIRED)::

    risky_call()  # fialint: disable=FIA101 -- one-line justification

or, when the justification doesn't fit inline, as a standalone comment
line immediately above the flagged statement::

    # fialint: disable=FIA101 -- one-line justification
    risky_call()

A suppression with no ``-- justification`` tail, an unknown rule id,
or an empty justification is itself a finding (``FIA001``) — the
acceptance bar is "clean modulo *justified* suppressions", so the
engine enforces the justification, not convention.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

# Rule ids the engine itself emits (not registered rules).
PARSE_ERROR = "FIA000"
BAD_SUPPRESSION = "FIA001"

_SUPPRESS_RE = re.compile(
    r"#\s*fialint:\s*disable=(?P<rules>[A-Za-z0-9_,\s]*?)"
    r"(?:\s*--\s*(?P<why>.*?))?\s*$"
)

_RULE_ID_RE = re.compile(r"^FIA\d{3}$")


@dataclass(frozen=True)
class Finding:
    """One lint violation, anchored to a repo-relative location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclass
class SourceFile:
    """A parsed source file plus its suppression map."""

    path: str  # absolute
    rel: str  # repo-relative, posix separators
    text: str
    tree: ast.AST | None
    # line -> rule ids suppressed on that line
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    # engine-level findings discovered while parsing (FIA000/FIA001)
    engine_findings: list[Finding] = field(default_factory=list)


class Rule:
    """Base: ``id`` like ``FIA101``, ``name`` a short kebab slug."""

    id: str = ""
    name: str = ""

    def describe(self) -> str:
        return (self.__doc__ or "").strip().splitlines()[0]


class FileRule(Rule):
    def check(self, sf: SourceFile) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


class ProjectRule(Rule):
    def check_project(
        self, files: list[SourceFile], root: str
    ) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls):
    """Class decorator: add a rule to the global registry (id-unique)."""
    inst = rule_cls()
    if not _RULE_ID_RE.match(inst.id):
        raise ValueError(f"bad rule id {inst.id!r} on {rule_cls.__name__}")
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    _REGISTRY[inst.id] = inst
    return rule_cls


def all_rules() -> dict[str, Rule]:
    _load_builtin_rules()
    return dict(_REGISTRY)


_loaded = False


def _load_builtin_rules() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    # import for registration side effects
    from fia_tpu_torch.analysis import (  # noqa: F401
        rules_determinism,
        rules_io,
        rules_obs,
        rules_schema,
        rules_sites,
        rules_trace,
    )


def _comment_tokens(text: str):
    """(lineno, comment_text, standalone) for every real COMMENT token —
    docstrings and string literals that merely *mention* fialint don't
    count. ``standalone`` is True when the comment is the whole line
    (nothing but whitespace before it)."""
    lines = text.splitlines()
    try:
        toks = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                lineno, col = tok.start
                before = lines[lineno - 1][:col] if lineno <= len(lines) else ""
                yield lineno, tok.string, not before.strip()
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        return  # the parse-error finding already covers unreadable files


def parse_suppressions(sf: SourceFile) -> None:
    """Fill ``sf.suppressions`` and emit FIA001 for malformed ones."""
    for lineno, line, standalone in _comment_tokens(sf.text):
        if "fialint" not in line:
            continue
        m = _SUPPRESS_RE.search(line)
        if not m:
            sf.engine_findings.append(Finding(
                BAD_SUPPRESSION, sf.rel, lineno, 0,
                "unparseable fialint comment (expected "
                "'# fialint: disable=RULEID -- justification')",
            ))
            continue
        ids = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        why = (m.group("why") or "").strip()
        bad = [r for r in ids if not _RULE_ID_RE.match(r)
               or r not in all_rules()]
        if not ids:
            sf.engine_findings.append(Finding(
                BAD_SUPPRESSION, sf.rel, lineno, 0,
                "suppression lists no rule ids",
            ))
            continue
        if bad:
            sf.engine_findings.append(Finding(
                BAD_SUPPRESSION, sf.rel, lineno, 0,
                f"suppression names unknown rule(s): {', '.join(bad)}",
            ))
            continue
        if not why:
            sf.engine_findings.append(Finding(
                BAD_SUPPRESSION, sf.rel, lineno, 0,
                "suppression carries no justification "
                "(append ' -- why this line is exempt')",
            ))
            continue
        sf.suppressions.setdefault(lineno, set()).update(ids)
        if standalone:
            # a comment-only line shields the statement below it
            sf.suppressions.setdefault(lineno + 1, set()).update(ids)


SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "output",
             "build", "dist"}


def collect_files(paths: list[str]) -> list[str]:
    """Expand files/dirs into a sorted, de-duplicated list of .py files."""
    out: set[str] = set()
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.add(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in SKIP_DIRS and not d.startswith(".")
                )
                for fn in filenames:
                    if fn.endswith(".py"):
                        out.add(os.path.join(dirpath, fn))
    return sorted(out)


def find_root(paths: list[str]) -> str:
    """Repo root = nearest ancestor of the first path with pyproject.toml."""
    start = os.path.abspath(paths[0]) if paths else os.getcwd()
    d = start if os.path.isdir(start) else os.path.dirname(start)
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return (os.path.abspath(paths[0]) if paths else os.getcwd())
        d = parent


def _relpath(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:  # different drive (windows)
        rel = path
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


def load_source_file(path: str, root: str) -> SourceFile:
    with open(path, encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    rel = _relpath(path, root)
    sf = SourceFile(path=path, rel=rel, text=text, tree=None)
    try:
        sf.tree = ast.parse(text, filename=rel)
    except SyntaxError as e:
        sf.engine_findings.append(Finding(
            PARSE_ERROR, rel, e.lineno or 1, e.offset or 0,
            f"syntax error: {e.msg}",
        ))
    parse_suppressions(sf)
    return sf


class LintContext:
    """Per-invocation shared state: the parsed-module cache and rule
    memos.

    Before this existed every ProjectRule that needed a registry module
    (FIA301/FIA303 both parse ``sites.py``, FIA401 parses the metrics
    module, the obs schema and every consumer) re-opened and re-parsed
    it from disk once per rule invocation — even though the very same
    file was already sitting, parsed, in the invocation's file list.
    The context indexes the collected :class:`SourceFile` set by
    repo-relative path and lazily loads (then caches) anything outside
    it, so one lint run parses each file exactly once. ``memo``
    gives expensive cross-rule artifacts (the FIA5xx call-graph +
    dataflow run, shared by six rules) the same once-per-invocation
    lifetime.
    """

    def __init__(self, files: list[SourceFile], root: str):
        self.files = files
        self.root = root
        self._by_rel: dict[str, SourceFile] = {sf.rel: sf for sf in files}
        self._memos: dict[str, object] = {}

    def module(self, rel: str) -> SourceFile | None:
        """The parsed module at repo-relative ``rel`` (cached), or None
        when the file is missing. Parse failures return the SourceFile
        with ``tree=None`` — callers distinguish missing from broken."""
        sf = self._by_rel.get(rel)
        if sf is None:
            path = os.path.join(self.root, rel.replace("/", os.sep))
            if not os.path.isfile(path):
                return None
            sf = load_source_file(path, self.root)
            self._by_rel[rel] = sf
        return sf

    def memo(self, key: str, build):
        """``build()`` once per invocation, cached under ``key``."""
        if key not in self._memos:
            self._memos[key] = build()
        return self._memos[key]


# The active invocation's context. lint_paths installs one for the
# duration of the rule run; rules reach it via current_context() so the
# ProjectRule.check_project(files, root) signature stays stable.
_CONTEXT: LintContext | None = None


def current_context() -> LintContext | None:
    return _CONTEXT


def parsed_module(root: str, rel: str) -> ast.AST | None:
    """Parsed AST of the module at ``rel`` under ``root``, or None when
    missing/unparseable. Served from the active invocation's parse
    cache when one is installed (the ``lint_paths`` rule run), so
    registry modules already collected for linting are never re-read
    from disk; falls back to a direct load for standalone callers."""
    ctx = _CONTEXT
    if ctx is not None and ctx.root == root:
        sf = ctx.module(rel)
        return sf.tree if sf is not None else None
    path = os.path.join(root, rel.replace("/", os.sep))
    if not os.path.isfile(path):
        return None
    return load_source_file(path, root).tree


@dataclass
class LintResult:
    findings: list[Finding]
    suppressed: list[Finding]
    files_checked: int
    root: str

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "files_checked": self.files_checked,
            "counts": _counts(self.findings),
            "suppressed_counts": _counts(self.suppressed),
            "findings": [f.as_dict() for f in self.findings],
        }


def _counts(findings: list[Finding]) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))


def _sort_key(f: Finding):
    return (f.path, f.line, f.col, f.rule, f.message)


def lint_paths(
    paths: list[str],
    select: set[str] | None = None,
    disable: set[str] | None = None,
    root: str | None = None,
) -> LintResult:
    """Run the registered rules over ``paths``.

    ``select``: run only these rule ids. ``disable``: skip these.
    Engine findings (FIA000 parse errors, FIA001 bad suppressions) are
    always reported and never suppressible.
    """
    rules = all_rules()
    active = {
        rid: r for rid, r in rules.items()
        if (select is None or rid in select)
        and (disable is None or rid not in disable)
    }
    root = root or find_root(paths)
    files = [load_source_file(p, root) for p in collect_files(paths)]

    global _CONTEXT
    prev_ctx, _CONTEXT = _CONTEXT, LintContext(files, root)
    try:
        raw: list[Finding] = []
        for sf in files:
            raw.extend(sf.engine_findings)
            if sf.tree is None:
                continue
            for rule in active.values():
                if isinstance(rule, FileRule):
                    raw.extend(rule.check(sf))
        for rule in active.values():
            if isinstance(rule, ProjectRule):
                raw.extend(rule.check_project(files, root))
    finally:
        _CONTEXT = prev_ctx

    supp_map = {sf.rel: sf.suppressions for sf in files}
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    for f in raw:
        if f.rule in (PARSE_ERROR, BAD_SUPPRESSION):
            kept.append(f)
            continue
        ids = supp_map.get(f.path, {}).get(f.line, set())
        (suppressed if f.rule in ids else kept).append(f)
    return LintResult(
        findings=sorted(set(kept), key=_sort_key),
        suppressed=sorted(set(suppressed), key=_sort_key),
        files_checked=len(files),
        root=root,
    )
