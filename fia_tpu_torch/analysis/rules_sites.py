"""FIA301/302/303 — fault-site integrity.

The reliability layer's value rests on two registries staying honest:
the injection-site names (a typo'd site is a fault plan that silently
never fires — the recovery path the test believes it covers never
runs) and the failure taxonomy (an unclassifiable raise in a
reliability-threaded path is retried blindly or surfaces as an
unhandled crash instead of a recovery decision).

- **FIA301 unregistered-site** — every *string literal* passed as a
  site to ``inject.fire`` / ``inject.corrupt`` / ``inject.damage``, as
  a ``site=`` keyword (``artifacts.publish_npz``), or as the first
  argument of ``inject.Fault(...)`` must be a member of
  ``fia_tpu_torch/reliability/sites.py``'s ``ALL_SITES``. References through
  the ``sites.*`` constants are checked against the same registry.
- **FIA302 untyped-reliability-raise** — ``raise`` statements in
  ``fia_tpu_torch/reliability/`` must use a taxonomy-classifiable or
  reliability-owned exception type (``config.RELIABILITY_RAISABLE``).
- **FIA303 site-docs-drift** — the "Injection-site registry" table in
  ``docs/reliability.md`` must list every registered site, and must
  not list sites that no longer exist.
"""

from __future__ import annotations

import ast
import os
import re

from fia_tpu_torch.analysis import config, core
from fia_tpu_torch.analysis.core import (
    FileRule,
    Finding,
    ProjectRule,
    SourceFile,
    register,
)
from fia_tpu_torch.analysis.visitor import call_name, const_str


def load_site_registry(root: str) -> tuple[set[str], set[str]] | None:
    """Read sites.py's registry from the invocation parse cache.

    Returns ``(site_names, constant_names)`` — the string values in
    ``ALL_SITES``-style constants and the constant identifiers — or
    None when the module is missing/unparseable. Both FIA301 and
    FIA303 need this, so the parsed module comes from
    :func:`core.current_context` (one parse per lint run, shared
    across rules) and the *registry extraction* itself is memoized.
    """
    ctx = core.current_context()
    if ctx is not None and ctx.root == root:
        return ctx.memo("sites-registry", lambda: _extract_registry(root))
    return _extract_registry(root)


def _extract_registry(root: str) -> tuple[set[str], set[str]] | None:
    tree = core.parsed_module(root, config.SITES_MODULE)
    if tree is None:
        return None
    names: set[str] = set()
    constants: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
        ):
            value = const_str(node.value)
            if value is not None:
                names.add(value)
                constants.add(node.targets[0].id)
    return names, constants


_SITE_CALLEES = {
    "inject.fire": 0,
    "inject.corrupt": 0,
    "inject.damage": 0,
    "inject.Fault": 0,
    "Fault": 0,
    "inject.call_count": 0,
    "sites.check": 0,
}


def _site_literals(node: ast.Call) -> list[tuple[ast.AST, str]]:
    """(node, literal) pairs for site-position string literals."""
    out: list[tuple[ast.AST, str]] = []
    cn = call_name(node)
    if cn in _SITE_CALLEES and node.args:
        s = const_str(node.args[_SITE_CALLEES[cn]])
        if s is not None:
            out.append((node.args[0], s))
    for kw in node.keywords:
        if kw.arg == "site":
            s = const_str(kw.value)
            if s is not None:
                out.append((kw.value, s))
    return out


@register
class UnregisteredSiteRule(ProjectRule):
    """Injection-site literals must resolve to the checked-in registry."""

    id = "FIA301"
    name = "unregistered-site"

    def check_project(self, files: list[SourceFile], root: str):
        reg = load_site_registry(root)
        findings: list[Finding] = []
        if reg is None:
            # only demand a registry when the linted files actually
            # name injection sites — a tree without fault injection
            # has nothing to register
            if any(
                sf.tree is not None and self._uses_sites(sf)
                for sf in files
            ):
                findings.append(Finding(
                    self.id, config.SITES_MODULE, 1, 0,
                    "site registry missing or unparseable "
                    f"(expected at {config.SITES_MODULE})",
                ))
            return findings
        site_names, constant_names = reg
        for sf in files:
            if sf.tree is None or sf.rel.endswith("reliability/sites.py"):
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                for anchor, lit in _site_literals(node):
                    if lit not in site_names:
                        findings.append(Finding(
                            self.id, sf.rel, anchor.lineno,
                            anchor.col_offset,
                            f"injection site {lit!r} is not registered "
                            f"in {config.SITES_MODULE}",
                        ))
                # sites.FOO attribute references: constant must exist
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    if (isinstance(arg, ast.Attribute)
                            and isinstance(arg.value, ast.Name)
                            and arg.value.id == "sites"
                            and call_name(node) in _SITE_CALLEES
                            and arg.attr not in constant_names
                            and arg.attr != "check"):
                        findings.append(Finding(
                            self.id, sf.rel, arg.lineno, arg.col_offset,
                            f"sites.{arg.attr} is not defined in the "
                            "site registry",
                        ))
        return findings

    @staticmethod
    def _uses_sites(sf: SourceFile) -> bool:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and (
                call_name(node) in _SITE_CALLEES
            ):
                return True
        return False


@register
class ReliabilityRaiseRule(FileRule):
    """Raises in reliability/ must be taxonomy-classifiable types."""

    id = "FIA302"
    name = "untyped-reliability-raise"

    def check(self, sf: SourceFile):
        if config.RELIABILITY_PREFIX not in sf.rel:
            return []
        findings: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue  # bare re-raise is fine
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            name = None
            if isinstance(exc, ast.Name):
                name = exc.id
            elif isinstance(exc, ast.Attribute):
                name = exc.attr
            if name is not None and name not in config.RELIABILITY_RAISABLE:
                findings.append(Finding(
                    self.id, sf.rel, node.lineno, node.col_offset,
                    f"raise of {name} in a reliability-threaded path — "
                    "use a taxonomy-classifiable type "
                    "(DeadlineExpired/NanPayload/ArtifactIntegrityError/"
                    "JournalMismatch) or a contract error "
                    "(ValueError/TypeError)",
                ))
        return findings


_DOC_SITE_RE = re.compile(r"`([a-z_]+\.[a-z_]+)`")


@register
class SiteDocsDriftRule(ProjectRule):
    """docs/reliability.md's site table must match the registry."""

    id = "FIA303"
    name = "site-docs-drift"

    def check_project(self, files: list[SourceFile], root: str):
        reg = load_site_registry(root)
        if reg is None:
            return []  # FIA301 already reports the missing registry
        site_names, _ = reg
        doc_path = os.path.join(root, config.SITES_DOC)
        findings: list[Finding] = []
        try:
            with open(doc_path, encoding="utf-8") as fh:
                doc = fh.read()
        except OSError:
            findings.append(Finding(
                self.id, config.SITES_DOC, 1, 0,
                f"site documentation missing (expected {config.SITES_DOC})",
            ))
            return findings
        documented: dict[str, int] = {}
        in_table = False
        for lineno, line in enumerate(doc.splitlines(), start=1):
            if line.startswith("## "):
                in_table = "Injection-site registry" in line
            if in_table and line.lstrip().startswith("|"):
                for m in _DOC_SITE_RE.finditer(line):
                    documented.setdefault(m.group(1), lineno)
        for site in sorted(site_names - set(documented)):
            findings.append(Finding(
                self.id, config.SITES_DOC, 1, 0,
                f"registered site {site!r} is missing from the "
                "'Injection-site registry' table",
            ))
        for site, lineno in sorted(documented.items()):
            if site not in site_names:
                findings.append(Finding(
                    self.id, config.SITES_DOC, lineno, 0,
                    f"documented site {site!r} is not in the registry "
                    "(stale table row?)",
                ))
        return findings
