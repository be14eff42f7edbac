"""Project-wide call graph over the lint file set.

The FIA2xx family polices *one function at a time*; the FIA5xx
determinism family needs to follow a value from the function where a
nondeterministic read happens to the (possibly distant) function where
its result is byte-pinned. This module builds the structure that makes
that possible without importing anything: a name-resolution index per
module (imports, from-imports, defs, classes, transform/partial
aliases) and
a resolver that turns an ``ast.Call`` inside a known function into
either a project-internal :class:`FuncDef` or a *canonical* external
dotted name (``np.random.rand`` → ``numpy.random.rand``,
``_time.monotonic`` → ``time.monotonic``).

Resolution is deliberately the same shape the FIA2xx machinery uses —
``torch.func.vmap(partial(self._f, ...))`` / ``make_graphed_callables(fn)``
wrapper chains are unwrapped to the terminal function
(``visitor._terminal_fn_name``'s logic, generalised to return the full
dotted target), so a wrapped sink is still a sink and a vmapped source
still a source.

Known limits (documented, not silent): attribute calls on arbitrary
objects (``self.journal.record``) resolve only to their bare attribute
name; instance state (``self.x = ...`` in one method, read in another)
is not tracked; subscripted callees (``self._graphs[k](...)``) do not
resolve. The dataflow layer treats unresolved calls conservatively
(argument taint passes through to the result).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from fia_tpu_torch.analysis.core import SourceFile
from fia_tpu_torch.analysis.visitor import (
    _CAPTURE_CALLEES,
    _UNWRAP_CALLEES,
    dotted_name,
)


@dataclass
class FuncDef:
    """One function/method definition in the project."""

    rel: str            # repo-relative file
    qualpath: str       # "fn", "Class.method", "outer.inner", "<module>"
    node: ast.AST       # FunctionDef/AsyncFunctionDef, or Module for
                        # the synthetic top-level pseudo-function
    sf: SourceFile
    class_name: str | None = None

    @property
    def qual(self) -> str:
        return f"{self.rel}::{self.qualpath}"

    @property
    def display(self) -> str:
        return self.qualpath if self.qualpath != "<module>" else "<module>"

    def body_statements(self) -> list[ast.stmt]:
        if isinstance(self.node, ast.Module):
            return [
                s for s in self.node.body
                if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Import,
                                      ast.ImportFrom))
            ]
        return list(self.node.body)

    def param_names(self) -> list[str]:
        if isinstance(self.node, ast.Module):
            return []
        a = self.node.args
        names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
        names += [p.arg for p in a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names


@dataclass
class ModuleInfo:
    """Per-module name-resolution tables."""

    rel: str
    sf: SourceFile
    dotted: str                          # "fia_tpu_torch.serve.cache"
    imports: dict[str, str] = field(default_factory=dict)      # alias -> module
    from_imports: dict[str, tuple[str, str]] = field(
        default_factory=dict)                    # name -> (module, attr)
    defs: dict[str, FuncDef] = field(default_factory=dict)     # qualpath -> def
    classes: dict[str, dict[str, FuncDef]] = field(
        default_factory=dict)                    # class -> {method -> def}
    bases: dict[str, list[str]] = field(default_factory=dict)  # class -> bases
    aliases: dict[str, str] = field(default_factory=dict)      # name -> qualpath


def module_dotted(rel: str) -> str:
    """Repo-relative path → importable dotted module name."""
    p = rel[:-3] if rel.endswith(".py") else rel
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


_WRAPPERS = _CAPTURE_CALLEES | _UNWRAP_CALLEES


def unwrap_wrapped(node: ast.AST) -> ast.AST:
    """Strip ``vmap``/``partial``/``grad``/graph-capture wrapper calls
    down to the terminal callee expression:
    ``torch.func.vmap(partial(f, a))`` → the ``f`` node. Non-wrapper
    nodes pass through unchanged."""
    while isinstance(node, ast.Call):
        cn = dotted_name(node.func)
        if cn in _WRAPPERS and node.args:
            node = node.args[0]
            continue
        break
    return node


class CallGraph:
    """Name resolution across every module in one lint invocation."""

    def __init__(self, files: list[SourceFile]):
        self.modules: dict[str, ModuleInfo] = {}      # rel -> info
        self.by_dotted: dict[str, ModuleInfo] = {}    # dotted -> info
        self.functions: list[FuncDef] = []
        for sf in files:
            if sf.tree is None or not sf.rel.endswith(".py"):
                continue
            mi = self._index_module(sf)
            self.modules[sf.rel] = mi
            self.by_dotted[mi.dotted] = mi

    # -- indexing ------------------------------------------------------

    def _index_module(self, sf: SourceFile) -> ModuleInfo:
        mi = ModuleInfo(rel=sf.rel, sf=sf, dotted=module_dotted(sf.rel))
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mi.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                if node.module is None or node.level:
                    continue  # relative imports: not used in this repo
                for a in node.names:
                    mi.from_imports[a.asname or a.name] = (
                        node.module, a.name
                    )
        self._index_defs(mi, sf.tree, prefix="", class_name=None)
        # synthetic pseudo-function for module-level statements
        top = FuncDef(rel=sf.rel, qualpath="<module>", node=sf.tree, sf=sf)
        mi.defs["<module>"] = top
        self.functions.append(top)
        # module-level aliases: NAME = torch.func.vmap(fn) / NAME = fn
        for stmt in sf.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                target = unwrap_wrapped(stmt.value)
                tn = dotted_name(target)
                if tn and tn in mi.defs:
                    mi.aliases[stmt.targets[0].id] = tn
        return mi

    def _index_defs(self, mi: ModuleInfo, node: ast.AST, prefix: str,
                    class_name: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qp = f"{prefix}{child.name}"
                fd = FuncDef(rel=mi.rel, qualpath=qp, node=child,
                             sf=mi.sf, class_name=class_name)
                mi.defs[qp] = fd
                self.functions.append(fd)
                if class_name is not None and prefix.count(".") == 1:
                    mi.classes.setdefault(class_name, {})[child.name] = fd
                self._index_defs(mi, child, prefix=f"{qp}.",
                                 class_name=class_name)
            elif isinstance(child, ast.ClassDef):
                mi.classes.setdefault(child.name, {})
                mi.bases[child.name] = [
                    b for b in (dotted_name(x) for x in child.bases) if b
                ]
                self._index_defs(mi, child, prefix=f"{child.name}.",
                                 class_name=child.name)
            else:
                self._index_defs(mi, child, prefix=prefix,
                                 class_name=class_name)

    # -- resolution ----------------------------------------------------

    def canonical(self, mi: ModuleInfo, dotted: str) -> str:
        """Rewrite a dotted name through the module's import tables:
        ``np.random.rand`` → ``numpy.random.rand``, a bare from-import
        → its defining module's dotted path."""
        parts = dotted.split(".")
        root = parts[0]
        if root in mi.from_imports:
            module, attr = mi.from_imports[root]
            return ".".join([module, attr] + parts[1:])
        if root in mi.imports:
            return ".".join([mi.imports[root]] + parts[1:])
        return dotted

    def _lookup_local(self, mi: ModuleInfo, caller: FuncDef,
                      name: str) -> FuncDef | None:
        """Bare-name lookup: nested def of the caller, then module
        scope, then module-level transform/partial aliases."""
        if caller.qualpath != "<module>":
            nested = mi.defs.get(f"{caller.qualpath}.{name}")
            if nested is not None:
                return nested
        fd = mi.defs.get(name)
        if fd is not None:
            return fd
        alias = mi.aliases.get(name)
        if alias is not None:
            return mi.defs.get(alias)
        return None

    def _lookup_method(self, mi: ModuleInfo, class_name: str,
                       method: str, _depth: int = 0) -> FuncDef | None:
        """Method lookup in a class, then single-inheritance walk up
        base classes resolvable within the project."""
        if _depth > 4:
            return None
        methods = mi.classes.get(class_name)
        if methods and method in methods:
            return methods[method]
        for base in mi.bases.get(class_name, []):
            base_mi, base_cls = self._resolve_class(mi, base)
            if base_mi is not None:
                fd = self._lookup_method(base_mi, base_cls, method,
                                         _depth + 1)
                if fd is not None:
                    return fd
        return None

    def _resolve_class(self, mi: ModuleInfo,
                       name: str) -> tuple[ModuleInfo | None, str]:
        parts = name.split(".")
        if len(parts) == 1:
            if parts[0] in mi.classes:
                return mi, parts[0]
            if parts[0] in mi.from_imports:
                module, attr = mi.from_imports[parts[0]]
                target = self.by_dotted.get(module)
                if target is not None and attr in target.classes:
                    return target, attr
        elif len(parts) == 2 and parts[0] in mi.imports:
            target = self.by_dotted.get(mi.imports[parts[0]])
            if target is not None and parts[1] in target.classes:
                return target, parts[1]
        return None, ""

    def resolve_call(
        self, caller: FuncDef, call: ast.Call,
        local_aliases: dict[str, FuncDef] | None = None,
    ) -> tuple[FuncDef | None, str | None]:
        """Resolve a call inside ``caller``.

        Returns ``(funcdef, canonical_name)``: a project-internal
        target when resolution succeeds (vmap/partial/capture wrappers
        unwrapped), plus the import-canonicalised dotted name for
        source/sink matching against external registries. Either half
        may be None.
        """
        mi = self.modules.get(caller.rel)
        if mi is None:
            return None, None
        func = unwrap_wrapped(call.func) if isinstance(
            call.func, ast.Call) else call.func
        name = dotted_name(func)
        if name is None:
            return None, None
        parts = name.split(".")
        root = parts[0]
        canonical = self.canonical(mi, name)

        # local alias bound to a known def (g = vmap(self._f); g(x))
        if local_aliases and len(parts) == 1 and root in local_aliases:
            return local_aliases[root], canonical

        # self.method() (and single-level base classes)
        if root == "self" and caller.class_name and len(parts) == 2:
            fd = self._lookup_method(mi, caller.class_name, parts[1])
            return fd, canonical

        # bare name: nested def / module def / module alias, then a
        # from-imported function defined in another project module
        if len(parts) == 1:
            fd = self._lookup_local(mi, caller, root)
            if fd is None and root in mi.from_imports:
                module, attr = mi.from_imports[root]
                target = self.by_dotted.get(module)
                if target is not None:
                    fd = target.defs.get(attr)
            return fd, canonical

        # imported-module attribute: inject.fire(...) / io.save_json_atomic
        if root in mi.imports:
            target = self.by_dotted.get(mi.imports[root])
            if target is not None:
                return target.defs.get(".".join(parts[1:])), canonical
        # from-imported name with attribute tail: Klass.method / mod.fn
        if root in mi.from_imports:
            module, attr = mi.from_imports[root]
            target = self.by_dotted.get(module)
            if target is not None:
                return (
                    target.defs.get(".".join([attr] + parts[1:])),
                    canonical,
                )
            # ``from pkg import module`` style: pkg.module may itself
            # be a project module
            target = self.by_dotted.get(f"{module}.{attr}")
            if target is not None:
                return target.defs.get(".".join(parts[1:])), canonical
        return None, canonical

    def resolve_value(
        self, caller: FuncDef, node: ast.AST,
    ) -> FuncDef | None:
        """Resolve a non-call expression that names a function — the
        alias-building half (``g = vmap(self._f)`` needs ``_f``)."""
        mi = self.modules.get(caller.rel)
        if mi is None:
            return None
        node = unwrap_wrapped(node)
        name = dotted_name(node)
        if name is None:
            return None
        parts = name.split(".")
        if parts[0] == "self" and caller.class_name and len(parts) == 2:
            return self._lookup_method(mi, caller.class_name, parts[1])
        if len(parts) == 1:
            fd = self._lookup_local(mi, caller, parts[0])
            if fd is None and parts[0] in mi.from_imports:
                module, attr = mi.from_imports[parts[0]]
                target = self.by_dotted.get(module)
                if target is not None:
                    fd = target.defs.get(attr)
            return fd
        if parts[0] in mi.imports:
            target = self.by_dotted.get(mi.imports[parts[0]])
            if target is not None:
                return target.defs.get(".".join(parts[1:]))
        if parts[0] in mi.from_imports:
            module, attr = mi.from_imports[parts[0]]
            target = self.by_dotted.get(module)
            if target is not None:
                return target.defs.get(".".join([attr] + parts[1:]))
        return None
