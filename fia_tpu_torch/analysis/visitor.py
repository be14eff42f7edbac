"""Visitor framework and shared AST helpers for fialint rules.

Rules subclass :class:`RuleVisitor` (an ``ast.NodeVisitor`` carrying
the :class:`~fia_tpu_torch.analysis.core.SourceFile` and a findings
sink) or use the free helpers directly. The capture-scope machinery (the
port's counterpart of the reference's jit scopes: programs recorded as
CUDA graphs) lives here too because three capture-hygiene rules share
it.
"""

from __future__ import annotations

import ast

from fia_tpu_torch.analysis.core import Finding, SourceFile


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's callee, else None (lambdas, subscripts)."""
    return dotted_name(node.func)


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def literal_or_none(node: ast.AST):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


class RuleVisitor(ast.NodeVisitor):
    """NodeVisitor with the source file and a findings sink attached."""

    def __init__(self, rule_id: str, sf: SourceFile):
        self.rule_id = rule_id
        self.sf = sf
        self.findings: list[Finding] = []

    def flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            self.rule_id, self.sf.rel,
            getattr(node, "lineno", 1), getattr(node, "col_offset", 0),
            message,
        ))

    def run(self) -> list[Finding]:
        if self.sf.tree is not None:
            self.visit(self.sf.tree)
        return self.findings


# ---------------------------------------------------------------------
# capture-scope detection (shared by the FIA2xx capture-hygiene rules)
# ---------------------------------------------------------------------

# calls whose first positional argument is a function captured as a CUDA
# graph (make_graphed_callables records it on sample inputs)
_CAPTURE_CALLEES = {
    "torch.cuda.make_graphed_callables", "make_graphed_callables",
}
# wrappers whose first positional argument is (eventually) the function
# that runs: torch's function transforms and partial application
_UNWRAP_CALLEES = {
    "torch.func.vmap", "torch.vmap", "vmap", "partial", "functools.partial",
    "torch.func.grad", "grad", "torch.func.grad_and_value",
    "grad_and_value", "torch.func.jacrev", "jacrev", "torch.func.jacfwd",
    "jacfwd", "torch.func.hessian", "torch.utils.checkpoint.checkpoint",
}


def _terminal_fn_name(node: ast.AST) -> str | None:
    """Unwrap ``vmap(partial(self._f, ...))`` chains to the innermost
    function's bare name (``_f``)."""
    while isinstance(node, ast.Call):
        cn = call_name(node)
        if cn in _UNWRAP_CALLEES and node.args:
            node = node.args[0]
            continue
        return None
    name = dotted_name(node)
    if name is None:
        return None
    return name.split(".")[-1]


def is_capture_context(item: ast.withitem) -> bool:
    """A ``with`` item that records the block as a CUDA graph
    (``torch.cuda.graph(g)``, or a registered wrapper of it)."""
    from fia_tpu_torch.analysis import config

    expr = item.context_expr
    return isinstance(expr, ast.Call) and (
        call_name(expr) in config.CAPTURE_CONTEXT_CALLS
    )


def _qualified_defs(tree: ast.AST):
    """``(qualpath, def)`` for every function def, classes and enclosing
    defs joined by dots (``Engine._flat_fn.fn``)."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qp = f"{prefix}{child.name}"
                yield qp, child
                yield from walk(child, qp + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


class CaptureIndex:
    """Which function defs in a module run inside a CUDA-graph capture,
    and which of their parameters are host values fixed at capture time.

    Detected, in one AST pass over the module:

    - defs whose name is passed (possibly through ``vmap`` / ``partial``
      wrappers) into ``torch.cuda.make_graphed_callables(...)``;
    - defs called by name (or as ``self.<name>``) lexically inside a
      ``with torch.cuda.graph(...)`` block (or a registered wrapper of
      it, ``config.CAPTURE_CONTEXT_CALLS``);
    - the qualified names registered in
      ``config.REGISTERED_CAPTURE_ENTRY_POINTS`` for this file — programs
      reached through indirection the AST cannot see (a closure returned
      by a factory method and handed to the engine's graph wrapper as a
      value).

    Every parameter of a captured def but ``self`` and the registered
    static positions is a tensor; nested defs of a captured def run in
    the same capture, every parameter a tensor.
    """

    def __init__(self, sf: SourceFile):
        from fia_tpu_torch.analysis import config

        self.statics: dict[str, tuple[int, ...]] = {}   # qualpath -> statics
        self.names: set[str] = set()                    # bare names
        self.blocks: list[tuple[ast.With, ast.AST | None]] = []
        if sf.tree is None:
            return
        registered = [
            (entry[1], tuple(entry[2]) if len(entry) > 2 else ())
            for entry in config.REGISTERED_CAPTURE_ENTRY_POINTS
            if sf.rel.endswith(entry[0])
        ]
        defs = list(_qualified_defs(sf.tree))
        for qp, fn in defs:
            for name, statics in registered:
                if qp == name or qp.endswith("." + name):
                    self.statics[qp] = statics
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and (
                call_name(node) in _CAPTURE_CALLEES and node.args
            ):
                fn = _terminal_fn_name(node.args[0])
                if fn:
                    self.names.add(fn)
        for qp, fn in [("", sf.tree)] + defs:
            for node in _own_nodes(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    is_capture_context(it) for it in node.items
                ):
                    self.blocks.append((node, None if qp == "" else fn))
                    local = bound_names(fn)
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Call):
                            name = dotted_name(sub.func)
                            if name is None:
                                continue
                            if name.count(".") == 0 and name not in local:
                                self.names.add(name)
                            elif (name.startswith("self.")
                                  and name.count(".") == 1):
                                self.names.add(name.split(".")[-1])

    def is_captured(self, qualpath: str, fn: ast.AST) -> bool:
        return qualpath in self.statics or fn.name in self.names

    def traced_params(self, qualpath: str,
                      fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
        """Parameter names that hold tensors during the capture:
        positional/kw params minus ``self`` and the registered static
        positions. Vararg packs are tensors (``fn(*a)`` receives the
        program's inputs)."""
        statics = set(self.statics.get(qualpath, ()))
        params = list(fn.args.posonlyargs) + list(fn.args.args)
        traced: set[str] = set()
        for i, a in enumerate(params):
            if i in statics or a.arg == "self":
                continue
            traced.add(a.arg)
        for a in fn.args.kwonlyargs:
            traced.add(a.arg)
        if fn.args.vararg:
            traced.add(fn.args.vararg.arg)
        return traced


def bound_names(fn: ast.AST) -> set[str]:
    """Parameters and names assigned in ``fn``'s own body: a call of one
    of them calls a value, not a def of the module."""
    out: set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn.args
        for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            out.add(p.arg)
        for p in (a.vararg, a.kwarg):
            if p is not None:
                out.add(p.arg)
    for node in _own_nodes(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _own_nodes(fn: ast.AST):
    """Nodes of ``fn``'s own body, not descending into nested defs,
    classes or lambdas."""
    body = fn.body if hasattr(fn, "body") else []
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                stack.append(child)


def iter_captured_defs(sf: SourceFile):
    """Yield ``(funcdef, traced_params, enclosing_funcdef_or_None)`` for
    every def that runs inside a capture: the detected and registered
    ones, and the defs nested in them."""
    idx = CaptureIndex(sf)
    if sf.tree is None or not (idx.statics or idx.names):
        return

    def walk(node, prefix, enclosing, inside):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qp = f"{prefix}{child.name}"
                captured = inside or idx.is_captured(qp, child)
                if captured:
                    params = (idx.traced_params(qp, child) if not inside
                              else idx.traced_params("", child))
                    yield child, params, enclosing
                yield from walk(child, qp + ".", child, captured)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", enclosing,
                                inside)
            else:
                yield from walk(child, prefix, enclosing, inside)

    yield from walk(sf.tree, "", None, False)


def iter_capture_blocks(sf: SourceFile):
    """Yield ``(with_node, enclosing_funcdef_or_None)`` for every
    ``with torch.cuda.graph(...)`` block of the file: statements recorded
    into a graph where they stand."""
    yield from CaptureIndex(sf).blocks
