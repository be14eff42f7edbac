"""FIA201/202/203/204/205 — capture and dispatch hygiene.

The port's counterpart of the reference's trace-hygiene family. In the
reference the traced scope is a ``jax.jit`` program; in the port it is a
program captured as a CUDA graph: the engine's flat programs (the
closures ``InfluenceEngine._flat_prelude`` and ``_flat_fn`` return, run
under ``_FlatGraph``) and the kernel wrappers they reach, plus anything
recorded under ``torch.cuda.graph`` or ``make_graphed_callables``
(:class:`fia_tpu_torch.analysis.visitor.CaptureIndex`). A capture runs
the Python once and records the device work; every replay repeats that
work on the same addresses and runs no Python. The three ways that
silently breaks are visible in the AST of a captured function:

- **FIA201 host sync** — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``.to("cpu")``, ``float()``/``int()``/``bool()`` of a
  tensor, ``torch.cuda.synchronize``, host ``np.*`` on a tensor, or a
  tensor made from host data (``torch.tensor`` / ``torch.as_tensor`` /
  ``torch.from_numpy``) inside a capture: a host wait or a host copy that
  is illegal while a stream captures, or that runs at capture only, so
  every replay reuses the value read then. ``print`` runs at capture
  only.
- **FIA202 tensor branch** — a Python ``if``/``while`` on a tensor
  value reads it on the host (a sync), and the branch taken during
  capture is the one every replay runs; ``torch.where`` keeps both.
- **FIA203 replaced capture** — a tensor a captured closure (or a
  ``with torch.cuda.graph`` block) reads from the enclosing scope and
  that the scope later rebinds: the graph keeps the old tensor's
  address, so replays read the stale tensor while eager code reads the
  new one. Update a captured tensor in place (``x.copy_(new)``).

Traced and static values: every tensor-valued name is traced —
parameters (less the registered static positions), the results of torch
calls, and anything derived from a traced value. Host values fixed at
capture time are static: ``.shape``/``.size()``/``.numel()``/
``.dtype``/``.device``/``.data_ptr()`` and the like of any tensor,
geometry ints derived from them, and the ``int`` return codes of the
ctypes kernel entries (whose arguments are all static). A Python branch
on a static value is fine: it is fixed for the captured geometry.

FIA204 and FIA205 police the *host-side* dispatch path (the registered
functions that pack a batch and launch one fused device program), where
the hazards are per-query host→device transfers (204) and placement
outside the mesh helpers, which lands a batch-axis array on one device
under a mesh (205).

Detection is necessarily heuristic (no type inference); a false
positive is suppressed inline with a justification, which doubles as
documentation of *why* the flagged line is safe.
"""

from __future__ import annotations

import ast

from fia_tpu_torch.analysis import config
from fia_tpu_torch.analysis.core import FileRule, Finding, SourceFile, register
from fia_tpu_torch.analysis.visitor import (
    call_name,
    const_str,
    dotted_name,
    iter_capture_blocks,
    iter_captured_defs,
)

_HOST_MODULES = ("np", "numpy", "onp")

# attributes of a tensor that are host values fixed at capture
_STATIC_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "layout", "is_sparse",
    "requires_grad", "itemsize", "nbytes", "type", "index",
})
# tensor methods whose result is a host value fixed at capture
_STATIC_METHODS = frozenset({
    "size", "numel", "nelement", "dim", "ndimension", "data_ptr",
    "is_contiguous", "stride", "element_size", "get_device",
    "storage_offset", "is_floating_point", "is_complex",
})
# builtins whose result is a host value whatever they are given (the
# conversions among them are FIA201's business when given a tensor)
_HOST_BUILTINS = frozenset({
    "len", "isinstance", "hasattr", "callable", "type", "range", "id",
    "int", "float", "bool", "str", "repr", "getattr",
})
# torch entry points that return host objects, not tensors
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch.testing.")
_TORCH_HOST_CALLS = frozenset({
    "torch.device", "torch.finfo", "torch.iinfo", "torch.is_tensor",
    "torch.get_default_dtype", "torch.Size", "torch.Generator",
    "torch.is_grad_enabled", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.is_floating_point", "torch.numel",
})
# tensors made from host data: a host→device copy when given a device
_HOST_DATA_CALLS = frozenset({
    "torch.tensor", "torch.as_tensor", "torch.from_numpy",
})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_DTYPE_NAMES = frozenset({
    "float", "float16", "float32", "float64", "half", "double", "bfloat16",
    "int", "int8", "int16", "int32", "int64", "long", "short", "uint8",
    "bool", "complex64", "complex128", "cfloat", "cdouble",
})


def _is_torch_tensor_call(cn: str | None) -> bool:
    """A call into torch that returns a tensor (any torch function but
    the host-object ones)."""
    if cn is None or not cn.startswith("torch."):
        return False
    return (cn not in _TORCH_HOST_CALLS
            and not cn.startswith(_TORCH_HOST_PREFIXES))


def _is_none_check(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` — an optional-argument idiom,
    never a device read."""
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
    )


def _target_names(tgt: ast.AST) -> list[str]:
    return [n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)]


class _CaptureScope:
    """Dataflow over one captured def: which local names hold tensors."""

    def __init__(self, traced: set[str]):
        self.traced: set[str] = set(traced)

    def expr_is_traced(self, node: ast.AST) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.traced
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr_is_traced(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and (
                func.attr in _STATIC_METHODS
            ):
                return False
            cn = call_name(node)
            if cn in _HOST_BUILTINS:
                return False
            if cn is not None and cn.startswith("torch."):
                return _is_torch_tensor_call(cn)
            args = list(node.args) + [kw.value for kw in node.keywords]
            if any(self.expr_is_traced(a) for a in args):
                return True
            # a method of a tensor returns a tensor
            return isinstance(func, ast.Attribute) and self.expr_is_traced(
                func.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            saved = set(self.traced)
            try:
                for gen in node.generators:
                    names = _target_names(gen.target)
                    if self.expr_is_traced(gen.iter):
                        self.traced.update(names)
                    else:
                        self.traced.difference_update(names)
                if isinstance(node, ast.DictComp):
                    return (self.expr_is_traced(node.key)
                            or self.expr_is_traced(node.value))
                return self.expr_is_traced(node.elt)
            finally:
                self.traced = saved
        if isinstance(node, (ast.Lambda, ast.Constant)):
            return False
        return any(self.expr_is_traced(c) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    def traced_names_in(self, node: ast.AST) -> list[str]:
        return sorted({n.id for n in ast.walk(node)
                       if isinstance(n, ast.Name) and n.id in self.traced})

    def bind(self, tgt: ast.AST, traced: bool) -> None:
        for name in _target_names(tgt):
            if traced:
                self.traced.add(name)
            else:
                self.traced.discard(name)

    def note(self, node: ast.AST) -> None:
        """Update the traced set for a binding statement."""
        if isinstance(node, ast.Assign):
            value = node.value
            for tgt in node.targets:
                if (isinstance(tgt, (ast.Tuple, ast.List))
                        and isinstance(value, (ast.Tuple, ast.List))
                        and len(tgt.elts) == len(value.elts)
                        and not any(isinstance(e, ast.Starred)
                                    for e in tgt.elts + value.elts)):
                    for t, v in zip(tgt.elts, value.elts):
                        self.bind(t, self.expr_is_traced(v))
                else:
                    self.bind(tgt, self.expr_is_traced(value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self.bind(node.target, self.expr_is_traced(node.value))
        elif isinstance(node, ast.AugAssign) and isinstance(
            node.target, ast.Name
        ):
            if self.expr_is_traced(node.value):
                self.traced.add(node.target.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self.bind(node.target, self.expr_is_traced(node.iter))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    self.bind(item.optional_vars,
                              self.expr_is_traced(item.context_expr))
        elif isinstance(node, ast.NamedExpr):
            self.bind(node.target, self.expr_is_traced(node.value))


def _walk_in_order(stmts):
    """Source-order walk of statements, skipping nested defs and lambdas
    (a nested def gets its own scope)."""
    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            yield child
            yield from rec(child)
    for stmt in stmts:
        yield stmt
        yield from rec(stmt)


def _tensor_bindings(fn: ast.AST) -> set[str]:
    """Names a function binds to tensors (torch calls, and values derived
    from them) in its own body."""
    scope = _CaptureScope(set())
    body = fn.body if hasattr(fn, "body") else []
    for node in _walk_in_order(body):
        scope.note(node)
    return scope.traced


def _scopes(sf: SourceFile):
    """``(statements, traced, anchor_name)`` for every captured def and
    every capture block of the file. A block's tensors are its enclosing
    function's parameters and tensor bindings."""
    for fn, traced, _ in iter_captured_defs(sf):
        yield fn.body, traced, fn.name
    for block, enclosing in iter_capture_blocks(sf):
        traced: set[str] = set()
        if enclosing is not None:
            traced = _tensor_bindings(enclosing)
            a = enclosing.args
            traced |= {p.arg for p in list(a.posonlyargs) + list(a.args)
                       + list(a.kwonlyargs) if p.arg != "self"}
        yield block.body, traced, "<capture block>"


def _is_cpu_target(node: ast.AST) -> bool:
    s = const_str(node)
    if s is not None:
        return s == "cpu" or s.startswith("cpu:")
    if isinstance(node, ast.Call) and call_name(node) == "torch.device":
        return bool(node.args) and _is_cpu_target(node.args[0])
    return False


@register
class HostSyncRule(FileRule):
    """Host syncs and host copies inside programs captured as CUDA graphs."""

    id = "FIA201"
    name = "host-sync-in-capture"

    def check(self, sf: SourceFile):
        findings: list[Finding] = []
        for body, traced, _ in _scopes(sf):
            scope = _CaptureScope(traced)
            for node in _walk_in_order(body):
                scope.note(node)
                if not isinstance(node, ast.Call):
                    continue
                msg = self._hazard(node, scope)
                if msg:
                    findings.append(Finding(
                        self.id, sf.rel, node.lineno, node.col_offset, msg
                    ))
        return findings

    @staticmethod
    def _hazard(node: ast.Call, scope: _CaptureScope) -> str | None:
        cn = call_name(node)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if cn == "print":
            return ("print() inside a captured program runs at capture "
                    "only, never on a replay")
        if cn in ("float", "int", "bool") and node.args and (
            scope.expr_is_traced(node.args[0])
        ):
            return (f"{cn}() of a tensor inside a captured program reads "
                    "it on the host (a sync while the stream captures; "
                    "replays reuse the value read then)")
        if cn and cn.split(".", 1)[0] in _HOST_MODULES and any(
            scope.expr_is_traced(a)
            for a in list(node.args) + [kw.value for kw in node.keywords]
        ):
            return (f"host numpy call {cn}() on a tensor inside a captured "
                    "program (copies it to the host; use torch)")
        if cn == "torch.cuda.synchronize" or (
            attr == "synchronize" and not node.args
        ):
            return ("a synchronize inside a captured program (a host wait "
                    "is illegal while a stream captures)")
        if cn in _HOST_DATA_CALLS and node.args and not (
            scope.expr_is_traced(node.args[0])
        ):
            return (f"{cn}() of host data inside a captured program: the "
                    "host copy runs at capture only and every replay "
                    "reads its bytes (make the tensor outside the capture "
                    "and copy into a captured input)")
        if attr in _SYNC_METHODS and not node.args:
            return (f".{attr}() inside a captured program forces a host "
                    "sync")
        if attr == "to" and (
            (node.args and _is_cpu_target(node.args[0]))
            or any(kw.arg == "device" and _is_cpu_target(kw.value)
                   for kw in node.keywords)
        ):
            return (".to('cpu') inside a captured program forces a host "
                    "sync")
        return None


@register
class TracedBranchRule(FileRule):
    """Python control flow on tensor values inside captured programs."""

    id = "FIA202"
    name = "tensor-branch-in-capture"

    def check(self, sf: SourceFile):
        findings: list[Finding] = []
        for body, traced, _ in _scopes(sf):
            scope = _CaptureScope(traced)
            for node in _walk_in_order(body):
                scope.note(node)
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                test = node.test
                if _is_none_check(test) or not scope.expr_is_traced(test):
                    continue
                hits = scope.traced_names_in(test)
                what = (f"tensor value(s) {', '.join(hits)}" if hits
                        else "a tensor expression")
                kw = "while" if isinstance(node, ast.While) else "if"
                findings.append(Finding(
                    self.id, sf.rel, node.lineno, node.col_offset,
                    f"Python `{kw}` on {what} inside a captured program "
                    "(reads it on the host, and the branch taken at "
                    "capture is the one every replay runs; use "
                    "torch.where)",
                ))
        return findings


def _rebinds_after(enclosing: ast.AST, name: str, line: int) -> int | None:
    """The first line after ``line`` where ``enclosing``'s own body
    rebinds ``name`` by assignment (an in-place update is not a
    rebinding)."""
    best = None
    for node in _walk_in_order(getattr(enclosing, "body", [])):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and (
            node.lineno > line
        ):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if name in [n.id for n in ast.walk(tgt)
                            if isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Store)]:
                    if best is None or node.lineno < best:
                        best = node.lineno
    return best


def _free_loads(nodes, local: set[str]) -> list[ast.Name]:
    out = []
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id not in local:
                out.append(sub)
    return out


@register
class ClosureCaptureRule(FileRule):
    """Tensors a capture reads from its enclosing scope must not be
    replaced after the capture."""

    id = "FIA203"
    name = "replaced-capture-tensor"

    def check(self, sf: SourceFile):
        findings: list[Finding] = []
        for fn, traced, enclosing in iter_captured_defs(sf):
            if enclosing is None:
                continue
            local = set(traced) | {"self"}
            a = fn.args
            local |= {p.arg for p in list(a.posonlyargs) + list(a.args)
                      + list(a.kwonlyargs)}
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Store
                ):
                    local.add(node.id)
            end = getattr(fn, "end_lineno", fn.lineno)
            self._flag(findings, sf, fn, enclosing,
                       _free_loads([fn], local), end,
                       f"captured closure {fn.name!r}")
        for block, enclosing in iter_capture_blocks(sf):
            if enclosing is None:
                continue
            end = getattr(block, "end_lineno", block.lineno)
            self._flag(findings, sf, block, enclosing,
                       _free_loads(block.body, set()), end,
                       "the `with torch.cuda.graph` block")
        return findings

    def _flag(self, findings, sf, anchor, enclosing, loads, end,
              what) -> None:
        tensors = _tensor_bindings(enclosing)
        flagged: dict[str, int] = {}
        for n in loads:
            if n.id in tensors and n.id not in flagged:
                line = _rebinds_after(enclosing, n.id, end)
                if line is not None:
                    flagged[n.id] = line
        if flagged:
            # one finding per capture, anchored at its def / with line,
            # so one justified suppression covers the whole set
            names = ", ".join(f"{k} (line {v})"
                              for k, v in sorted(flagged.items()))
            findings.append(Finding(
                self.id, sf.rel, anchor.lineno, anchor.col_offset,
                f"{what} reads tensor(s) of the enclosing scope that are "
                f"rebound after it: {names} — a CUDA graph keeps the old "
                "tensor's address, so replays read the stale tensor; copy "
                "into it (x.copy_(new)) instead of rebinding",
            ))


def _body_calls(fn: ast.FunctionDef):
    """Calls lexically inside ``fn``, skipping nested defs/lambdas (the
    same deferred-code carve-out as :func:`_loop_body_calls`)."""
    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from rec(child)
    yield from rec(fn)


def _loop_body_calls(fn: ast.FunctionDef):
    """Calls lexically inside a loop body of ``fn``, skipping nested
    defs/lambdas: a closure built in a loop is deferred code (the
    serving path stores retry thunks that way), not a per-iteration
    transfer, so flagging it would punish the escape hatch the rule
    wants to preserve."""
    def rec(node, in_loop):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            inner = in_loop or isinstance(child, (ast.For, ast.While))
            if in_loop and isinstance(child, ast.Call):
                yield child
            yield from rec(child, inner)
    yield from rec(fn, False)


def _host_bindings(fn: ast.FunctionDef) -> set[str]:
    """Names ``fn`` binds to host data: numpy results, ``.numpy()`` /
    ``.cpu()`` / ``.tolist()`` results, literal lists and tuples, and
    names derived from them."""
    out: set[str] = set()
    for node in _walk_in_order(fn.body):
        if isinstance(node, ast.Assign) and _is_host_expr(node.value, out):
            for tgt in node.targets:
                out.update(_target_names(tgt))
    return out


def _is_host_expr(node: ast.AST, host: set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return True
    if isinstance(node, ast.Call):
        cn = call_name(node)
        if cn and cn.split(".", 1)[0] in _HOST_MODULES:
            return True
        if cn == "torch.from_numpy":
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in ("numpy", "cpu", "tolist"):
                return True
            if node.func.attr in ("reshape", "astype", "copy", "ravel",
                                  "contiguous", "view"):
                return _is_host_expr(node.func.value, host)
    if isinstance(node, ast.Subscript):
        return _is_host_expr(node.value, host)
    return False


def _moves_to_device(call: ast.Call) -> bool:
    """``.to(<device>)`` or ``.cuda()``: a placement, not a dtype cast."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    if any(kw.arg == "device" for kw in call.keywords):
        return not _is_cpu_target(next(kw.value for kw in call.keywords
                                       if kw.arg == "device"))
    if not call.args:
        return False
    first = call.args[0]
    if _is_cpu_target(first):
        return False
    name = dotted_name(first)
    if name is not None:
        last = name.split(".")[-1]
        if last in _DTYPE_NAMES or "dtype" in last.lower():
            return False
    return True


def _host_upload(call: ast.Call, host: set[str]) -> bool:
    """``x.to(<device>)`` / ``x.cuda()`` of host data."""
    return _moves_to_device(call) and _is_host_expr(call.func.value, host)


def _registered(sf: SourceFile) -> set[str]:
    return {name for path, name in config.DISPATCH_PATH_FUNCTIONS
            if sf.rel.endswith(path)}


@register
class DispatchTransferRule(FileRule):
    """Per-query host transfers inside registered dispatch-path loops."""

    id = "FIA204"
    name = "per-query-transfer-in-dispatch"

    def check(self, sf: SourceFile):
        wanted = _registered(sf)
        if not wanted:
            return []
        findings: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.FunctionDef)
                    and node.name in wanted):
                continue
            host = _host_bindings(node)
            for call in _loop_body_calls(node):
                cn = call_name(call)
                if cn in config.DISPATCH_TRANSFER_CALLS:
                    what = f"{cn}()"
                elif _host_upload(call, host):
                    what = f".{call.func.attr}() of host data"
                else:
                    continue
                findings.append(Finding(
                    self.id, sf.rel, call.lineno, call.col_offset,
                    f"host→device transfer {what} inside a loop in "
                    f"dispatch-path function {node.name!r} — the fused "
                    "mega-batch contract is one transfer per dispatch, "
                    "never per query; hoist it above the loop or pack the "
                    "batch first",
                ))
        return findings


@register
class UnshardedTransferRule(FileRule):
    """Placement outside the mesh helpers on the registered dispatch path."""

    id = "FIA205"
    name = "unsharded-transfer-in-dispatch"

    def check(self, sf: SourceFile):
        wanted = _registered(sf)
        if not wanted:
            return []
        findings: list[Finding] = []
        helpers = "/".join(sorted(config.MESH_PLACEMENT_HELPERS))
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.FunctionDef)
                    and node.name in wanted):
                continue
            host = _host_bindings(node)
            for call in _body_calls(node):
                cn = call_name(call)
                if cn in config.UNSHARDED_TRANSFER_CALLS:
                    placed = len(call.args) >= 3 or any(
                        kw.arg == "device" for kw in call.keywords)
                    if not placed:
                        continue
                    what = f"{cn}(..., device=)"
                elif _host_upload(call, host):
                    what = f".{call.func.attr}() of host data"
                else:
                    continue
                findings.append(Finding(
                    self.id, sf.rel, call.lineno, call.col_offset,
                    f"un-sharded placement {what} in dispatch-path "
                    f"function {node.name!r} lands the whole batch on one "
                    "device — under a mesh this serializes every shard "
                    "through it; route placement through "
                    f"fia_tpu_torch/parallel ({helpers})",
                ))
        return findings
